"""Multi-device sharding tests on the 8-device virtual CPU mesh:
sharded runs must be numerically identical to unsharded, and the streaming
pipeline must reproduce the monolithic result."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.parallel.sharding import (
    column_sharding,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_columns,
)
from rte_rrtmgp_nn_tpu.parallel.streaming import iter_blocks, stream_reduce

from test_lut_gas_optics import GASES, make_atmosphere


@pytest.fixture(scope="module")
def lw_kd(tmp_path_factory):
    from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc

    p = str(tmp_path_factory.mktemp("kd") / "lw.nc")
    generate_kdist_nc(p, kind="lw", gpts_per_band=4, nband=16)
    return load_kdist(p, GASES)


class TestMesh:
    def test_mesh_shapes(self):
        assert len(jax.devices()) >= 8
        m1 = make_mesh()
        assert m1.devices.shape == (8, 1)
        m2 = make_mesh(n_col=4, n_gpt=2)
        assert m2.devices.shape == (4, 2)
        with pytest.raises(ValueError):
            make_mesh(n_col=16, n_gpt=1)

    def test_pad_to_multiple(self):
        arrs = [np.ones((10, 3)), np.ones((10,))]
        padded, n = pad_to_multiple(arrs, 8)
        assert n == 10 and padded[0].shape == (16, 3) and padded[1].shape == (16,)


class TestShardedEquivalence:
    def test_lw_lut_sharded_equals_unsharded(self, lw_kd):
        """The full LUT LW pipeline under an 8-way column sharding produces
        the same fluxes as single-device execution."""
        from rte_rrtmgp_nn_tpu.gasoptics.lut_gas_optics import gas_optics_lw_lut
        from rte_rrtmgp_nn_tpu.rte import rte_lw

        play, plev, tlay, tlev, tsfc, gc = make_atmosphere(ncol=16, nlay=12, dtype=jnp.float32)
        emis = jnp.full((16, lw_kd.nband), 0.97, jnp.float32)

        def fn(play, plev, tlay, tlev, tsfc, emis, concs):
            from rte_rrtmgp_nn_tpu.gas_concs import GasConcs

            props, sources = gas_optics_lw_lut(
                lw_kd, play, plev, tlay, tsfc, GasConcs(concs), tlev=tlev
            )
            sol = rte_lw(props, True, sources, emis, broadband=True)
            return sol.flux_up, sol.flux_dn

        concs = {k: jnp.asarray(v, jnp.float32) for k, v in gc.concs.items()}
        args = (play, plev, tlay, tlev, tsfc, emis, concs)
        up_ref, dn_ref = jax.jit(fn)(*args)

        mesh = make_mesh()
        sharded_args = shard_columns(args, mesh)
        up_sh, dn_sh = jax.jit(fn)(*sharded_args)
        np.testing.assert_allclose(np.asarray(up_sh), np.asarray(up_ref), rtol=2e-6)
        np.testing.assert_allclose(np.asarray(dn_sh), np.asarray(dn_ref), rtol=2e-6)

    def test_gpt_axis_sharding(self, lw_kd):
        """Sharding the spectral axis (tensor-parallel style) also matches."""
        from rte_rrtmgp_nn_tpu.ops.lw_solver import lw_solver_noscat

        rng = np.random.default_rng(0)
        ncol, nlay, ngpt = 8, 10, 64
        tau = jnp.asarray(rng.uniform(0.05, 1.0, (ncol, nlay, ngpt)), jnp.float32)
        lay = jnp.asarray(rng.uniform(0.5, 1.0, (ncol, nlay, ngpt)), jnp.float32)
        lev = jnp.asarray(rng.uniform(0.5, 1.0, (ncol, nlay + 1, ngpt)), jnp.float32)
        emis = jnp.ones((ncol, ngpt), jnp.float32)
        sfc = jnp.ones((ncol, ngpt), jnp.float32)

        fn = jax.jit(functools.partial(lw_solver_noscat, broadband=True))
        ref = fn(tau, lay, lev, emis, sfc)

        mesh = make_mesh(n_col=4, n_gpt=2)
        put3 = lambda x: jax.device_put(x, column_sharding(mesh, 3, gpt_axis=2))
        put2 = lambda x: jax.device_put(x, column_sharding(mesh, 2, gpt_axis=1))
        sh = fn(put3(tau), put3(lay), put3(lev), put2(emis), put2(sfc))
        np.testing.assert_allclose(np.asarray(sh.flux_up), np.asarray(ref.flux_up), rtol=2e-6)


class TestStreaming:
    def test_iter_blocks(self):
        assert list(iter_blocks(10, 4)) == [(0, 4), (4, 4), (8, 2)]

    def test_stream_reduce_matches_monolithic(self):
        rng = np.random.default_rng(1)
        a = rng.uniform(0, 1, (37, 5)).astype(np.float32)
        b = rng.uniform(0, 1, (37,)).astype(np.float32)

        fn = jax.jit(lambda a, b: (a.sum(-1) + b, a * 2.0))
        outs = stream_reduce(
            fn, [a, b], block_size=8,
            out_builder=lambda n: [np.zeros(n, np.float32), np.zeros((n, 5), np.float32)],
        )
        ref0, ref1 = fn(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(outs[0], np.asarray(ref0), rtol=1e-6)
        np.testing.assert_allclose(outs[1], np.asarray(ref1), rtol=1e-6)


class TestGCMSweep:
    def test_allsky_sweep_small(self):
        """The streamed all-sky LW+SW GCM sweep (capstone config) on a
        small seeded column set: physical outputs, correct block stitching."""
        from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
        from rte_rrtmgp_nn_tpu.drivers.gcm import gcm_host_columns, gcm_sweep_allsky

        base = si.make_gcm_block(seed=0, ncol=700)  # not a block multiple
        host = gcm_host_columns(base)
        lw, sw = si.load_models(seed=0)
        clw = si.make_cloud_optics(seed=0, kind="lw")
        csw = si.make_cloud_optics(seed=0, kind="sw")
        stats = gcm_sweep_allsky(host, lw, sw, clw, csw, block_size=256, top_at_1=base.top_at_1)
        assert stats["ncol"] == 700
        assert 100 < stats["mean_olr"] < 320  # cloudy-sky OLR
        assert 150 < stats["mean_lw_sfc_dn"] < 450
        assert 0 < stats["mean_sw_sfc_dn"] < 1000
        assert stats["columns_per_s"] > 0
        # device-resident mode runs the SAME jitted step over pre-staged
        # blocks -- identical fluxes to the streamed path
        res = gcm_sweep_allsky(host, lw, sw, clw, csw, block_size=256,
                               top_at_1=base.top_at_1, resident=True)
        assert res["mean_olr"] == stats["mean_olr"]
        assert res["mean_lw_sfc_dn"] == stats["mean_lw_sfc_dn"]
        assert res["mean_sw_sfc_dn"] == stats["mean_sw_sfc_dn"]


class TestStagedCoreSharding:
    """The staged LW/SW cores under shard_map over 'col' on 4 of the 8
    virtual CPU devices equal the unsharded cores (the 4-card path of
    chip_smoke.py --four-cards)."""

    @pytest.fixture(scope="class")
    def setup(self):
        from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si

        data = si.make_rfmip(seed=4, nsites=2)  # 36 columns
        lw, sw = si.load_models(seed=0)
        mesh = make_mesh(n_col=4, n_gpt=1, devices=jax.devices()[:4])
        concs = {k: jnp.asarray(v, jnp.float32)
                 for k, v in data.gas_concs.concs.items()}
        return data, lw, sw, mesh, concs

    def test_lw_shard_map_matches_unsharded(self, setup):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import (
            _lw_core_lay_major_jit,
            lw_core_sharded,
        )
        from rte_rrtmgp_nn_tpu.gasoptics.planck import (
            PlanckTable,
            lw_spectral_g128,
        )

        data, lw, _, mesh, concs = setup
        spec = lw_spectral_g128()
        table = PlanckTable.compute(spec.band_lims_wvn_array, dtype=jnp.float32)
        f32 = lambda a: jnp.asarray(a, jnp.float32)
        emis = jnp.broadcast_to(f32(data.sfc_emis)[:, None],
                                (data.ncol, spec.nband))
        args = (f32(data.play), f32(data.plev), f32(data.tlay),
                f32(data.tlev), f32(data.tsfc), emis, concs)
        ref = _lw_core_lay_major_jit(lw, table, spec, *args,
                                     top_at_1=data.top_at_1)
        up, dn = jax.jit(lw_core_sharded(mesh, lw, table, spec,
                                         data.top_at_1))(
            *shard_columns(args, mesh))
        assert len(up.sharding.device_set) == 4
        np.testing.assert_allclose(np.asarray(up), np.asarray(ref.flux_up),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(np.asarray(dn), np.asarray(ref.flux_dn),
                                   rtol=0, atol=1e-3)

    def test_sw_shard_map_matches_unsharded(self, setup):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import (
            _sw_core_lay_major_jit,
            default_solar_source,
            sw_core_sharded,
        )
        from rte_rrtmgp_nn_tpu.gasoptics.planck import sw_spectral_g112

        data, _, sw, mesh, concs = setup
        spec = sw_spectral_g112()
        solar = jnp.asarray(default_solar_source(spec), jnp.float32)
        f32 = lambda a: jnp.asarray(a, jnp.float32)
        args = (f32(data.play), f32(data.plev), f32(data.tlay),
                f32(data.sfc_alb), f32(np.cos(np.deg2rad(data.sza))),
                jnp.asarray(data.sza < 90.0), f32(data.tsi), concs)
        ref = _sw_core_lay_major_jit(sw, spec, solar, *args,
                                     top_at_1=data.top_at_1)
        up, dn, dn_dir = jax.jit(sw_core_sharded(mesh, sw, spec, solar,
                                                 data.top_at_1))(
            *shard_columns(args, mesh))
        for got, want in ((up, ref.flux_up), (dn, ref.flux_dn),
                          (dn_dir, ref.flux_dn_dir)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=0, atol=1e-2)


class TestShardMap:
    """Explicit shard_map SPMD (parallel/shard_ops.py)."""

    def test_columnwise_shard_map_matches_global(self):
        from rte_rrtmgp_nn_tpu.ops.lw_solver import lw_solver_noscat
        from rte_rrtmgp_nn_tpu.parallel.shard_ops import columnwise_shard_map
        from rte_rrtmgp_nn_tpu.parallel.sharding import make_mesh, shard_columns

        mesh = make_mesh(n_col=8)
        r = np.random.default_rng(11)
        ncol, nlay, ngpt = 64, 9, 16
        mk = lambda *s: jnp.asarray(r.uniform(0.1, 1.0, s), jnp.float32)
        args = (mk(ncol, nlay, ngpt), mk(ncol, nlay, ngpt), mk(ncol, nlay + 1, ngpt),
                mk(ncol, ngpt), mk(ncol, ngpt))
        ref = lw_solver_noscat(*args, broadband=True)

        def solve(tau, lay, lev, emis, sfc):
            out = lw_solver_noscat(tau, lay, lev, emis, sfc, broadband=True)
            return out.flux_up, out.flux_dn

        fn = jax.jit(columnwise_shard_map(mesh, solve, n_array_args=5))
        sharded = shard_columns(args, mesh)
        up, dn = fn(*sharded)
        np.testing.assert_allclose(np.asarray(up), np.asarray(ref.flux_up), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(dn), np.asarray(ref.flux_dn), rtol=1e-6, atol=1e-6)

    def test_flux_stats_distributed(self):
        from rte_rrtmgp_nn_tpu.parallel.shard_ops import flux_stats, weighted_error_stats
        from rte_rrtmgp_nn_tpu.parallel.sharding import make_mesh, shard_columns

        mesh = make_mesh(n_col=4, n_gpt=2)
        r = np.random.default_rng(7)
        x = r.normal(100.0, 20.0, (32, 13)).astype(np.float32)
        y = x + r.normal(0.0, 0.5, x.shape).astype(np.float32)
        xs = shard_columns(jnp.asarray(x), mesh)
        ys = shard_columns(jnp.asarray(y), mesh)
        mean, lo, hi = jax.jit(lambda a: flux_stats(mesh, a))(xs)
        assert abs(float(mean) - x.mean()) < 1e-3
        assert abs(float(lo) - x.min()) < 1e-5
        assert abs(float(hi) - x.max()) < 1e-5
        mae, rmse, mx = jax.jit(lambda a, b: weighted_error_stats(mesh, a, b))(ys, xs)
        d = np.abs(y - x)
        assert abs(float(mae) - d.mean()) < 1e-4
        assert abs(float(rmse) - np.sqrt((d ** 2).mean())) < 1e-4
        assert abs(float(mx) - d.max()) < 1e-5

    def test_eval_metrics_single_chip_equals_sharded(self):
        """The single-chip eval loop and the distributed shard_map eval run
        the SAME core (shard_ops.rfmip_eval_metrics_core): results must
        agree to psum-tree reassociation tolerance."""
        from rte_rrtmgp_nn_tpu.parallel.shard_ops import (
            rfmip_eval_metrics_sharded,
        )
        from rte_rrtmgp_nn_tpu.parallel.sharding import make_mesh
        from rte_rrtmgp_nn_tpu.training.eval_loop import eval_metrics

        r = np.random.default_rng(3)
        nexp, nsites, nlev = 12, 16, 13
        ncol = nexp * nsites
        plev_1d = np.linspace(100.0, 100000.0, nlev, dtype=np.float32)
        plev = np.broadcast_to(plev_1d, (ncol, nlev)).copy()
        ref_up = r.uniform(150, 400, (ncol, nlev)).astype(np.float32)
        ref_dn = r.uniform(50, 350, (ncol, nlev)).astype(np.float32)
        up = ref_up + r.normal(0, 0.5, ref_up.shape).astype(np.float32)
        dn = ref_dn + r.normal(0, 0.5, ref_dn.shape).astype(np.float32)

        single = eval_metrics(up, dn, ref_up, ref_dn, plev, nexp)

        mesh = make_mesh(n_col=8)
        rs = lambda a: jnp.asarray(a).reshape(nexp, nsites, nlev)
        sharded = jax.jit(lambda *a: rfmip_eval_metrics_sharded(mesh, *a))(
            rs(up), rs(dn), rs(ref_up), rs(ref_dn), rs(plev))
        np.testing.assert_allclose(np.asarray(sharded), single,
                                   rtol=2e-5, atol=2e-5)
        # the metrics are non-trivial (not all zeros)
        assert np.count_nonzero(single) >= 6
