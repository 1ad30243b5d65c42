"""Auxiliary component tests: validators, flux output/compare, COCOB,
fast exponential, Pade source, byband/bygpoint reducers end-to-end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rte_rrtmgp_nn_tpu as rt
from rte_rrtmgp_nn_tpu.drivers.flux_output import compare_flux_files, write_fluxes_rfmip
from rte_rrtmgp_nn_tpu.fluxes import reduce_byband, FluxesBygpoint
from rte_rrtmgp_nn_tpu.utils.validation import (
    any_vals_less_than,
    any_vals_outside,
    extents_are,
    zero_array,
)


class TestValidators:
    def test_basic(self):
        a = np.array([1.0, 2.0, 3.0])
        assert any_vals_less_than(a, 1.5)
        assert not any_vals_less_than(a, 0.5)
        assert any_vals_outside(a, 1.5, 2.5)
        assert not any_vals_outside(a, 0.0, 5.0)
        assert extents_are(a, 3) and not extents_are(a, 4)
        assert zero_array((2, 3)).shape == (2, 3)

    def test_masked(self):
        a = np.array([1.0, -5.0, 3.0])
        m = np.array([True, False, True])
        assert not any_vals_less_than(a, 0.0, mask=m)
        assert any_vals_less_than(a, 0.0, mask=~m)
        assert not any_vals_outside(a, 0.0, 4.0, mask=m)
        assert not any_vals_less_than(a, 0.0, mask=np.zeros(3, bool))  # empty mask


class TestFluxOutput:
    def test_write_and_compare_pass(self, tmp_path):
        rng = np.random.default_rng(0)
        nexp, nsite, nlev = 2, 3, 5
        flux = rng.uniform(0, 400, (nexp * nsite, nlev)).astype(np.float32)
        plev = np.linspace(100, 1e5, nlev)
        p1, p2 = str(tmp_path / "a.nc"), str(tmp_path / "b.nc")
        write_fluxes_rfmip(p1, {"rlu": flux}, plev, nexp, nsite)
        write_fluxes_rfmip(p2, {"rlu": flux + 1e-7}, plev, nexp, nsite)
        res = compare_flux_files(p1, p2, ["rlu"], fail_threshold=1e-5, verbose=False)
        assert res["passed"] and res["max_diffs"]["rlu"] < 1e-5

    def test_compare_fail(self, tmp_path):
        nexp, nsite, nlev = 1, 2, 4
        flux = np.ones((2, 4), np.float32)
        plev = np.linspace(100, 1e5, nlev)
        p1, p2 = str(tmp_path / "a.nc"), str(tmp_path / "b.nc")
        write_fluxes_rfmip(p1, {"rld": flux}, plev, nexp, nsite)
        write_fluxes_rfmip(p2, {"rld": flux + 0.5}, plev, nexp, nsite)
        res = compare_flux_files(p1, p2, ["rld"], fail_threshold=1e-5, verbose=False)
        assert not res["passed"]


class TestCOCOB:
    def test_optimizes_quadratic(self):
        from rte_rrtmgp_nn_tpu.training.train import cocob

        opt = cocob()
        params = {"w": jnp.array([5.0, -3.0])}
        state = opt.init(params)

        @jax.jit
        def step(params, state):
            grads = {"w": 2.0 * params["w"]}  # d/dw of w^2
            updates, state = opt.update(grads, state, params)
            return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), state

        for _ in range(300):
            params, state = step(params, state)
        assert float(jnp.abs(params["w"]).max()) < 0.5


class TestConfigVariants:
    def test_fast_exponential_close(self, rng):
        """exp_fast (Pade) within ~1e-4 of exp for moderate optical paths
        (reference FAST_EXPONENTIAL, mo_rte_solver_kernels.F90:90-106)."""
        from rte_rrtmgp_nn_tpu.ops.lw_solver import _exp

        x = jnp.asarray(rng.uniform(0.0, 5.0, 100))
        exact = np.exp(-np.asarray(x))
        with rt.config_override(fast_exponential=True):
            approx = np.asarray(_exp(-x))
        np.testing.assert_allclose(approx, exact, atol=5e-4)
        assert np.all(approx >= 0.0)

    def test_fast_exponential_sw_paths(self, rng):
        """fast_exponential covers the SW solvers too (reference exp_fast
        scope: direct beam :520-526, two-stream Tnoscat/exp(-k*tau)
        :1293,1311): the flag must flip the SW numerics, stay close to
        exact, and the direct beam must reproduce the reference's PER-LAYER
        recurrence (product of per-layer Pade transmittances, not the Pade
        form of the cumulative path)."""
        from rte_rrtmgp_nn_tpu.ops.expfast import exp_fast
        from rte_rrtmgp_nn_tpu.ops.sw_solver import (
            direct_beam,
            sw_solver_2stream,
        )

        ncol, nlay, ngpt = 4, 12, 8
        tau = jnp.asarray(rng.uniform(0.02, 0.8, (ncol, nlay, ngpt)))
        ssa = jnp.asarray(rng.uniform(0.2, 0.9, (ncol, nlay, ngpt)))
        g = jnp.asarray(rng.uniform(0.0, 0.7, (ncol, nlay, ngpt)))
        mu0 = jnp.asarray(rng.uniform(0.3, 1.0, (ncol,)))
        inc = jnp.asarray(rng.uniform(0.5, 1.5, (ncol, ngpt)))
        alb = jnp.full((ncol, ngpt), 0.2)

        s0 = sw_solver_2stream(tau, ssa, g, mu0, inc, alb, alb)
        with rt.config_override(fast_exponential=True):
            s1 = sw_solver_2stream(tau, ssa, g, mu0, inc, alb, alb)
            beam = np.asarray(direct_beam(tau, mu0, inc * mu0[:, None]))
        # the flag changes SW numerics...
        assert not np.array_equal(np.asarray(s0.flux_dn), np.asarray(s1.flux_dn))
        # ...but only by the Pade approximation error
        np.testing.assert_allclose(
            np.asarray(s1.flux_dn), np.asarray(s0.flux_dn), rtol=2e-3)
        np.testing.assert_allclose(
            np.asarray(s1.flux_up), np.asarray(s0.flux_up), rtol=4e-3)
        # per-layer recurrence semantics of the fast direct beam
        lay_t = np.asarray(exp_fast(-tau / mu0[:, None, None]))
        expect = np.asarray(inc * mu0[:, None])[:, None, :] * np.concatenate(
            [np.ones((ncol, 1, ngpt)), np.cumprod(lay_t, axis=1)], axis=1)
        np.testing.assert_allclose(beam, expect, rtol=1e-6)

    def test_pade_source_runs(self, rng):
        """use_Pade_source variant produces close fluxes (reference
        mo_rte_rrtmgp_config.F90:30 + the Pade branch of the source)."""
        from rte_rrtmgp_nn_tpu.ops.lw_solver import lw_solver_noscat

        ncol, nlay, ngpt = 3, 10, 8
        tau = jnp.asarray(rng.uniform(0.05, 1.0, (ncol, nlay, ngpt)))
        lay = jnp.asarray(rng.uniform(0.5, 1.0, (ncol, nlay, ngpt)))
        lev = jnp.asarray(rng.uniform(0.5, 1.0, (ncol, nlay + 1, ngpt)))
        emis = jnp.ones((ncol, ngpt))
        sfc = jnp.ones((ncol, ngpt))
        s0 = lw_solver_noscat(tau, lay, lev, emis, sfc)
        with rt.config_override(use_pade_source=True):
            s1 = lw_solver_noscat(tau, lay, lev, emis, sfc)
        up0 = np.asarray(jnp.sum(s0.flux_up, -1))
        up1 = np.asarray(jnp.sum(s1.flux_up, -1))
        assert np.max(np.abs(up0 - up1) / np.abs(up0)) < 0.02  # alternative forms agree to ~2%

    def test_broadband_matches_spectral_reduction(self, rng):
        """The fused broadband path must equal summing the spectral path."""
        from rte_rrtmgp_nn_tpu.ops.lw_solver import lw_solver_noscat

        ncol, nlay, ngpt = 4, 12, 16
        tau = jnp.asarray(rng.uniform(0.05, 2.0, (ncol, nlay, ngpt)))
        lay = jnp.asarray(rng.uniform(0.5, 1.0, (ncol, nlay, ngpt)))
        lev = jnp.asarray(rng.uniform(0.5, 1.0, (ncol, nlay + 1, ngpt)))
        emis = jnp.asarray(rng.uniform(0.9, 1.0, (ncol, ngpt)))
        sfc = jnp.asarray(rng.uniform(0.5, 1.0, (ncol, ngpt)))
        jac = jnp.asarray(rng.uniform(0.0, 0.1, (ncol, ngpt)))
        s_spec = lw_solver_noscat(tau, lay, lev, emis, sfc, sfc_source_jac=jac)
        s_bb = lw_solver_noscat(tau, lay, lev, emis, sfc, sfc_source_jac=jac, broadband=True)
        np.testing.assert_allclose(
            np.asarray(s_bb.flux_up), np.asarray(jnp.sum(s_spec.flux_up, -1)), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(s_bb.flux_dn), np.asarray(jnp.sum(s_spec.flux_dn, -1)), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(s_bb.flux_up_jac), np.asarray(jnp.sum(s_spec.flux_up_jac, -1)), rtol=1e-6,
            atol=1e-12,
        )

    def test_sw_broadband_matches_spectral(self, rng):
        from rte_rrtmgp_nn_tpu.ops.sw_solver import sw_solver_2stream

        ncol, nlay, ngpt = 3, 9, 8
        tau = jnp.asarray(rng.uniform(0.05, 1.0, (ncol, nlay, ngpt)))
        ssa = jnp.asarray(rng.uniform(0.2, 0.95, tau.shape))
        g = jnp.asarray(rng.uniform(0.0, 0.7, tau.shape))
        mu0 = jnp.asarray(rng.uniform(0.3, 1.0, (ncol,)))
        inc = jnp.full((ncol, ngpt), 100.0)
        alb = jnp.full((ncol, ngpt), 0.2)
        s_spec = sw_solver_2stream(tau, ssa, g, mu0, inc, alb, alb)
        s_bb = sw_solver_2stream(tau, ssa, g, mu0, inc, alb, alb, broadband=True)
        np.testing.assert_allclose(
            np.asarray(s_bb.flux_up), np.asarray(jnp.sum(s_spec.flux_up, -1)), rtol=2e-5
        )
        np.testing.assert_allclose(
            np.asarray(s_bb.flux_dn), np.asarray(jnp.sum(s_spec.flux_dn, -1)), rtol=2e-5
        )
        np.testing.assert_allclose(
            np.asarray(s_bb.flux_dn_dir), np.asarray(jnp.sum(s_spec.flux_dn_dir, -1)), rtol=2e-5
        )


class TestBybandReducers:
    def test_byband_end_to_end(self, rng):
        from rte_rrtmgp_nn_tpu.spectral import SpectralMapping

        blg = np.stack([np.arange(4) * 3, (np.arange(4) + 1) * 3], 1)
        blw = np.stack([np.arange(4) * 100.0, (np.arange(4) + 1) * 100.0], 1)
        sm = SpectralMapping.create(blg, blw)
        up = jnp.asarray(rng.uniform(0, 10, (2, 5, 12)))
        dn = jnp.asarray(rng.uniform(0, 10, (2, 5, 12)))
        fb = reduce_byband(sm, up, dn)
        assert fb.bnd_flux_up.shape == (2, 5, 4)
        np.testing.assert_allclose(
            np.asarray(jnp.sum(fb.bnd_flux_up, -1)), np.asarray(fb.broadband.flux_up), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(fb.bnd_flux_up[..., 0]), np.asarray(jnp.sum(up[..., :3], -1)), rtol=1e-6
        )
        gp = FluxesBygpoint(gpt_flux_up=up, gpt_flux_dn=dn)
        assert gp.gpt_flux_up.shape == (2, 5, 12)


class TestFluxFileHygiene:
    def test_write_nc_preserves_float64(self, tmp_path):
        """Explicit f64 casts (col_dry, pres_level, regression goldens)
        must survive the file roundtrip; f32 stays f32."""
        from rte_rrtmgp_nn_tpu.utils import ncio

        p = str(tmp_path / "dtypes.nc")
        v64 = np.array([[1.0 + 1e-9, 2.0]], np.float64)  # sub-f32-ulp info
        v32 = np.array([[1.0, 2.0]], np.float32)
        ncio.write_nc(p, {"a": 1, "b": 2},
                      {"x64": (("a", "b"), v64), "x32": (("a", "b"), v32)})
        with ncio.NCFile(p) as f:
            r64 = f.read("x64")
            r32 = f.read("x32")
        # scipy reads back big-endian ('>f8'); compare kind+width
        assert r64.dtype.kind == "f" and r64.dtype.itemsize == 8
        assert r32.dtype.kind == "f" and r32.dtype.itemsize == 4
        np.testing.assert_array_equal(r64.astype(np.float64), v64)

    def test_compare_flux_files_no_common_vars_fails(self, tmp_path):
        """Zero compared variables is a FAILED comparison, not a vacuous
        pass (a renamed output file must not clear the golden gate)."""
        from rte_rrtmgp_nn_tpu.drivers.flux_output import compare_flux_files
        from rte_rrtmgp_nn_tpu.utils import ncio

        arr = np.ones((2, 3), np.float32)
        p1, p2 = str(tmp_path / "c.nc"), str(tmp_path / "r.nc")
        ncio.write_nc(p1, {"a": 2, "b": 3}, {"rlu": (("a", "b"), arr)})
        ncio.write_nc(p2, {"a": 2, "b": 3}, {"flux_up": (("a", "b"), arr)})
        res = compare_flux_files(p1, p2, verbose=False)
        assert not res["passed"] and res["max_diffs"] == {}


class TestMixedPrecisionPacking:
    """Mixed-precision h2d packing for the streamed GCM path
    (drivers/gcm._pack_columns_mixed)."""

    def test_roundtrip_precision(self):
        import jax.numpy as jnp

        from rte_rrtmgp_nn_tpu.drivers.gcm import (
            _pack_columns_mixed,
            _unpack_columns_mixed,
        )

        rng = np.random.default_rng(0)
        tlay = rng.uniform(180.0, 320.0, (64, 60)).astype(np.float32)
        play = np.exp(rng.uniform(0.0, 11.5, (64, 60))).astype(np.float32)
        h2o = np.exp(rng.uniform(-16.0, -3.5, (64, 60))).astype(np.float32)
        tsfc = rng.uniform(250.0, 310.0, (64,)).astype(np.float32)
        pf, pq, qmeta, layout = _pack_columns_mixed(
            [(tlay, "lin"), (play, "log"), (h2o, "log"), (tsfc, "f32")])
        assert pq.dtype == np.uint16 and pq.shape == (64, 180)
        assert pf.shape == (64, 1)
        out = _unpack_columns_mixed(
            jnp.asarray(pf), jnp.asarray(pq), jnp.asarray(qmeta), layout)
        t2, p2, h2, ts2 = (np.asarray(o) for o in out)
        # linear lanes: absolute error bounded by half a quantization step
        assert np.max(np.abs(t2 - tlay)) < (320.0 - 180.0) / 65535
        # log lanes: RELATIVE error ~ half a log-step
        assert np.max(np.abs(p2 / play - 1.0)) < 2e-4
        assert np.max(np.abs(h2 / h2o - 1.0)) < 2e-4
        # f32 lanes bit-exact
        np.testing.assert_array_equal(ts2, tsfc)

    def test_log_rejects_nonpositive(self):
        from rte_rrtmgp_nn_tpu.drivers.gcm import _pack_columns_mixed

        with pytest.raises(ValueError):
            _pack_columns_mixed([(np.zeros((4, 3), np.float32), "log")])

    def test_strict_gt_threshold_preserved_on_equality(self):
        """make_clouds' liquid branch is STRICT (tlay > 263.0), so a raw
        value exactly ON the threshold must not dequantize above it, and a
        dequant grid point landing exactly ON it must not demote a raw
        value that was above (the two equality holes of a >=-only
        adjudication)."""
        import jax.numpy as jnp

        from rte_rrtmgp_nn_tpu.drivers.gcm import (
            _pack_columns_mixed,
            _unpack_columns_mixed,
        )

        t = 263.0
        # case A: exact-t values inside a lane whose grid does not hit t
        lane_a = np.linspace(262.9, 263.1, 64).astype(np.float64)
        lane_a[7] = t
        lane_a[23] = t
        # case B: lane min exactly t, so q=0 dequantizes exactly ON t --
        # values epsilon above must be bumped off the grid point
        lane_b = t + np.linspace(0.0, 0.05, 64) ** 2
        lane_b[11] = t + 1e-4
        arr = np.stack([lane_a, lane_b], axis=1)
        pf, pq, qmeta, layout = _pack_columns_mixed(
            [(arr, ("lin", ((t, ">"),)))])
        deq = np.asarray(_unpack_columns_mixed(
            jnp.asarray(pf), jnp.asarray(pq), jnp.asarray(qmeta),
            layout)[0], np.float64)
        raw32 = arr.astype(np.float32).astype(np.float64)
        np.testing.assert_array_equal(deq > t, raw32 > t)
        # the plain (>=) form still covers strict-< branches exactly:
        # v < t  ==  not (v >= t)
        pf, pq, qmeta, layout = _pack_columns_mixed(
            [(arr, ("lin", (t,)))])
        deq = np.asarray(_unpack_columns_mixed(
            jnp.asarray(pf), jnp.asarray(pq), jnp.asarray(qmeta),
            layout)[0], np.float64)
        np.testing.assert_array_equal(deq < t, raw32 < t)

    def test_gcm_lw_flip_orientation_consistent(self):
        """The GCM sweep's [olr, sfc_dn] diagnostics must follow top_at_1:
        a vertically flipped host with the flag flipped is the same
        physical atmosphere, so the diagnostics must match exactly."""
        from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
        from rte_rrtmgp_nn_tpu.drivers.gcm import gcm_host_columns, gcm_sweep_lw

        base = si.make_gcm_block(seed=0, ncol=128)
        host = gcm_host_columns(base)
        m, _ = si.load_models(seed=0)
        a = gcm_sweep_lw(host, m, block_size=64, top_at_1=base.top_at_1)
        flipped = {
            k: (v[:, ::-1].copy() if getattr(v, "ndim", 0) == 2 else v)
            for k, v in host.items()
        }
        b = gcm_sweep_lw(flipped, m, block_size=64,
                         top_at_1=not base.top_at_1)
        np.testing.assert_array_equal(a["diagnostics"], b["diagnostics"])

    def test_gcm_lw_mixed_matches_f32(self):
        """Driver-level parity: the mixed-precision streamed sweep must
        reproduce the f32 sweep to well under the NN's ~0.1 W/m2 error."""
        from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
        from rte_rrtmgp_nn_tpu.drivers.gcm import gcm_host_columns, gcm_sweep_lw

        base = si.make_gcm_block(seed=0, ncol=256)
        host = gcm_host_columns(base)
        m, _ = si.load_models(seed=0)
        a = gcm_sweep_lw(host, m, block_size=128, top_at_1=base.top_at_1)
        b = gcm_sweep_lw(host, m, block_size=128, top_at_1=base.top_at_1,
                         precision="mixed")
        d = np.abs(a["diagnostics"] - b["diagnostics"])
        assert d.max() < 0.02  # W/m2

    def test_gcm_allsky_mixed_matches_f32_grazing(self):
        """All-sky mixed-precision parity INCLUDING grazing-sun columns:
        day columns with 0 < mu0 <= 0.1 must ride the exact-f32 side sweep
        (before it, exp(-tau/mu0) amplified the quantized-tau error to 1.5
        W/m2 there), and night columns must stream SW = 0 exactly."""
        from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
        from rte_rrtmgp_nn_tpu.drivers.gcm import (
            gcm_host_columns,
            gcm_sweep_allsky,
        )

        base = si.make_gcm_block(seed=0, ncol=192)
        host = gcm_host_columns(base)
        # force a terminator band: grazing day suns in cloudy + clear cols
        host["sza"][10:20] = np.linspace(84.5, 89.9, 10)
        lw, sw = si.load_models(seed=0)
        clw = si.make_cloud_optics(seed=0, kind="lw")
        csw = si.make_cloud_optics(seed=0, kind="sw")
        a = gcm_sweep_allsky(host, lw, sw, clw, csw, block_size=64,
                             top_at_1=base.top_at_1)
        b = gcm_sweep_allsky(host, lw, sw, clw, csw, block_size=64,
                             top_at_1=base.top_at_1, precision="mixed")
        d = np.abs(a["diagnostics"] - b["diagnostics"])
        assert d.max() < 0.05  # W/m2, incl. the grazing band
        night = np.cos(np.deg2rad(host["sza"])) <= 0.0
        assert night.any()
        assert np.all(a["diagnostics"][night, 2] == 0.0)  # SW masked
        assert np.all(b["diagnostics"][night, 2] == 0.0)
