"""The GPU path's numerics, checked on the CPU: exact gathers in place of
one-hot products, the package matmul precision on every dot, the drivers on
seeded inputs against float64, and the entry scripts refusing a non-GPU
device."""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
from rte_rrtmgp_nn_tpu.gasoptics.planck import (
    lw_spectral_g128,
    sw_spectral_g112,
    sw_spectral_g224,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's phase-4 tolerance against float64 [W/m2]
MAX_ABS_TOL, MEAN_ABS_TOL = 0.05, 5e-3

SPECTRA = {"lw_g128": lw_spectral_g128, "sw_g112": sw_spectral_g112,
           "sw_g224": sw_spectral_g224}


def _onehot(spec):
    return (spec.gpt2band[None, :] == np.arange(spec.nband)[:, None]
            ).astype(np.float64)


class TestBandMapping:
    @pytest.mark.parametrize("name", sorted(SPECTRA))
    def test_expand_gather_equals_onehot(self, name):
        spec = SPECTRA[name]()
        x = np.random.default_rng(0).uniform(0, 1, (3, 5, spec.nband))
        got = np.asarray(spec.expand(jnp.asarray(x, jnp.float64)))
        np.testing.assert_array_equal(got, x @ _onehot(spec))

    @pytest.mark.parametrize("name", sorted(SPECTRA))
    def test_reduce_sum_equals_onehot(self, name):
        spec = SPECTRA[name]()
        x = np.random.default_rng(1).uniform(0, 1, (4, spec.ngpt))
        got = np.asarray(spec.reduce_sum(jnp.asarray(x, jnp.float64)))
        np.testing.assert_allclose(got, x @ _onehot(spec).T, rtol=1e-14)

    def test_expand_float32_is_exact(self):
        spec = lw_spectral_g128()
        x = jnp.asarray(np.random.default_rng(2).uniform(0, 1, (7, 16)),
                        jnp.float32)
        got = np.asarray(spec.expand(x))
        np.testing.assert_array_equal(got, np.asarray(x)[:, spec.gpt2band])


def _split3_onehot_table(mask, wp_, re_, offset, upr, ext_t, ssa_t, asy_t):
    """The previous float32 cloud-LUT interpolation: a one-hot row pick of
    a 3-term bf16-split [values | forward differences] table."""
    nband, nsteps = ext_t.shape
    dtype = re_.dtype
    fidx = (re_ - offset) / ((upr - offset) / (nsteps - 1))
    index = jnp.clip(jnp.floor(fidx).astype(jnp.int32), 0, nsteps - 2)
    fint = (fidx - index)[..., None]
    cat = jnp.concatenate([t.T.astype(dtype) for t in (ext_t, ssa_t, asy_t)], 1)
    tbl = jnp.concatenate(
        [cat, jnp.concatenate([cat[1:] - cat[:-1],
                               jnp.zeros((1, cat.shape[1]), dtype)], 0)], 1)
    hi = tbl.astype(jnp.bfloat16).astype(dtype)
    mid = (tbl - hi).astype(jnp.bfloat16).astype(dtype)
    lo = tbl - hi - mid
    oh = (jnp.arange(nsteps) == index[..., None]).astype(dtype)
    hp = jax.lax.Precision.HIGHEST
    g = (jnp.dot(oh, hi, precision=hp) + jnp.dot(oh, mid, precision=hp)
         ) + jnp.dot(oh, lo, precision=hp)
    vals = g[..., :3 * nband] + fint * g[..., 3 * nband:]
    m = mask[..., None]
    t = jnp.where(m, wp_[..., None] * vals[..., :nband], 0.0)
    ts = t * vals[..., nband:2 * nband]
    return (t, jnp.where(m, ts, 0.0),
            jnp.where(m, ts * vals[..., 2 * nband:], 0.0))


class TestCloudLUT:
    @pytest.mark.parametrize("kind", ["lw", "sw"])
    def test_gather_equals_split_onehot_form(self, kind):
        from rte_rrtmgp_nn_tpu.extensions.cloud_optics import _from_table

        co = si.make_cloud_optics(seed=0, kind=kind)
        rng = np.random.default_rng(3)
        wp = jnp.asarray(rng.uniform(0, 30, (6, 9)), jnp.float32)
        re_ = jnp.asarray(rng.uniform(co.radliq_lwr, co.radliq_upr, (6, 9)),
                          jnp.float32)
        args = (wp > 3.0, wp, re_, co.radliq_lwr, co.radliq_upr,
                co.lut_extliq, co.lut_ssaliq, co.lut_asyliq)
        for a, b in zip(_from_table(*args), _split3_onehot_table(*args)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-7, atol=0)


def _lowered_dots(fn, *args, **kw):
    txt = fn.lower(*args, **kw).as_text()
    return [ln for ln in txt.splitlines() if "dot_general" in ln]


class TestMatmulPrecision:
    def test_constant_is_highest(self):
        from rte_rrtmgp_nn_tpu.config import MATMUL_PRECISION

        assert MATMUL_PRECISION == jax.lax.Precision.HIGHEST

    @pytest.mark.parametrize("band", ["lw", "sw"])
    def test_every_dot_in_clear_sky_core_is_highest(self, band):
        from rte_rrtmgp_nn_tpu.drivers import rfmip as r
        from rte_rrtmgp_nn_tpu.gasoptics.planck import PlanckTable

        d = si.make_rfmip(seed=0, nsites=1).block(0, 4)
        lw, sw = si.load_models(seed=0)
        f32 = jnp.float32
        concs = {k: jnp.asarray(v, f32) for k, v in d.gas_concs.concs.items()}
        if band == "lw":
            spec = lw_spectral_g128()
            table = PlanckTable.compute(spec.band_lims_wvn_array, dtype=f32)
            dots = _lowered_dots(
                r._lw_core_lay_major_jit, lw, table, spec,
                *(jnp.asarray(a, f32) for a in (d.play, d.plev, d.tlay,
                                                d.tlev, d.tsfc)),
                jnp.ones((4, spec.nband), f32), concs, top_at_1=False)
        else:
            spec = sw_spectral_g112()
            dots = _lowered_dots(
                r._sw_core_lay_major_jit, sw, spec,
                jnp.ones((spec.ngpt,), f32),
                *(jnp.asarray(a, f32) for a in (d.play, d.plev, d.tlay,
                                                d.sfc_alb)),
                jnp.full((4,), 0.5, f32), jnp.ones((4,), bool),
                jnp.asarray(d.tsi, f32), concs, top_at_1=False)
        # 3 GEMMs per net: one LW 'both' net, two SW nets
        assert len(dots) >= (3 if band == "lw" else 6)
        assert all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots), dots

    def test_every_dot_in_allsky_sw_core_is_highest(self):
        from rte_rrtmgp_nn_tpu.drivers import allsky as a

        atm = si.make_allsky_atmosphere(seed=1, ncol=4)
        co = si.make_cloud_optics(seed=0, kind="sw")
        _, sw = si.load_models(seed=0)
        spec = sw_spectral_g112()
        f32 = jnp.float32
        fields = si.make_cloud_fields(2, atm.play, atm.tlay, co)
        dots = _lowered_dots(
            a._allsky_sw_core_lay_major_jit, sw, spec,
            jnp.ones((spec.ngpt,), f32), co,
            *(jnp.asarray(x, f32) for x in (atm.play, atm.plev, atm.tlay)),
            jnp.full((4,), 0.86, f32), jnp.full((4, 14), 0.06, f32),
            jnp.full((4, 14), 0.06, f32),
            *(jnp.asarray(x, f32) for x in fields),
            {k: jnp.asarray(v, f32) for k, v in atm.gas_concs.concs.items()},
            top_at_1=False)
        assert len(dots) >= 6
        assert all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots)


class TestResonance:
    def test_near_resonant_sw_coefficients_match_float64(self):
        """k * mu0 within float32 rounding of 1: the coefficients must stay
        close to their float64 values (the removable 0/0 of MW Eqs 14-15)."""
        from rte_rrtmgp_nn_tpu.ops.sw_solver import _sw_two_stream_coeffs

        ssa = np.linspace(0.55, 0.7, 4001)
        tau = np.full_like(ssa, 0.05)
        g = np.zeros_like(ssa)
        k = np.sqrt(4.0 * (1.0 - ssa) * (1.0 - 0.25 * ssa))
        mu0 = np.full_like(ssa, 0.86)
        assert np.abs(1.0 - k * mu0).min() < 1e-5  # the sweep crosses 1/k
        out32 = _sw_two_stream_coeffs(*(jnp.asarray(a, jnp.float32)
                                        for a in (tau, ssa, g, mu0)))
        out64 = _sw_two_stream_coeffs(*(jnp.asarray(a, jnp.float64)
                                        for a in (tau, ssa, g, mu0)))
        # float32 rounding ~eps/sqrt(eps) plus the sqrt(eps) shift; the
        # unguarded formulas are off by up to 1.6e-2 here
        for name, a, b in zip(("rdif", "tdif", "rdir", "tdir"), out32, out64):
            d = np.abs(np.asarray(a, np.float64) - np.asarray(b))
            assert d.max() < 5e-4, (name, d.max())


@pytest.fixture(scope="module")
def seeded():
    lw, sw = si.load_models(seed=0)
    return {
        "data": si.make_rfmip(seed=0, nsites=3),  # 54 columns, 1 site night
        "atm": si.make_allsky_atmosphere(seed=1, ncol=24),
        "co_lw": si.make_cloud_optics(seed=0, kind="lw"),
        "co_sw": si.make_cloud_optics(seed=0, kind="sw"),
        "lw": lw, "sw": sw,
    }


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                        tree)


def _assert_close_to_f64(got, ref, fields):
    for f in fields:
        d = np.abs(np.asarray(getattr(got, f), np.float64)
                   - np.asarray(getattr(ref, f)))
        assert np.all(np.isfinite(d)), f
        assert d.max() <= MAX_ABS_TOL and d.mean() <= MEAN_ABS_TOL, (
            f, d.max(), d.mean())


class TestDriversAgainstFloat64:
    """The drivers at float32 on seeded inputs agree with the same drivers
    at float64 within chip_smoke.py's phase-4 tolerance."""

    def test_rfmip_clear_sky_lw(self, seeded):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import rfmip_clear_sky_lw

        got = rfmip_clear_sky_lw(seeded["data"], seeded["lw"])
        ref = rfmip_clear_sky_lw(seeded["data"], _to64(seeded["lw"]),
                                 dtype=jnp.float64)
        _assert_close_to_f64(got, ref, ("flux_up", "flux_dn"))

    def test_rfmip_clear_sky_sw(self, seeded):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import rfmip_clear_sky_sw

        data = seeded["data"]
        got = rfmip_clear_sky_sw(data, seeded["sw"])
        ref = rfmip_clear_sky_sw(data, _to64(seeded["sw"]), dtype=jnp.float64)
        _assert_close_to_f64(got, ref, ("flux_up", "flux_dn", "flux_dn_dir"))
        night = data.sza >= 90.0
        assert night.any() and not night.all()
        assert np.all(np.asarray(got.flux_dn)[night] == 0.0)
        mu0 = np.cos(np.deg2rad(data.sza.astype(np.float64)))
        np.testing.assert_allclose(np.asarray(got.flux_dn)[~night, -1],
                                   (data.tsi * mu0)[~night], rtol=1e-5)

    def test_allsky_lw(self, seeded):
        from rte_rrtmgp_nn_tpu.drivers.allsky import allsky_lw

        atm, co = seeded["atm"], seeded["co_lw"]
        clouds = si.make_cloud_fields(2, atm.play, atm.tlay, co)
        got = allsky_lw(atm, co, seeded["lw"], clouds=clouds)
        ref = allsky_lw(atm, _to64(co), _to64(seeded["lw"]),
                        dtype=jnp.float64, clouds=clouds)
        _assert_close_to_f64(got, ref, ("flux_up", "flux_dn"))

    def test_allsky_sw(self, seeded):
        from rte_rrtmgp_nn_tpu.drivers.allsky import allsky_sw

        atm, co = seeded["atm"], seeded["co_sw"]
        clouds = si.make_cloud_fields(2, atm.play, atm.tlay, co)
        got = allsky_sw(atm, co, seeded["sw"], clouds=clouds)
        ref = allsky_sw(atm, _to64(co), _to64(seeded["sw"]),
                        dtype=jnp.float64, clouds=clouds)
        _assert_close_to_f64(got, ref, ("flux_up", "flux_dn", "flux_dn_dir"))

    def test_repeated_driver_calls_reuse_the_compiled_core(self, seeded):
        from rte_rrtmgp_nn_tpu.drivers import rfmip as r

        r.rfmip_clear_sky_sw(seeded["data"], seeded["sw"])
        before = r._sw_core_lay_major_jit._cache_size()
        r.rfmip_clear_sky_sw(seeded["data"], seeded["sw"])
        assert r._sw_core_lay_major_jit._cache_size() == before


def _run(cmd, cwd, env_extra):
    env = dict(os.environ)
    env.update({k: v for k, v in env_extra.items() if v is not None})
    if "JAX_PLATFORMS" in env_extra and env_extra["JAX_PLATFORMS"] is None:
        env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


class TestEntryScriptsRefuseCPU:
    def test_chip_smoke_fails_without_gpu(self):
        p = _run([sys.executable, "chip_smoke.py"], REPO,
                 {"JAX_PLATFORMS": "cpu"})
        assert p.returncode != 0
        assert '"ok"' not in p.stdout
        assert "needs a GPU" in p.stderr

    def test_chip_smoke_alone_fails(self, tmp_path):
        src = os.path.join(REPO, "chip_smoke.py")
        dst = tmp_path / "chip_smoke.py"
        dst.write_text(open(src).read())
        p = _run([sys.executable, "chip_smoke.py"], str(tmp_path),
                 {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
        assert p.returncode != 0
        assert '"ok"' not in p.stdout

    def test_bench_refuses_an_unrequested_cpu(self):
        # no JAX_PLATFORMS: JAX finds only the CPU here, which bench.py
        # must not measure unless asked to
        p = _run([sys.executable, "bench.py"], REPO, {"JAX_PLATFORMS": None})
        assert p.returncode != 0
        assert "needs a GPU" in p.stderr
        assert not re.search(r'"metric"', p.stdout)
