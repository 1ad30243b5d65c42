"""The seeded driver inputs (drivers/seeded_inputs.py): shapes, physical
ranges, determinism by seed, and agreement with what the models and
drivers read."""
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si


@pytest.fixture(scope="module")
def rfmip():
    return si.make_rfmip(seed=0)


@pytest.fixture(scope="module")
def models():
    return si.load_models(seed=0)


class TestRFMIP:
    def test_shapes_match_the_rfmip_file(self, rfmip):
        assert (rfmip.nsites, rfmip.nexp, rfmip.nlay) == (100, 18, 60)
        assert rfmip.ncol == 1800
        assert rfmip.play.shape == rfmip.tlay.shape == (1800, 60)
        assert rfmip.plev.shape == rfmip.tlev.shape == (1800, 61)
        for a in (rfmip.tsfc, rfmip.sfc_emis, rfmip.sfc_alb, rfmip.sza,
                  rfmip.tsi):
            assert a.shape == (1800,)
        # surface first, as the RFMIP file stores its levels
        assert not rfmip.top_at_1
        assert np.all(rfmip.plev[:, 0] > rfmip.plev[:, -1])

    def test_physical_ranges(self, rfmip):
        assert np.all(np.diff(rfmip.plev, axis=1) < 0)
        assert np.all((rfmip.play < rfmip.plev[:, :-1])
                      & (rfmip.play > rfmip.plev[:, 1:]))
        assert 160.0 <= rfmip.tlay.min() and rfmip.tlay.max() <= 340.0
        assert np.all((rfmip.sfc_emis > 0.9) & (rfmip.sfc_emis <= 1.0))
        assert np.all((rfmip.sfc_alb > 0.0) & (rfmip.sfc_alb < 1.0))
        night = rfmip.sza >= 90.0
        assert 0.1 < night.mean() < 0.6  # day and night columns both present
        assert np.all((rfmip.tsi > 1300.0) & (rfmip.tsi < 1420.0))
        for v in rfmip.gas_concs.concs.values():
            assert np.all((v >= 0.0) & (v <= 1.0))

    def test_gases_cover_the_lw_model_inputs(self, rfmip, models):
        (lw,), (sw_abs, sw_ray) = models
        gases = set(rfmip.gas_concs.concs)
        assert set(lw.input_names) - {"tlay", "play"} <= gases
        assert set(sw_abs.input_names) - {"tlay", "play"} <= gases
        assert sw_ray.input_names == sw_abs.input_names

    def test_inputs_inside_the_lw_model_ranges(self, rfmip, models):
        (lw,), _ = models
        feats = {"tlay": rfmip.tlay, "play": np.log(rfmip.play)}
        for i, name in enumerate(lw.input_names):
            v = feats.get(name)
            if v is None:
                v = rfmip.gas_concs.concs[name]
                if name in ("h2o", "o3"):
                    v = v ** 0.25
            lo, hi = float(lw.input_min[i]), float(lw.input_max[i])
            span = hi - lo
            assert v.min() >= lo - 0.05 * span, name
            assert v.max() <= hi + 0.05 * span, name

    def test_same_seed_same_inputs(self):
        a, b = si.make_rfmip(seed=5, nsites=3), si.make_rfmip(seed=5, nsites=3)
        for f in ("play", "plev", "tlay", "tlev", "tsfc", "sza", "tsi"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for g in a.gas_concs.concs:
            np.testing.assert_array_equal(a.gas_concs.concs[g],
                                          b.gas_concs.concs[g])

    def test_other_seed_other_inputs(self):
        a, b = si.make_rfmip(seed=5, nsites=3), si.make_rfmip(seed=6, nsites=3)
        assert not np.array_equal(a.tlay, b.tlay)
        assert not np.array_equal(a.sza, b.sza)

    def test_experiments_share_sites(self, rfmip):
        """Experiment-major columns: every experiment repeats the 100
        sites' pressures (as read_rfmip broadcasts them)."""
        p = rfmip.play.reshape(18, 100, 60)
        np.testing.assert_array_equal(p[0], p[17])
        co2 = rfmip.gas_concs.concs["co2"].reshape(18, 100, 60)
        assert len(np.unique(co2[:, 0, 0])) > 3


class TestBlocksAndClouds:
    def test_gcm_block_size(self):
        blk = si.make_gcm_block(seed=1, ncol=1000)
        assert blk.ncol == 1000 and blk.play.shape == (1000, 60)
        assert si.GCM_BLOCK_NCOL == 57_600

    def test_allsky_atmosphere(self):
        atm = si.make_allsky_atmosphere(seed=1, ncol=30)
        assert atm.ncol == 30 and atm.nlay == 60
        assert {"h2o", "o3", "co2", "ch4", "n2o"} <= set(atm.gas_concs.concs)

    @pytest.mark.parametrize("kind,nband", [("lw", 16), ("sw", 14)])
    def test_cloud_optics_table_shapes(self, kind, nband):
        co = si.make_cloud_optics(seed=0, kind=kind)
        assert co.is_lut and co.nband == nband
        assert co.lut_extliq.shape == (nband, 20)
        assert co.lut_extice.shape == (3, nband, 18)
        assert (co.radliq_lwr, co.radliq_upr) == (2.5, 21.5)
        assert (co.radice_lwr, co.radice_upr) == (10.0, 180.0)
        for t in (co.lut_ssaliq, co.lut_ssaice, co.lut_asyliq, co.lut_asyice):
            t = np.asarray(t)
            assert np.all((t >= 0.0) & (t < 1.0))
        assert np.all(np.asarray(co.lut_extliq) > 0.0)

    def test_cloud_fields_follow_make_clouds(self):
        from rte_rrtmgp_nn_tpu.drivers.allsky import make_clouds

        atm = si.make_allsky_atmosphere(seed=1, ncol=30)
        co = si.make_cloud_optics(seed=0, kind="lw")
        lwp, iwp, rel, rei = si.make_cloud_fields(2, atm.play, atm.tlay, co)
        lwp0, iwp0, _, _ = make_clouds(atm.play, atm.tlay, co)
        np.testing.assert_array_equal(lwp > 0, np.asarray(lwp0) > 0)
        np.testing.assert_array_equal(iwp > 0, np.asarray(iwp0) > 0)
        assert lwp.max() > 0 and iwp.max() > 0
        assert np.all((rel[lwp > 0] >= co.radliq_lwr)
                      & (rel[lwp > 0] <= co.radliq_upr))
        assert np.all((rei[iwp > 0] >= co.radice_lwr)
                      & (rei[iwp > 0] <= co.radice_upr))


class TestModels:
    def test_widths(self, models):
        (lw,), (sw_abs, sw_ray) = models
        assert lw.dims == [18, 128, 128, 256]
        assert sw_abs.dims == [7, 48, 48, 112]
        assert sw_ray.dims == sw_abs.dims
        assert lw.activations == ("softsign", "softsign", "linear")

    def test_rayleigh_tau_positive_and_physical(self, models, rfmip):
        import jax.numpy as jnp

        from rte_rrtmgp_nn_tpu.gas_concs import GasConcs
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import (
            compute_nn_inputs,
            predict_tau,
        )

        _, (_, ray) = models
        d = rfmip.block(0, 20)
        gc = GasConcs({k: jnp.asarray(v) for k, v in d.gas_concs.concs.items()})
        x = compute_nn_inputs(jnp.asarray(d.play), jnp.asarray(d.tlay), gc, ray)
        k = np.asarray(predict_tau(ray, x, jnp.ones(d.play.shape)))
        # per-molecule Rayleigh cross sections [cm2] over the SW bands
        assert np.all(k > 0.0)
        assert 1e-31 < np.median(k) < 1e-25

    def test_rayleigh_model_determined_by_seed(self):
        _, (_, r0) = si.load_models(seed=0)
        _, (_, r0b) = si.load_models(seed=0)
        _, (_, r1) = si.load_models(seed=1)
        np.testing.assert_array_equal(np.asarray(r0.weights[0]),
                                      np.asarray(r0b.weights[0]))
        assert not np.array_equal(np.asarray(r0.weights[0]),
                                  np.asarray(r1.weights[0]))
