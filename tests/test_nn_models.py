"""NN model format and inference tests against the shipped reference models."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.models.network import NNModel, load_model_netcdf, save_model_netcdf

DATA = "/root/reference/neural/data"


def _model(name):
    p = os.path.join(DATA, name)
    if not os.path.exists(p):
        pytest.skip(f"{name} not available")
    return load_model_netcdf(p)


class TestLoad:
    def test_lw_both(self):
        m = _model("lw-g128-210809_both_BEST.nc")
        assert m.n_inputs == 18 and m.n_outputs == 256 and m.n_layers == 3
        assert m.activations == ("softsign", "softsign", "linear")
        assert m.input_names[:4] == ("tlay", "play", "h2o", "o3")
        assert m.output_mean.shape == (256,) and m.output_std.shape == (256,)
        assert float(m.input_min[0]) == pytest.approx(160.0)

    def test_sw_models(self):
        for name in ("sw-g112-210809_absorption_BEST.nc", "sw-g112-210809_rayleigh_BEST.nc"):
            m = _model(name)
            assert m.n_inputs == 7 and m.n_outputs == 112

    def test_apply_shapes_and_finiteness(self):
        m = _model("lw-g128-210809_both_BEST.nc")
        x = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (5, 4, 18)), jnp.float32)
        y = m.apply_raw(x)
        assert y.shape == (5, 4, 256)
        assert np.all(np.isfinite(np.asarray(y)))

    def test_softsign_bounds_hidden(self):
        """Softsign outputs are in (-1, 1); with linear head the raw outputs
        are bounded by sum |W|+|b| -- sanity check the magnitudes."""
        m = _model("lw-g128-210809_absorption_BEST.nc")
        x = jnp.zeros((1, 18), jnp.float32)
        y = np.asarray(m.apply_raw(x))
        assert np.all(np.abs(y) < 1e3)


class TestSaveRoundtrip:
    def test_roundtrip(self, tmp_path):
        m = _model("lw-g128-210809_planck_frac_BEST.nc")
        p = str(tmp_path / "model.nc")
        save_model_netcdf(p, m)
        m2 = load_model_netcdf(p)
        assert m2.activations == m.activations
        assert m2.input_names == m.input_names
        for a, b in zip(m.weights, m2.weights):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(m.biases, m2.biases):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(m.input_min), np.asarray(m2.input_min))
        x = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (7, 18)), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(m.apply_raw(x)), np.asarray(m2.apply_raw(x)), rtol=1e-6
        )


def test_nn_scenario_index_missing_gas(rng):
    """config.nn_scenario_index controls the VMR used for gases absent from
    the gas description (reference mo_rte_rrtmgp_config.F90:40 +
    mo_gas_ref_concentrations.F90): 0 = zero, 1/2/3 = present-day /
    pre-industrial / future reference values; the NN inputs must differ
    accordingly."""
    import numpy as np

    from rte_rrtmgp_nn_tpu import config as _c
    from rte_rrtmgp_nn_tpu.config import config_override
    from rte_rrtmgp_nn_tpu.gas_concs import GasConcs, get_ref_vmr
    from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import compute_nn_inputs
    from rte_rrtmgp_nn_tpu.models.network import load_model_netcdf

    from rte_rrtmgp_nn_tpu.drivers.seeded_inputs import (
        ARTIFACTS_DIR,
        LW_MODEL_FILE,
    )

    # the repository's g-128 model reads the same 18 inputs as the
    # reference's lw-g128-210809 model
    m = load_model_netcdf(os.path.join(ARTIFACTS_DIR, LW_MODEL_FILE))
    ncol, nlay = 4, 6
    play = jnp.asarray(rng.uniform(1e3, 1e5, (ncol, nlay)), jnp.float32)
    tlay = jnp.asarray(rng.uniform(200.0, 300.0, (ncol, nlay)), jnp.float32)
    # only the two required gases; everything else missing
    gd = GasConcs({
        "h2o": jnp.full((ncol, nlay), 3e-3, jnp.float32),
        "o3": jnp.full((ncol, nlay), 5e-8, jnp.float32),
    })
    feats = {}
    for scen in (0, 1, 2, 3):
        with config_override(nn_scenario_index=scen):
            feats[scen] = np.asarray(compute_nn_inputs(play, tlay, gd, m))
    i_co2 = m.input_names.index("co2")
    # scenario 0: missing co2 scaled from zero; others from the table
    lo, hi = float(m.input_min[i_co2]), float(m.input_max[i_co2])
    assert np.allclose(feats[0][..., i_co2], (0.0 - lo) / (hi - lo), atol=1e-6)
    for scen in (1, 2, 3):
        expect = (get_ref_vmr(scen, "co2") - lo) / (hi - lo)
        assert np.allclose(feats[scen][..., i_co2], expect, atol=1e-6), scen
    # the three scenarios are genuinely distinct
    assert len({round(float(feats[s][0, 0, i_co2]), 9) for s in (1, 2, 3)}) == 3
