"""End-to-end differentiability: gradients flow through gas optics AND the
RTE solvers, enabling flux-loss training of the gas-optics emulator --
a capability the reference's Fortran/subprocess round-trip cannot offer
(its radiation-in-the-loop is evaluation-only; SURVEY.md section 3.4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.fluxes import reduce_broadband
from rte_rrtmgp_nn_tpu.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import (
    compute_nn_inputs,
    get_col_dry,
    predict_nn_lw,
)
from rte_rrtmgp_nn_tpu.gasoptics.planck import PlanckTable, lw_spectral_g128, compute_planck_source_nn
from rte_rrtmgp_nn_tpu.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu.ops.lw_solver import lw_solver_noscat
from rte_rrtmgp_nn_tpu.optical_props import OpticalProps1scl
from rte_rrtmgp_nn_tpu.rte import rte_lw
from rte_rrtmgp_nn_tpu.sources import SourceFuncLW

D = "/root/reference/neural/data/"


@pytest.fixture(scope="module")
def setup():
    import os

    p = D + "lw-g128-210809_both_BEST.nc"
    if not os.path.exists(p):
        pytest.skip("model not available")
    model = load_model_netcdf(p)
    spec = lw_spectral_g128()
    table = PlanckTable.compute(spec.band_lims_wvn_array)
    rng = np.random.default_rng(0)
    ncol, nlay = 4, 12
    plev = np.exp(np.linspace(np.log(100.0), np.log(101325.0), nlay + 1))
    plev = np.broadcast_to(plev, (ncol, nlay + 1)).astype(np.float32)
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    tlay = (230 + 60 * (play / play.max()) ** 0.3).astype(np.float32)
    tlev = np.concatenate([tlay[:, :1], 0.5 * (tlay[:, 1:] + tlay[:, :-1]), tlay[:, -1:]], 1)
    tsfc = tlev[:, -1] + 2
    gc = GasConcs.create({"h2o": (3e-3 * (play / play.max()) ** 1.5 + 1e-6).astype(np.float32),
                          "co2": 4e-4, "o3": 5e-7, "n2o": 3.2e-7, "ch4": 1.8e-6})
    return model, spec, table, (jnp.asarray(play), jnp.asarray(plev), jnp.asarray(tlay),
                                jnp.asarray(tlev), jnp.asarray(tsfc), gc)


def _flux_loss(model, spec, table, atmos, target_up):
    play, plev, tlay, tlev, tsfc, gc = atmos
    ncol, nlay = play.shape
    col_dry = get_col_dry(gc.get_vmr("h2o", ncol, nlay), plev)
    x = compute_nn_inputs(play, tlay, gc, model)
    tau, pfrac = predict_nn_lw([model], x, col_dry)
    lay, lev, sfc, jacs = compute_planck_source_nn(pfrac, tlay, tlev, tsfc, spec, table)
    sources = SourceFuncLW(lay, lev, sfc, jacs, spec)
    emis = jnp.full((ncol, spec.nband), 0.98, play.dtype)
    sol = rte_lw(OpticalProps1scl(tau, spec), True, sources, emis, broadband=True)
    return jnp.mean((sol.flux_up - target_up) ** 2)


class TestGradients:
    def test_grad_flows_to_all_weights(self, setup):
        model, spec, table, atmos = setup
        target = jnp.zeros((4, 13))
        grads = jax.grad(lambda m: _flux_loss(m, spec, table, atmos, target))(model)
        for i, g in enumerate(grads.weights):
            gn = float(jnp.linalg.norm(g))
            assert np.isfinite(gn) and gn > 0, f"layer {i} grad is {gn}"
        for g in grads.biases:
            assert np.all(np.isfinite(np.asarray(g)))

    def test_finite_difference_agreement(self, setup):
        """Directional derivative of the flux loss matches finite
        differences through the FULL pipeline (NN -> planck -> solver)."""
        model, spec, table, atmos = setup
        target = jnp.full((4, 13), 100.0)
        loss = lambda m: _flux_loss(m, spec, table, atmos, target)
        g = jax.grad(loss)(model)
        key = jax.random.PRNGKey(1)
        direction = jax.tree_util.tree_map(
            lambda p: jax.random.normal(key, p.shape, p.dtype) if p is not None else None,
            model,
        )
        # only perturb weights/biases
        import dataclasses

        direction = dataclasses.replace(
            direction, input_min=jnp.zeros_like(model.input_min),
            input_max=jnp.zeros_like(model.input_max),
            output_mean=jnp.zeros_like(model.output_mean),
            output_std=jnp.zeros_like(model.output_std),
        )
        dot = sum(
            float(jnp.vdot(a, b))
            for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(direction))
        )
        eps = 1e-3
        perturbed = jax.tree_util.tree_map(lambda p, d: p + eps * d, model, direction)
        perturbed_m = jax.tree_util.tree_map(lambda p, d: p - eps * d, model, direction)
        fd = (loss(perturbed) - loss(perturbed_m)) / (2 * eps)
        assert abs(float(fd) - dot) / (abs(dot) + 1e-8) < 0.05

    def test_flux_finetuning_reduces_loss(self, setup):
        """A few SGD steps on the flux loss through the solver reduce it --
        the 'train on fluxes directly' capability."""
        import optax

        model, spec, table, atmos = setup
        # target: the model's own fluxes with perturbed CO2 (a re-tuning task)
        play, plev, tlay, tlev, tsfc, gc = atmos
        gc2 = gc.set_vmr("co2", 8e-4)
        atmos2 = (play, plev, tlay, tlev, tsfc, gc2)
        target = None
        ncol, nlay = play.shape
        col_dry = get_col_dry(gc2.get_vmr("h2o", ncol, nlay), plev)
        x2 = compute_nn_inputs(play, tlay, gc2, model)
        tau, pfrac = predict_nn_lw([model], x2, col_dry)
        lay, lev, sfc, jacs = compute_planck_source_nn(pfrac, tlay, tlev, tsfc, spec, table)
        sources = SourceFuncLW(lay, lev, sfc, jacs, spec)
        emis = jnp.full((ncol, spec.nband), 0.98, play.dtype)
        sol = rte_lw(OpticalProps1scl(tau, spec), True, sources, emis, broadband=True)
        target = sol.flux_up

        loss_fn = jax.jit(lambda m: _flux_loss(m, spec, table, atmos, target))
        # small lr: the **8 postprocessing amplifies gradient scale
        opt = optax.adam(3e-6)
        state = opt.init(model)
        m = model
        l0 = float(loss_fn(m))

        @jax.jit
        def step(m, state):
            l, g = jax.value_and_grad(lambda mm: _flux_loss(mm, spec, table, atmos, target))(m)
            updates, state = opt.update(g, state, m)
            return optax.apply_updates(m, updates), state, l

        for _ in range(40):
            m, state, l = step(m, state)
        assert float(l) < 0.1 * l0, (l0, float(l))
