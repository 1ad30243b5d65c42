"""NN gas-optics emulator training.

Reference parity: ``examples/rrtmgp-nn-training/ml_train.py`` --
predictands lw_absorption / lw_planck_frac / lw_both / sw_absorption /
sw_rayleigh (:188-195); output scaling tau -> cross-section (/col_dry) ->
y**(1/8) -> per-g-point mean, global std (:40-47, 361-367); MLP with Adam
lr 1e-3 batch 2048 (:259-262); optional hybrid loss
``alpha*expdiff + (1-alpha)*MSE`` on paired experiments for forcing
accuracy (ml_trainfuncs_keras.py:47-67); radiation-in-the-loop evaluation
lives in training/eval_loop.py (in-process jitted RFMIP eval instead of
the reference's Fortran subprocess).

Design: the train step is a pure jitted function over the NNModel
pytree; data parallelism = batch sharding over the mesh 'col' axis with
XLA-inserted gradient psums.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models.network import NNModel


def init_model(
    dims: list[int],
    key: jax.Array,
    hidden_activation: str = "softsign",
    input_names: tuple = (),
    input_min=None,
    input_max=None,
    output_mean=None,
    output_std=None,
    dtype=jnp.float32,
) -> NNModel:
    """He-style init of an MLP in our NNModel container (the equivalent of
    ml_trainfuncs_keras.create_model_mlp)."""
    weights, biases = [], []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(2.0 / dims[i]).astype(dtype)
        weights.append(jax.random.normal(sub, (dims[i], dims[i + 1]), dtype) * scale)
        biases.append(jnp.zeros((dims[i + 1],), dtype))
    acts = tuple([hidden_activation] * (len(dims) - 2) + ["linear"])
    n_in = dims[0]
    return NNModel(
        weights=tuple(weights),
        biases=tuple(biases),
        activations=acts,
        input_names=tuple(input_names) or tuple(f"x{i}" for i in range(n_in)),
        input_min=jnp.zeros((n_in,), dtype) if input_min is None else jnp.asarray(input_min, dtype),
        input_max=jnp.ones((n_in,), dtype) if input_max is None else jnp.asarray(input_max, dtype),
        output_mean=None if output_mean is None else jnp.asarray(output_mean, dtype),
        output_std=None if output_std is None else jnp.asarray(output_std, dtype),
    )


# -- output scalings (reference ml_load_save_preproc.py:283-541) -------------

def scale_outputs_tau(tau: jnp.ndarray, col_dry: jnp.ndarray) -> jnp.ndarray:
    """tau -> y = (tau/col_dry)**(1/8): the model's raw-output target before
    standardization."""
    sigma = tau / col_dry[..., None]
    return sigma ** 0.125


def standardize_coeffs(y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-g-point mean, global std (ml_train.py:361-367)."""
    ymean = y.reshape(-1, y.shape[-1]).mean(axis=0)
    ystd = np.full(y.shape[-1], y.reshape(-1, y.shape[-1]).std())
    return ymean, ystd


def scale_outputs_pfrac(pfrac: jnp.ndarray) -> jnp.ndarray:
    """pfrac -> sqrt(pfrac) (trained with the square root; inference squares)."""
    return jnp.sqrt(pfrac)


# -- losses ------------------------------------------------------------------

def mse_loss(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean((pred - target) ** 2)


def expdiff_loss(pred: jnp.ndarray, target: jnp.ndarray, pair_idx: jnp.ndarray) -> jnp.ndarray:
    """Difference-between-paired-experiments loss component
    (ml_trainfuncs_keras.py expdiff, :47-67): penalizes errors in the
    *difference* of predictions between paired samples (e.g. present vs
    future scenarios), which controls forcing accuracy.

    pair_idx: (npairs, 2) indices into the batch."""
    dp = pred[pair_idx[:, 0]] - pred[pair_idx[:, 1]]
    dt = target[pair_idx[:, 0]] - target[pair_idx[:, 1]]
    return jnp.mean((dp - dt) ** 2)


def hybrid_loss(pred, target, pair_idx, alpha: float = 0.5):
    """alpha*expdiff + (1-alpha)*MSE (hybrid_loss_wrapper)."""
    return alpha * expdiff_loss(pred, target, pair_idx) + (1.0 - alpha) * mse_loss(pred, target)


# -- train step --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainState:
    model: NNModel
    opt_state: optax.OptState
    step: jnp.ndarray


jax.tree_util.register_dataclass(TrainState, data_fields=["model", "opt_state", "step"], meta_fields=[])


def make_train_step(optimizer: optax.GradientTransformation, alpha: float = 0.0):
    """Build a jittable train step. With alpha > 0 the batch must carry
    pair indices for the expdiff term."""

    def loss_fn(model: NNModel, x, y, pair_idx=None):
        pred = model.apply_raw(x)
        if pair_idx is not None and alpha > 0:
            return hybrid_loss(pred, y, pair_idx, alpha)
        return mse_loss(pred, y)

    def train_step(state: TrainState, x, y, pair_idx=None):
        loss, grads = jax.value_and_grad(loss_fn)(state.model, x, y, pair_idx)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.model)
        model = optax.apply_updates(state.model, updates)
        return TrainState(model, opt_state, state.step + 1), loss

    return train_step


def cocob(alpha: float = 100.0) -> optax.GradientTransformation:
    """COCOB-Backprop (Orabona & Tommasi 2017): the parameter-free
    coin-betting optimizer the reference offers as an alternative to Adam
    (ml_trainfuncs_keras.py COCOB class, :216+)."""

    def init_fn(params):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        eps_like = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 1e-8), params)
        return {
            "init_params": params,
            "L": eps_like,          # max |gradient| seen
            "grad_sum": zeros,      # sum of |gradients|
            "reward": zeros,
            "theta": zeros,         # sum of -gradients
        }

    def update_fn(grads, state, params):
        if params is None:
            raise ValueError("cocob requires params")

        def upd(g, w, w1, L, gsum, r, th):
            L_new = jnp.maximum(L, jnp.abs(g))
            gsum_new = gsum + jnp.abs(g)
            r_new = jnp.maximum(r - g * (w - w1), 0.0)
            th_new = th - g
            w_new = w1 + th_new / (L_new * jnp.maximum(gsum_new + L_new, alpha * L_new)) * (
                L_new + r_new
            )
            return w_new - w, L_new, gsum_new, r_new, th_new

        out = jax.tree_util.tree_map(
            upd, grads, params, state["init_params"], state["L"],
            state["grad_sum"], state["reward"], state["theta"],
        )
        updates = jax.tree_util.tree_map(lambda t: t[0], out, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 5)
        new_state = {
            "init_params": state["init_params"],
            "L": jax.tree_util.tree_map(lambda t: t[1], out, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 5),
            "grad_sum": jax.tree_util.tree_map(lambda t: t[2], out, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 5),
            "reward": jax.tree_util.tree_map(lambda t: t[3], out, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 5),
            "theta": jax.tree_util.tree_map(lambda t: t[4], out, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 5),
        }
        return updates, new_state

    return optax.GradientTransformation(init_fn, update_fn)


def create_train_state(model: NNModel, learning_rate: float = 1e-3) -> tuple[TrainState, optax.GradientTransformation]:
    """Adam lr 1e-3 as in the reference (ml_train.py:259-262). The scaling
    coefficients are unused by apply_raw, so their gradients -- and hence
    their Adam updates -- are identically zero; no masking needed."""
    optimizer = optax.adam(learning_rate)
    state = TrainState(model, optimizer.init(model), jnp.zeros((), jnp.int32))
    return state, optimizer
