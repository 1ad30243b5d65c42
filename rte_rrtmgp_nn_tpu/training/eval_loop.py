"""Radiation-in-the-loop evaluation and early stopping.

Reference parity: the eval drivers ``rrtmgp_lw_eval_nn_rfmip.F90`` (8
scalar error metrics vs reference fluxes: pressure-weighted heating-rate
MAE all-experiments and present-day, TOA upwelling bias, and five
radiative-forcing biases between experiment pairs; :452-603) and the Keras
callback ``RunRadiationScheme`` (ml_trainfuncs_keras.py:85-213: run the
scheme each epoch, normalize metrics by the reference scheme's own scores,
early-stop on the RMS "radiation score" with best-weights restore).

Design: the reference round-trips through a Fortran subprocess writing
netCDF each epoch; here the full RFMIP flux evaluation is an in-process
jitted function over the candidate model pytree -- no serialization, no
process boundary. All 8 scalar reductions run device-side through ONE
shared jitted core, ``parallel.shard_ops.rfmip_eval_metrics_core``: the
single-chip path calls it directly; multi-chip evals call
``rfmip_eval_metrics_sharded`` (sites sharded over 'col', psum tree) on
the very same core, so the two can never drift
(tests/test_sharding.py pins them to each other).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.network import NNModel, save_model_netcdf
from ..parallel.shard_ops import rfmip_eval_metrics_core

METRIC_NAMES = (
    "MAE HR (all)",
    "MAE HR (PD)",
    "Bias TOA upwelling",
    "Bias RF-TOA (PI->PD)",
    "Bias RF-TOA (PD->future)",
    "Bias RF-SFC (PI->future)",
    "Bias RF-SFC N2O (PI->PD)",
    "Bias RF-SFC CH4 (PI->PD)",
)

@functools.partial(jax.jit, static_argnames=("top_at_1",))
def _metrics_jit(up, dn, rup, rdn, plev, top_at_1):
    return rfmip_eval_metrics_core(up, dn, rup, rdn, plev,
                                   top_at_1=top_at_1)


def eval_metrics(
    flux_up: np.ndarray,
    flux_dn: np.ndarray,
    ref_up: np.ndarray,
    ref_dn: np.ndarray,
    plev: np.ndarray,
    nexp: int,
    top_at_1: bool = True,
) -> np.ndarray:
    """The 8 scalar error metrics of the reference eval driver
    (rrtmgp_lw_eval_nn_rfmip.F90:452-577), evaluated by the SHARED
    device-side core (parallel.shard_ops.rfmip_eval_metrics_core -- the
    same numerics the sharded multi-chip eval uses).

    Arrays are (ncol = nexp*nsites, nlev); plev (ncol, nlev).
    """
    nsites = flux_up.shape[0] // nexp

    def rs(a):
        return jnp.asarray(np.asarray(a, np.float32)).reshape(
            nexp, nsites, -1)

    m = _metrics_jit(rs(flux_up), rs(flux_dn), rs(ref_up), rs(ref_dn),
                     rs(plev), top_at_1=top_at_1)
    return np.asarray(m, np.float64)


def radiation_score(metrics: np.ndarray, ref_scores: np.ndarray) -> float:
    """RMS of metrics normalized by the reference scheme's own error levels
    (reference RunRadiationScheme: score = rms(metric_i / refscore_i))."""
    r = metrics / np.where(np.abs(ref_scores) > 0, np.abs(ref_scores), 1.0)
    return float(np.sqrt(np.mean(r * r)))


def provenance_attrs(result: "EarlyStopResult",
                     ref_scores: np.ndarray) -> dict:
    """Global netCDF attributes recording the full radiation-eval outcome
    (metric vector + normalizers + score) so the artifact is
    self-describing -- the score-encoded FILENAME alone proved ambiguous
    (a shipped pair's filename metrics were not recoverable from its
    logged score)."""
    m = np.asarray(result.history[result.best_epoch]["metrics"], np.float64)
    return {
        "radiation_score": float(result.best_score),
        "radiation_metrics": m,
        "radiation_metric_names": "; ".join(METRIC_NAMES),
        "radiation_ref_scores": np.asarray(ref_scores, np.float64),
        "best_epoch": np.int32(result.best_epoch),
    }


@dataclasses.dataclass
class EarlyStopResult:
    best_model: NNModel
    best_score: float
    best_epoch: int
    history: list


def train_with_radiation_eval(
    state,
    train_step: Callable,
    data_iter: Callable,
    eval_fn: Callable[[NNModel], np.ndarray],
    ref_scores: np.ndarray,
    n_epochs: int = 100,
    steps_per_epoch: int = 100,
    patience: int = 70,
    save_path: Optional[str] = None,
    verbose: bool = True,
    ema_decay: Optional[float] = None,
) -> EarlyStopResult:
    """The training loop with per-epoch radiation evaluation.

    eval_fn(model) -> 8 metrics (an in-process jitted RFMIP evaluation);
    early stop on the radiation score with best-weights restore
    (ml_trainfuncs_keras.py:126-209). If ``save_path``, the best model is
    written as a reference-format netCDF with the score in the filename
    (ml_train.py:493-517 naming convention).

    ema_decay: if set (e.g. 0.999), evaluate/save a Polyak exponential
    moving average of the weights instead of the raw iterate -- the
    per-epoch radiation score is noisy near convergence (stochastic
    expdiff pairs) and the averaged weights sit at the basin floor.
    """
    best = EarlyStopResult(state.model, np.inf, -1, [])
    bad_epochs = 0
    ema = state.model if ema_decay else None
    if ema_decay:
        ema_step = jax.jit(lambda e, m: jax.tree_util.tree_map(
            lambda a, b: ema_decay * a + (1.0 - ema_decay) * b, e, m))
    for epoch in range(n_epochs):
        loss = None
        for _ in range(steps_per_epoch):
            x, y = data_iter()
            state, loss = train_step(state, x, y)
            if ema_decay:
                ema = ema_step(ema, state.model)
        eval_model = ema if ema_decay else state.model
        metrics = eval_fn(eval_model)
        score = radiation_score(metrics, ref_scores)
        best.history.append({"epoch": epoch, "loss": float(loss), "score": score,
                             "metrics": metrics.tolist()})
        if verbose:
            print(f"epoch {epoch}: loss {float(loss):.5f} radiation_score {score:.4f}")
        if score < best.best_score:
            best = dataclasses.replace(
                best, best_model=eval_model, best_score=score, best_epoch=epoch
            )
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                break
    if save_path is not None:
        if best.best_epoch < 0:
            # zero epochs, or every score was NaN (diverged training):
            # best_model is still the UNTRAINED init and history[-1] would
            # stamp it with the wrong epoch's metrics -- refuse to save
            raise RuntimeError(
                "no epoch produced a finite radiation score; refusing to "
                "save the untrained initial model")
        hr_rel = best.history[best.best_epoch]["metrics"][0] / max(abs(ref_scores[0]), 1e-12)
        frc_rel = max(
            abs(m) / max(abs(r), 1e-12)
            for m, r in zip(best.history[best.best_epoch]["metrics"][3:], ref_scores[3:])
        )
        path = save_path.format(hr=f"{hr_rel:.2e}", frc=f"{frc_rel:.2e}")
        save_model_netcdf(path, best.best_model,
                          attrs=provenance_attrs(best, ref_scores))
        if verbose:
            print(f"saved best model (epoch {best.best_epoch}) to {path}")
    return best
