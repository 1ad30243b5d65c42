"""Train a fresh LW gas-optics emulator end-to-end (demonstration).

The full reference ML pipeline (SURVEY.md section 3.4) in-process:
distill the shipped BEST "both" model into a smaller network on real RFMIP
atmospheres, with radiation-in-the-loop early stopping scored against the
teacher's own fluxes, and save the best model in the reference netCDF
format (score-encoded filename).

Run:  JAX_PLATFORMS=cpu python scripts/train_demo.py [--epochs N]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from rte_rrtmgp_nn_tpu.drivers.rfmip import rfmip_clear_sky_lw
from rte_rrtmgp_nn_tpu.drivers.rfmip_io import read_rfmip
from rte_rrtmgp_nn_tpu.fluxes import reduce_broadband
from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import (
    compute_nn_inputs,
    get_col_dry,
    predict_nn_lw,
)
from rte_rrtmgp_nn_tpu.gasoptics.planck import PlanckTable, lw_spectral_g128, compute_planck_source_nn
from rte_rrtmgp_nn_tpu.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu.optical_props import OpticalProps1scl
from rte_rrtmgp_nn_tpu.rte import rte_lw
from rte_rrtmgp_nn_tpu.sources import SourceFuncLW
from rte_rrtmgp_nn_tpu.training.eval_loop import eval_metrics, train_with_radiation_eval
from rte_rrtmgp_nn_tpu.training.train import (
    TrainState,
    init_model,
    make_train_step,
)

RFMIP = (
    "/root/reference/examples/rfmip-clear-sky/"
    "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc"
)
TEACHER = "/root/reference/neural/data/lw-g128-210809_both_BEST.nc"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--steps-per-epoch", type=int, default=400)
    ap.add_argument("--alpha", type=float, default=0.6,
                    help="hybrid-loss weight on the paired-experiment "
                         "expdiff term (0 = pure MSE)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-pairs", type=int, default=1024)
    ap.add_argument("--patience", type=int, default=15)
    ap.add_argument("--init-from", default=None, metavar="MODEL_NC",
                    help="warm-start from a previously saved artifact "
                         "(hidden sizes must match)")
    ap.add_argument("--out-dir", default=os.path.join(os.path.dirname(__file__), "..", "artifacts"))
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    teacher = load_model_netcdf(TEACHER)
    data = read_rfmip(RFMIP)
    spec = lw_spectral_g128()
    table = PlanckTable.compute(spec.band_lims_wvn_array)
    ncol, nlay = data.play.shape

    # training set: the teacher's raw outputs on the RFMIP atmospheres
    play, plev = jnp.asarray(data.play), jnp.asarray(data.plev)
    tlay, tlev = jnp.asarray(data.tlay), jnp.asarray(data.tlev)
    tsfc = jnp.asarray(data.tsfc)
    x = compute_nn_inputs(play, tlay, data.gas_concs, teacher)
    y_raw = teacher.apply_raw(x)  # (ncol, nlay, 256) scaled-space targets
    xs = np.asarray(x).reshape(-1, 18)
    ys = np.asarray(y_raw).reshape(-1, 256)
    col_dry = get_col_dry(data.gas_concs.get_vmr("h2o", ncol, nlay), plev)

    # teacher fluxes = the evaluation reference
    ref_fb = rfmip_clear_sky_lw(data, [teacher], spectral=spec, planck_table=table)
    ref_up, ref_dn = np.asarray(ref_fb.flux_up), np.asarray(ref_fb.flux_dn)

    if args.init_from:
        student = load_model_netcdf(args.init_from)
        assert student.weights[0].shape == (18, args.hidden), (
            f"--init-from hidden size {student.weights[0].shape[1]} != "
            f"--hidden {args.hidden}")
    else:
        student = init_model(
            [18, args.hidden, args.hidden, 256], jax.random.PRNGKey(0),
            input_names=teacher.input_names,
            input_min=teacher.input_min, input_max=teacher.input_max,
            output_mean=teacher.output_mean, output_std=teacher.output_std,
        )
    import optax

    total_steps = args.epochs * args.steps_per_epoch
    optimizer = optax.adam(
        optax.cosine_decay_schedule(args.lr, total_steps, alpha=1e-2))
    state = TrainState(student, optimizer.init(student), jnp.zeros((), jnp.int32))
    step_inner = jax.jit(make_train_step(optimizer, alpha=args.alpha))

    # Paired-experiment batches for the expdiff forcing term
    # (ml_trainfuncs_keras.py:47-67): each batch is [a-rows | b-rows] where
    # row i and row npairs+i are the SAME (site, layer) under two different
    # RFMIP experiments -- half drawn from the five experiment pairs the
    # radiation eval scores (shard_ops.RF_PAIRS_*), half from random
    # experiment pairs (covers all 18 experiments and generic forcings).
    npairs = args.batch_pairs
    pair_idx = jnp.stack(
        [jnp.arange(npairs), jnp.arange(npairs) + npairs], axis=1)

    def train_step(st, x, y):
        return step_inner(st, x, y, pair_idx)

    EVAL_PAIRS = np.array([(0, 1), (3, 0), (3, 1), (0, 10), (0, 9)])
    nexp, nsites = data.nexp, data.nsites

    rng = np.random.default_rng(0)
    xs_j, ys_j = jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32)

    def data_iter():
        site = rng.integers(0, nsites, npairs)
        lay = rng.integers(0, nlay, npairs)
        n_eval = npairs // 2
        ab = EVAL_PAIRS[rng.integers(0, len(EVAL_PAIRS), n_eval)]
        ra = rng.integers(0, nexp, npairs - n_eval)
        rb = (ra + rng.integers(1, nexp, npairs - n_eval)) % nexp
        ea = np.concatenate([ab[:, 0], ra])
        eb = np.concatenate([ab[:, 1], rb])
        rows_a = (ea * nsites + site) * nlay + lay
        rows_b = (eb * nsites + site) * nlay + lay
        idx = np.concatenate([rows_a, rows_b])
        return xs_j[idx], ys_j[idx]

    emis = jnp.broadcast_to(jnp.asarray(data.sfc_emis, jnp.float32)[:, None], (ncol, 16))
    x_full = jnp.asarray(xs.reshape(ncol, nlay, 18), jnp.float32)

    @jax.jit
    def flux_of(model):
        tau, pfrac = predict_nn_lw([model], x_full, col_dry)
        lay, lev, sfc, jacs = compute_planck_source_nn(
            pfrac, tlay, tlev, tsfc, spec, table, top_at_1=data.top_at_1)
        sources = SourceFuncLW(lay, lev, sfc, jacs, spec)
        sol = rte_lw(OpticalProps1scl(tau, spec), data.top_at_1, sources, emis, broadband=True)
        return sol.flux_up, sol.flux_dn

    def eval_fn(model):
        up, dn = flux_of(model)
        return eval_metrics(
            np.asarray(up), np.asarray(dn), ref_up, ref_dn,
            np.asarray(data.plev, np.float64), data.nexp, top_at_1=data.top_at_1,
        )

    # normalize by the published RRTMGP-vs-LBL error levels (BASELINE.md):
    # ~0.1 K/d heating rate, ~0.1-0.2 W/m2 flux/forcing biases
    ref_scores = np.array([0.1, 0.1, 0.2, 0.05, 0.05, 0.1, 0.02, 0.02])
    save_tmpl = os.path.join(args.out_dir, f"lw-g128-demo_both_{args.hidden}_{args.hidden}"
                             + "_HR_{hr}_FRC_{frc}.nc")
    result = train_with_radiation_eval(
        state, train_step, data_iter, eval_fn, ref_scores,
        n_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        patience=args.patience, save_path=save_tmpl,
    )
    print(f"best radiation score {result.best_score:.3f} at epoch {result.best_epoch}")
    m = result.history[result.best_epoch]["metrics"]
    print(f"vs teacher: HR MAE {m[0]:.4f} K/d, TOA bias {m[2]:.4f} W/m2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
