"""The complete reference training loop from LUT-GENERATED data.

Unlike scripts/train_demo.py (teacher distillation), this drives the full
gendata -> train -> radiation-eval pipeline the reference uses to create
its shipped models (rrtmgp_lw_gendata_rfmipstyle.F90:435-492 writes the
training netCDF; ml_train.py:188-495 trains with the tau->cross-section
->y^(1/8) scaling; rrtmgp_lw_eval_nn_rfmip.F90 scores radiation-in-the-
loop):

1. synthesize a LW k-distribution (gasoptics/synthetic.py -- the real
   RRTMGP kdist files are not shipped in this environment),
2. run the LUT gas optics + RTE over the full RFMIP ensemble and write
   the training file (training/gendata.py), read it back with the
   training loader,
3. train a fresh "lw_both" MLP (tau || planck_fraction) with the
   reference predictand scalings and the hybrid expdiff forcing loss,
4. evaluate each epoch by running the FULL RFMIP radiation against the
   LUT fluxes (8 reference metrics -> radiation score, early stopping),
5. save the best model in the reference netCDF format with the
   score-encoded filename (ml_train.py:493-517).

Run:  JAX_PLATFORMS=cpu python scripts/train_from_lut.py [--epochs N]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from rte_rrtmgp_nn_tpu.drivers.rfmip_io import read_rfmip
from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry, predict_nn_lw
from rte_rrtmgp_nn_tpu.gasoptics.planck import compute_planck_source_nn
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu.optical_props import OpticalProps1scl
from rte_rrtmgp_nn_tpu.rte import rte_lw
from rte_rrtmgp_nn_tpu.sources import SourceFuncLW
from rte_rrtmgp_nn_tpu.training.eval_loop import (
    eval_metrics,
    train_with_radiation_eval,
)
from rte_rrtmgp_nn_tpu.training.gendata import (
    generate_lw_training_data,
    load_training_data,
)
from rte_rrtmgp_nn_tpu.training.train import (
    TrainState,
    init_model,
    make_train_step,
    scale_outputs_tau,
    standardize_coeffs,
)

RFMIP = (
    "/root/reference/examples/rfmip-clear-sky/"
    "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc"
)
GASES = ("h2o", "co2", "o3", "n2o", "ch4")


def main() -> int:
    ap = argparse.ArgumentParser()
    # defaults = the recipe that reproduces the shipped score-0.314
    # artifact (PARITY.md; alpha 0.6 / short runs converge to worse
    # trade-offs -- the forcing-heavy alpha and long decay are both
    # load-bearing)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps-per-epoch", type=int, default=800)
    ap.add_argument("--alpha", type=float, default=0.85)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-pairs", type=int, default=1024)
    ap.add_argument("--patience", type=int, default=40)
    ap.add_argument("--ema", type=float, default=0.999,
                    help="Polyak EMA decay for eval/save (e.g. 0.999)")
    ap.add_argument("--gpts-per-band", type=int, default=4)
    ap.add_argument("--nband", type=int, default=16)
    ap.add_argument("--workdir", default=None,
                    help="where gendata files land (default: a tempdir)")
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(__file__), "..", "artifacts"))
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    workdir = args.workdir or tempfile.mkdtemp(prefix="lut_train_")
    os.makedirs(workdir, exist_ok=True)

    # -- 1. synthetic k-distribution + 2. gendata over the RFMIP ensemble --
    kdist_path = os.path.join(workdir, "kdist_lw_synth.nc")
    generate_kdist_nc(kdist_path, kind="lw",
                      gpts_per_band=args.gpts_per_band, nband=args.nband)
    kd = load_kdist(kdist_path, GASES)
    ngpt = kd.ngpt
    data = read_rfmip(RFMIP)
    ncol, nlay = data.play.shape

    train_nc = os.path.join(workdir, "lw_train_data.nc")
    print(f"gendata: LUT sweep over {ncol} cols x {nlay} layers "
          f"(ngpt={ngpt}) -> {train_nc}", flush=True)
    gen = generate_lw_training_data(train_nc, kd, data, gas_order=GASES)
    ref_up = gen["rsu"].reshape(ncol, nlay + 1)
    ref_dn = gen["rsd"].reshape(ncol, nlay + 1)

    # read the file BACK through the training loader (proves the on-disk
    # round trip the reference makes between its Fortran gendata and
    # Python trainer)
    x_un, y_raw, col_dry_flat = load_training_data(train_nc, "lw_both")
    tau_t, pfrac_t = y_raw[:, :ngpt], y_raw[:, ngpt:]

    # -- 3. reference predictand scalings ------------------------------
    # tau -> (tau/col_dry)^(1/8), per-gpt mean / global std; the pfrac
    # half trains on sqrt(pfrac) with identity standardization (inference
    # squares the raw output, nn_gas_optics.predict_nn_lw).
    ysig = np.asarray(scale_outputs_tau(jnp.asarray(tau_t),
                                        jnp.asarray(col_dry_flat)))
    ymean, ystd = standardize_coeffs(ysig)
    ys = np.concatenate(
        [(ysig - ymean) / ystd, np.sqrt(np.maximum(pfrac_t, 0.0))], axis=-1)
    xmin = x_un.min(axis=0)
    xmax = x_un.max(axis=0)
    xs = (x_un - xmin) / np.where(xmax > xmin, xmax - xmin, 1.0)

    nfeat = x_un.shape[-1]
    out_mean = np.concatenate([ymean, np.zeros(ngpt)]).astype(np.float32)
    out_std = np.concatenate([ystd, np.ones(ngpt)]).astype(np.float32)
    model = init_model(
        [nfeat, args.hidden, args.hidden, 2 * ngpt], jax.random.PRNGKey(0),
        input_names=("tlay", "play") + GASES,
        input_min=xmin, input_max=xmax,
        output_mean=out_mean, output_std=out_std,
    )

    import optax

    total_steps = args.epochs * args.steps_per_epoch
    optimizer = optax.adam(
        optax.cosine_decay_schedule(args.lr, total_steps, alpha=1e-2))
    state = TrainState(model, optimizer.init(model), jnp.zeros((), jnp.int32))
    step_inner = jax.jit(make_train_step(optimizer, alpha=args.alpha))

    npairs = args.batch_pairs
    pair_idx = jnp.stack(
        [jnp.arange(npairs), jnp.arange(npairs) + npairs], axis=1)

    def train_step(st, x, y):
        return step_inner(st, x, y, pair_idx)

    # paired-experiment sampling as in scripts/train_demo.py (half from
    # the five scored forcing pairs, half random)
    EVAL_PAIRS = np.array([(0, 1), (3, 0), (3, 1), (0, 10), (0, 9)])
    nexp, nsites = data.nexp, data.nsites
    rng = np.random.default_rng(0)
    xs_j = jnp.asarray(xs, jnp.float32)
    ys_j = jnp.asarray(ys, jnp.float32)

    def data_iter():
        site = rng.integers(0, nsites, npairs)
        lay = rng.integers(0, nlay, npairs)
        n_eval = npairs // 2
        # bias toward the N2O/CH4 single-gas pairs: their 0.02 W/m2 score
        # thresholds are the tightest of the 8 metrics
        ab = EVAL_PAIRS[rng.choice(len(EVAL_PAIRS), n_eval,
                                   p=[0.15, 0.15, 0.2, 0.25, 0.25])]
        ra = rng.integers(0, nexp, npairs - n_eval)
        rb = (ra + rng.integers(1, nexp, npairs - n_eval)) % nexp
        ea = np.concatenate([ab[:, 0], ra])
        eb = np.concatenate([ab[:, 1], rb])
        rows_a = (ea * nsites + site) * nlay + lay
        rows_b = (eb * nsites + site) * nlay + lay
        idx = np.concatenate([rows_a, rows_b])
        return xs_j[idx], ys_j[idx]

    # -- 4. radiation-in-the-loop eval vs the LUT's own fluxes ----------
    spec = kd.spectral
    table = kd.planck
    tlay = jnp.asarray(data.tlay, jnp.float32)
    tlev = jnp.asarray(data.tlev, jnp.float32)
    tsfc = jnp.asarray(data.tsfc, jnp.float32)
    col_dry = jnp.asarray(col_dry_flat.reshape(ncol, nlay), jnp.float32)
    emis = jnp.broadcast_to(
        jnp.asarray(data.sfc_emis, jnp.float32)[:, None], (ncol, kd.nband))
    x_full = jnp.asarray(xs.reshape(ncol, nlay, nfeat), jnp.float32)

    @jax.jit
    def flux_of(model):
        tau, pfrac = predict_nn_lw([model], x_full, col_dry)
        lay, lev, sfc, jacs = compute_planck_source_nn(
            pfrac, tlay, tlev, tsfc, spec, table, top_at_1=data.top_at_1)
        sources = SourceFuncLW(lay, lev, sfc, jacs, spec)
        sol = rte_lw(OpticalProps1scl(tau, spec), data.top_at_1, sources,
                     emis, broadband=True)
        return sol.flux_up, sol.flux_dn

    def eval_fn(model):
        up, dn = flux_of(model)
        return eval_metrics(
            np.asarray(up), np.asarray(dn), ref_up, ref_dn,
            np.asarray(data.plev, np.float64), data.nexp,
            top_at_1=data.top_at_1,
        )

    # normalize by the published RRTMGP-vs-LBL error levels (BASELINE.md)
    ref_scores = np.array([0.1, 0.1, 0.2, 0.05, 0.05, 0.1, 0.02, 0.02])
    save_tmpl = os.path.join(
        args.out_dir,
        f"lw-synth{ngpt}-lut_both_{args.hidden}_{args.hidden}"
        + "_HR_{hr}_FRC_{frc}.nc")
    result = train_with_radiation_eval(
        state, train_step, data_iter, eval_fn, ref_scores,
        n_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        patience=args.patience, save_path=save_tmpl, ema_decay=args.ema,
    )
    print(f"best radiation score {result.best_score:.3f} "
          f"at epoch {result.best_epoch}")
    m = result.history[result.best_epoch]["metrics"]
    print(f"vs LUT: HR MAE {m[0]:.4f} K/d, TOA bias {m[2]:.4f} W/m2")
    return 0 if result.best_score < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
