"""The complete reference SW training loop from LUT-GENERATED data.

SW counterpart of scripts/train_from_lut.py: the
reference generates SW training data and trains the sw_absorption and
sw_rayleigh models the same way as LW
(rrtmgp_sw_gendata_rfmipstyle.F90:1-635 writes tau_sw_gas/ssa_sw_gas +
fluxes; ml_train.py:188-195 derives the two predictands
tau_abs = tau*(1-ssa), tau_ray = tau*ssa and trains each to the
tau -> cross-section -> y^(1/8) scaling):

1. synthesize a SW k-distribution (gasoptics/synthetic.py -- the real
   RRTMGP kdist files are not shipped in this environment),
2. run the LUT gas optics + SW two-stream RTE over the full RFMIP
   ensemble and write the training file (training/gendata.py), read BOTH
   predictands back through the training loader,
3. train fresh sw_absorption + sw_rayleigh MLPs jointly (one batch, two
   losses -- the reference trains them as separate models; sharing the
   batch keeps one radiation eval honest for the pair) with the
   reference predictand scalings and the hybrid expdiff forcing loss,
4. evaluate each epoch by running the FULL RFMIP SW radiation with the
   model pair against the LUT's own fluxes, day-masked (night columns
   zeroed on both sides, rrtmgp_rfmip_sw.F90 usecol), 8 metrics ->
   radiation score, early stopping,
5. save both best models in the reference netCDF format with the
   score-encoded filename (ml_train.py:493-517).

Run:  JAX_PLATFORMS=cpu python scripts/train_from_lut_sw.py [--epochs N]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import NamedTuple

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from rte_rrtmgp_nn_tpu.drivers.rfmip_io import read_rfmip
from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry, predict_nn_sw
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu.models.network import save_model_netcdf
from rte_rrtmgp_nn_tpu.optical_props import OpticalProps2str
from rte_rrtmgp_nn_tpu.rte import rte_sw
from rte_rrtmgp_nn_tpu.training.eval_loop import (
    eval_metrics,
    train_with_radiation_eval,
)
from rte_rrtmgp_nn_tpu.training.gendata import (
    generate_sw_training_data,
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


class PairState(NamedTuple):
    """Two independent TrainStates presented as one to the shared
    radiation-eval loop: ``.model`` is the (abs, ray) model pair."""

    abs_state: TrainState
    ray_state: TrainState

    @property
    def model(self):
        return (self.abs_state.model, self.ray_state.model)


def main() -> int:
    ap = argparse.ArgumentParser()
    # defaults = the recipe behind the shipped score-0.063 artifact pair
    # (PARITY.md)
    ap.add_argument("--epochs", type=int, default=250)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps-per-epoch", type=int, default=400)
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-pairs", type=int, default=1024)
    ap.add_argument("--patience", type=int, default=40)
    ap.add_argument("--ema", type=float, default=0.999,
                    help="Polyak EMA decay for eval/save (e.g. 0.999)")
    ap.add_argument("--gpts-per-band", type=int, default=4)
    ap.add_argument("--nband", type=int, default=14)
    ap.add_argument("--workdir", default=None,
                    help="where gendata files land (default: a tempdir)")
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(__file__), "..", "artifacts"))
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    workdir = args.workdir or tempfile.mkdtemp(prefix="lut_train_sw_")
    os.makedirs(workdir, exist_ok=True)

    # -- 1. synthetic SW k-distribution + 2. gendata over RFMIP ----------
    kdist_path = os.path.join(workdir, "kdist_sw_synth.nc")
    generate_kdist_nc(kdist_path, kind="sw",
                      gpts_per_band=args.gpts_per_band, nband=args.nband)
    kd = load_kdist(kdist_path, GASES)
    ngpt = kd.ngpt
    data = read_rfmip(RFMIP)
    ncol, nlay = data.play.shape

    train_nc = os.path.join(workdir, "sw_train_data.nc")
    print(f"gendata: SW LUT sweep over {ncol} cols x {nlay} layers "
          f"(ngpt={ngpt}) -> {train_nc}", flush=True)
    gen = generate_sw_training_data(train_nc, kd, data, gas_order=GASES)
    ref_up = gen["rsu"].reshape(ncol, nlay + 1)
    ref_dn = gen["rsd"].reshape(ncol, nlay + 1)

    # read BOTH predictands back through the training loader (the on-disk
    # round trip between gendata and trainer, ml_train.py:188-195)
    x_un, y_abs, col_dry_flat = load_training_data(train_nc, "sw_absorption")
    _, y_ray, _ = load_training_data(train_nc, "sw_rayleigh")

    # -- 3. reference predictand scalings: (tau/col_dry)^(1/8), per-gpt
    # mean / global std, one scaling set per net --------------------------
    cdj = jnp.asarray(col_dry_flat)

    def scaled(y):
        ysig = np.asarray(scale_outputs_tau(jnp.asarray(y), cdj))
        ymean, ystd = standardize_coeffs(ysig)
        return (ysig - ymean) / ystd, ymean.astype(np.float32), ystd.astype(np.float32)

    ys_abs, mean_abs, std_abs = scaled(y_abs)
    ys_ray, mean_ray, std_ray = scaled(y_ray)
    xmin = x_un.min(axis=0)
    xmax = x_un.max(axis=0)
    xs = (x_un - xmin) / np.where(xmax > xmin, xmax - xmin, 1.0)

    nfeat = x_un.shape[-1]
    input_names = ("tlay", "play") + GASES

    def fresh(mean, std, key):
        return init_model(
            [nfeat, args.hidden, args.hidden, ngpt], jax.random.PRNGKey(key),
            input_names=input_names, input_min=xmin, input_max=xmax,
            output_mean=mean, output_std=std,
        )

    import optax

    total_steps = args.epochs * args.steps_per_epoch
    sched = optax.cosine_decay_schedule(args.lr, total_steps, alpha=1e-2)
    opt_abs, opt_ray = optax.adam(sched), optax.adam(sched)
    m_abs, m_ray = fresh(mean_abs, std_abs, 0), fresh(mean_ray, std_ray, 1)
    state = PairState(
        TrainState(m_abs, opt_abs.init(m_abs), jnp.zeros((), jnp.int32)),
        TrainState(m_ray, opt_ray.init(m_ray), jnp.zeros((), jnp.int32)),
    )
    step_abs = jax.jit(make_train_step(opt_abs, alpha=args.alpha))
    step_ray = jax.jit(make_train_step(opt_ray, alpha=args.alpha))

    npairs = args.batch_pairs
    pair_idx = jnp.stack(
        [jnp.arange(npairs), jnp.arange(npairs) + npairs], axis=1)

    def train_step(st, x, y):
        ya, yr = y
        sa, la = step_abs(st.abs_state, x, ya, pair_idx)
        sr, lr = step_ray(st.ray_state, x, yr, pair_idx)
        return PairState(sa, sr), la + lr

    # paired-experiment sampling as in train_from_lut.py
    EVAL_PAIRS = np.array([(0, 1), (3, 0), (3, 1), (0, 10), (0, 9)])
    nexp, nsites = data.nexp, data.nsites
    rng = np.random.default_rng(0)
    xs_j = jnp.asarray(xs, jnp.float32)
    ya_j = jnp.asarray(ys_abs, jnp.float32)
    yr_j = jnp.asarray(ys_ray, jnp.float32)

    def data_iter():
        site = rng.integers(0, nsites, npairs)
        lay = rng.integers(0, nlay, npairs)
        n_eval = npairs // 2
        ab = EVAL_PAIRS[rng.choice(len(EVAL_PAIRS), n_eval,
                                   p=[0.15, 0.15, 0.2, 0.25, 0.25])]
        ra = rng.integers(0, nexp, npairs - n_eval)
        rb = (ra + rng.integers(1, nexp, npairs - n_eval)) % nexp
        ea = np.concatenate([ab[:, 0], ra])
        eb = np.concatenate([ab[:, 1], rb])
        rows_a = (ea * nsites + site) * nlay + lay
        rows_b = (eb * nsites + site) * nlay + lay
        idx = np.concatenate([rows_a, rows_b])
        return xs_j[idx], (ya_j[idx], yr_j[idx])

    # -- 4. day-masked radiation-in-the-loop eval vs the LUT fluxes ------
    # Boundary conditions IDENTICAL to the gendata sweep (gendata.py
    # generate_sw_training_data: mu0 clipped to 0.01, band albedo expanded,
    # NRLSSI2 solar source); night columns (sza >= 90) are masked out of
    # the metrics on BOTH sides (reference usecol, rrtmgp_rfmip_sw.F90).
    col_dry = jnp.asarray(col_dry_flat.reshape(ncol, nlay), jnp.float32)
    mu0 = jnp.asarray(np.clip(np.cos(np.deg2rad(data.sza)), 0.01, 1.0),
                      jnp.float32)
    solar = kd.solar_source()
    toa = jnp.broadcast_to(jnp.asarray(solar, jnp.float32)[None, :],
                           (ncol, ngpt))
    alb = jnp.asarray(data.sfc_alb, jnp.float32)[:, None] * jnp.ones(
        (1, ngpt), jnp.float32)
    x_full = jnp.asarray(xs.reshape(ncol, nlay, nfeat), jnp.float32)
    usecol = np.asarray(data.sza < 90.0)[:, None]

    @jax.jit
    def flux_of(models):
        tau, ssa = predict_nn_sw(list(models), x_full, col_dry)
        atmos = OpticalProps2str(tau, ssa, jnp.zeros_like(tau), kd.spectral)
        sol = rte_sw(atmos, data.top_at_1, mu0, toa, alb, alb,
                     broadband=True)
        return sol.flux_up, sol.flux_dn

    ref_up_m = ref_up * usecol
    ref_dn_m = ref_dn * usecol

    def eval_fn(models):
        up, dn = flux_of(models)
        return eval_metrics(
            np.asarray(up) * usecol, np.asarray(dn) * usecol,
            ref_up_m, ref_dn_m,
            np.asarray(data.plev, np.float64), data.nexp,
            top_at_1=data.top_at_1,
        )

    # normalized by the published RRTMGP-vs-LBL error levels (BASELINE.md)
    ref_scores = np.array([0.1, 0.1, 0.2, 0.05, 0.05, 0.1, 0.02, 0.02])
    result = train_with_radiation_eval(
        state, train_step, data_iter, eval_fn, ref_scores,
        n_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        patience=args.patience, save_path=None, ema_decay=args.ema,
    )
    print(f"best radiation score {result.best_score:.3f} "
          f"at epoch {result.best_epoch}")
    m = result.history[result.best_epoch]["metrics"]
    print(f"vs LUT: HR MAE {m[0]:.4f} K/d, TOA bias {m[2]:.4f} W/m2")

    # -- 5. save both models, score-encoded filenames + the full metric
    # vector as global attributes (self-describing artifacts) -------------
    from rte_rrtmgp_nn_tpu.training.eval_loop import provenance_attrs

    hr_rel = m[0] / max(abs(ref_scores[0]), 1e-12)
    frc_rel = max(abs(v) / max(abs(r), 1e-12)
                  for v, r in zip(m[3:], ref_scores[3:]))
    attrs = provenance_attrs(result, ref_scores)
    best_abs, best_ray = result.best_model
    for tag, mdl in (("absorption", best_abs), ("rayleigh", best_ray)):
        path = os.path.join(
            args.out_dir,
            f"sw-synth{ngpt}-lut_{tag}_{args.hidden}_{args.hidden}"
            f"_HR_{hr_rel:.2e}_FRC_{frc_rel:.2e}.nc")
        save_model_netcdf(path, mdl, attrs=attrs)
        print(f"saved {tag} model to {path}")
    return 0 if result.best_score < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
