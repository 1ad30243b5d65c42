"""Explicit per-device SPMD via shard_map + distributed metric reductions.

Most of the framework scales through the compiler path: NamedSharding
inputs under jit, with XLA/GSPMD inserting collectives (parallel/
sharding.py). This module is the explicit counterpart -- `shard_map`
bodies where the per-device program and its collectives are written out
by hand. Two uses:

  - guaranteed-local column solves: columns are halo-free, so running the
    solver inside shard_map over 'col' provably never inserts a
    cross-device collective in the hot loop (GSPMD usually gets this
    right; shard_map makes it a property of the program, not a compiler
    outcome);
  - distributed flux statistics: the metric reductions the reference
    computes serially on the host after unblocking
    (rrtmgp_rfmip_lw.F90 accuracy summaries) become psum/pmin/pmax trees
    over the mesh, so diagnostics never gather full flux fields to one
    host.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map


def columnwise_shard_map(mesh: Mesh, fn: Callable, n_array_args: int):
    """Wrap a column-batched function so each device runs it on its local
    column shard only (no collectives possible inside).

    fn: pure function of ``n_array_args`` column-leading arrays returning a
    pytree of column-leading arrays. All other closure state (models,
    tables, spectral metadata) must already be baked into ``fn``.
    """
    spec = P("col")
    in_specs = (spec,) * n_array_args

    def body(*args):
        return fn(*args)

    return shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=spec, check_vma=False
    )


def flux_stats(mesh: Mesh, flux: jnp.ndarray):
    """Global (mean, min, max) of a 'col'-sharded flux array without
    gathering it: per-device partial reductions + psum/pmin/pmax over the
    mesh. Returns replicated scalars.

    The shard_map body sees the local (ncol_local, ...) block; the
    collectives ride NVLink. Equivalent of the reference's host-side summary
    statistics (e.g. the mean-flux prints, rrtmgp_rfmip_lw.F90:479-487)
    at mesh scale.
    """

    def body(x):
        n_local = jnp.asarray(x.size, jnp.float32)
        s = jnp.sum(x, dtype=jnp.float32)
        lo = jnp.min(x)
        hi = jnp.max(x)
        total = jax.lax.psum(s, "col")
        count = jax.lax.psum(n_local, "col")
        lo = jax.lax.pmin(lo, "col")
        hi = jax.lax.pmax(hi, "col")
        return total / count, lo, hi

    return shard_map(
        body,
        mesh=mesh,
        in_specs=P("col"),
        out_specs=P(),
    )(flux)


# Experiment pairs for the RFMIP forcing metrics (0-based indices into the
# experiment axis; reference rrtmgp_lw_eval_nn_rfmip.F90:452-577 uses
# 1-based iref/iexp (1,2), (4,1), (4,2), (1,11), (1,10)).
RF_PAIRS_TOA = ((0, 1), (3, 0))
RF_PAIRS_SFC = ((3, 1), (0, 10), (0, 9))


def rfmip_eval_metrics_core(
    flux_up, flux_dn, ref_up, ref_dn, plev,
    top_at_1: bool = True,
    axis_name: str | None = None,
):
    """The reference eval driver's 8 scalar error metrics as one jittable
    device-side reduction -- THE single numerics source shared by the
    single-chip eval loop (training/eval_loop.eval_metrics) and the
    distributed path (rfmip_eval_metrics_sharded below).

    Arrays are (nexp, nsites, nlev) -- experiment-major, so that sharding
    the SITES axis keeps every forcing pair local to each device and the
    whole thing reduces with plain psums (a flat-column sharding would need
    a cross-device gather to index experiment pairs). With ``axis_name``
    the partial sums are psum-reduced over that mesh axis.

    Metrics (reference rrtmgp_lw_eval_nn_rfmip.F90:452-577): pressure-
    weighted heating-rate MAE (all experiments / present-day), TOA
    upwelling bias, two TOA forcing biases, three surface forcing biases.
    Pairs missing from a smaller experiment axis contribute 0.
    """
    nexp = flux_up.shape[0]
    toa = 0 if top_at_1 else -1
    sfc = -1 if top_at_1 else 0

    # heating rate [K/day] (extensions/heating_rates.py formula, batched)
    from ..constants import constants

    def hr_kday(up, dn):
        net = dn - up
        dnet = net[..., 1:] - net[..., :-1]
        dp = plev[..., 1:] - plev[..., :-1]
        return constants.grav / constants.cp_dry * dnet / dp * 86400.0

    def gmean(x):
        s = jnp.sum(x, dtype=jnp.float32)
        n = jnp.asarray(x.size, jnp.float32)
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
            n = jax.lax.psum(n, axis_name)
        return s / n

    hr = hr_kday(flux_up, flux_dn)
    hr_ref = hr_kday(ref_up, ref_dn)
    dp = jnp.abs(plev[..., 1:] - plev[..., :-1])
    w = dp / jnp.sum(dp, axis=-1, keepdims=True)
    wmae = jnp.sum(w * jnp.abs(hr - hr_ref), axis=-1)  # (nexp, nsites)

    m0 = gmean(wmae)
    m1 = gmean(wmae[0])
    m2 = gmean(flux_up[..., toa] - ref_up[..., toa])

    def rf_toa(iref, iexp):
        if max(iref, iexp) >= nexp:
            return jnp.float32(0.0)
        cand = -(gmean(flux_up[iexp, :, toa]) - gmean(flux_up[iref, :, toa]))
        ref = -(gmean(ref_up[iexp, :, toa]) - gmean(ref_up[iref, :, toa]))
        return ref - cand

    def rf_sfc(iref, iexp):
        if max(iref, iexp) >= nexp:
            return jnp.float32(0.0)
        cand = gmean(flux_dn[iref, :, sfc]) - gmean(flux_dn[iexp, :, sfc])
        ref = gmean(ref_dn[iref, :, sfc]) - gmean(ref_dn[iexp, :, sfc])
        return ref - cand

    return jnp.stack([
        m0, m1, m2,
        rf_toa(*RF_PAIRS_TOA[0]), rf_toa(*RF_PAIRS_TOA[1]),
        rf_sfc(*RF_PAIRS_SFC[0]), rf_sfc(*RF_PAIRS_SFC[1]),
        rf_sfc(*RF_PAIRS_SFC[2]),
    ])


def rfmip_eval_metrics_sharded(
    mesh: Mesh, flux_up, flux_dn, ref_up, ref_dn, plev,
    top_at_1: bool = True,
):
    """Distributed 8-metric evaluation: (nexp, nsites, nlev) arrays with
    SITES sharded over 'col'; every device reduces its local site block
    through the shared core and the psums ride NVLink. Returns the replicated
    8-vector -- numerically the single-chip eval_loop.eval_metrics result
    (same core, f32 psum tree vs one-device sum)."""
    import functools

    body = functools.partial(
        rfmip_eval_metrics_core, top_at_1=top_at_1, axis_name="col")
    spec = P(None, "col", None)
    return shard_map(
        body, mesh=mesh, in_specs=(spec,) * 5, out_specs=P(),
        check_vma=False,
    )(flux_up, flux_dn, ref_up, ref_dn, plev)


def weighted_error_stats(mesh: Mesh, flux: jnp.ndarray, ref: jnp.ndarray):
    """Distributed (MAE, RMSE, max-abs-err) between a computed and a
    reference flux field, both 'col'-sharded. The distributed form of the
    eval-loop accuracy metrics (training/eval_loop.py METRIC_NAMES)."""

    def body(x, r):
        d = (x - r).astype(jnp.float32)
        n = jnp.asarray(d.size, jnp.float32)
        sae = jnp.sum(jnp.abs(d))
        sse = jnp.sum(d * d)
        mx = jnp.max(jnp.abs(d))
        n = jax.lax.psum(n, "col")
        sae = jax.lax.psum(sae, "col")
        sse = jax.lax.psum(sse, "col")
        mx = jax.lax.pmax(mx, "col")
        return sae / n, jnp.sqrt(sse / n), mx

    return shard_map(
        body, mesh=mesh, in_specs=(P("col"), P("col")), out_specs=P(),
    )(flux, ref)
