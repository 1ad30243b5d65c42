"""RFMIP clear-sky drivers: the flagship end-to-end paths.

Reference parity: ``examples/rfmip-clear-sky/rrtmgp_rfmip_lw.F90`` and
``rrtmgp_rfmip_sw.F90`` -- block loop over columns calling NN (or LUT) gas
optics then the RTE solver; SW adds TSI renormalization of the TOA source
(:407-427), night-column masking via sza >= 90 deg (:283-288, zeroed after
the solve :455-459), and band-albedo expansion to g-points.

Design: one jitted function over the whole (sharded) column batch replaces
the OpenMP block loop; blocks become shards of the column axis. Each band
has one staged core (NN gas optics -> Planck sources -> broadband sweeps),
jitted once at module level with the models and tables as arguments, so
repeated calls at one shape reuse the compiled program.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fluxes import FluxesBroadband
from ..gas_concs import GasConcs
from ..gasoptics.nn_gas_optics import gas_optics_lw_nn, gas_optics_sw_nn
from ..gasoptics.planck import (
    PlanckTable,
    lw_spectral_g128,
    sw_spectral_g112,
    planck_band_radiance,
)
from ..models.network import NNModel
from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..rte import rte_lw, rte_sw
from ..spectral import SpectralMapping
from .rfmip_io import RFMIPData


def default_solar_source(spectral: SpectralMapping, tsi: float = 1360.85) -> np.ndarray:
    """Per-g-point TOA solar flux [W/m2] summing to ``tsi``.

    Without the k-distribution file's NRLSSI2 terms, the TSI is distributed
    across bands with the brightness-temperature solar spectrum
    (gasoptics.planck.solar_band_fractions) and within bands by the
    g-point quadrature weights (canonical for g-224, calibrated for g-112).
    Validated against the reference's all-sky SW smoke values to <0.5%.
    When a k-distribution file is available its ``solar_source_quiet`` +
    facular/sunspot terms are used instead (gasoptics/kdist.py).
    """
    from ..gasoptics.planck import gpt_weights_for, solar_band_fractions

    frac = solar_band_fractions(spectral.band_lims_wvn_array)
    w = gpt_weights_for(spectral)
    out = np.zeros(spectral.ngpt)
    for ib, (s, e) in enumerate(spectral.band_lims_gpt):
        out[s:e] = tsi * frac[ib] * w[s:e]
    return out


def resolve_solar_source(
    spectral: SpectralMapping,
    kdist=None,
    tsi: Optional[float] = None,
    mg_index: Optional[float] = None,
    sb_index: Optional[float] = None,
) -> np.ndarray:
    """Per-g-point TOA solar flux, preferring the k-distribution's NRLSSI2
    terms whenever a kdist carrying them is supplied (reference
    mo_gas_optics_rrtmgp.F90:594-599; variability :1058-1095).

    Three tiers:
      1. kdist g-points match ``spectral``: use ``kdist.solar_source()``
         directly (the reference behavior).
      2. kdist bands match but g-point counts differ (e.g. the unreduced
         g-224 file driving the reduced g-112 NN models): conserve the
         NRLSSI2 per-band totals and distribute within each band by the
         spectral mapping's quadrature weights (canonical g-224 weights /
         calibrated g-112 weights, gasoptics.planck.gpt_weights_for).
      3. no kdist: brightness-temperature band fractions
         (``default_solar_source``).
    """
    if kdist is None or getattr(kdist, "solar_quiet", None) is None:
        return default_solar_source(spectral, tsi=tsi or 1360.85)
    src = np.asarray(kdist.solar_source(mg_index, sb_index, tsi=tsi))
    if kdist.ngpt == spectral.ngpt:
        return src
    kb = np.asarray(kdist.spectral.band_lims_wvn_array, dtype=float)
    sb = np.asarray(spectral.band_lims_wvn_array, dtype=float)
    if kdist.nband != spectral.nband or not np.allclose(kb, sb, rtol=5e-2):
        raise ValueError(
            "kdist solar source cannot be remapped: band structure differs "
            f"from the requested spectral mapping ({kdist.nband} vs "
            f"{spectral.nband} bands)"
        )
    from ..gasoptics.planck import gpt_weights_for

    w = gpt_weights_for(spectral)
    out = np.zeros(spectral.ngpt)
    for ib, (s, e) in enumerate(spectral.band_lims_gpt):
        ks, ke = kdist.spectral.band_lims_gpt[ib]
        band_total = float(np.sum(src[ks:ke]))
        out[s:e] = band_total * w[s:e] / np.sum(w[s:e])
    return out


def _lw_core(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play, plev, tlay, tlev, tsfc, sfc_emis_band, concs_dict,
    top_at_1: bool,
    n_gauss_angles: int,
    scan_mode: str,
):
    gas_desc = GasConcs(concs_dict)
    tau, sources = gas_optics_lw_nn(
        models, play, plev, tlay, tsfc, gas_desc, spectral, planck_table,
        tlev=tlev, top_at_1=top_at_1,
    )
    optical_props = OpticalProps1scl(tau, spectral)
    sol = rte_lw(
        optical_props, top_at_1, sources, sfc_emis_band,
        n_gauss_angles=n_gauss_angles, scan_mode=scan_mode, broadband=True,
    )
    return FluxesBroadband(
        flux_up=sol.flux_up, flux_dn=sol.flux_dn, flux_net=sol.flux_dn - sol.flux_up
    )


def _lw_core_lay_major(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play, plev, tlay, tlev, tsfc, sfc_emis_band, concs_dict,
    top_at_1: bool,
    split_lev: bool = False,
    solver_variant: str = "presrc",
):
    """Layer-major LW core: the transpose-free fast path.

    The NN batch is packed (nlay, ncol) instead of (ncol, nlay), so every
    3-D product (tau, pfrac, Planck sources) comes out directly in the
    (nlay, ncol, ngpt) layout the lax.scan solver consumes -- the
    column-major path instead materializes transposed copies of three
    ~50 MB fields per call. Only 2-D fields are transposed (trivial).
    Single Gauss angle, broadband output; numerics identical to _lw_core.
    """
    from ..gasoptics.nn_gas_optics import (
        compute_nn_inputs,
        get_col_dry,
        predict_nn_lw,
    )
    from ..gasoptics.planck import compute_planck_source_nn
    from ..ops.lw_solver import lw_solver_noscat_lay_major

    gas_desc = GasConcs(concs_dict)
    ncol, nlay = play.shape

    # canonicalize to top-at-index-0 by flipping the (cheap) 2-D fields
    if not top_at_1:
        play, tlay = play[:, ::-1], tlay[:, ::-1]
        plev, tlev = plev[:, ::-1], tlev[:, ::-1]

    col_dry_t = get_col_dry(
        (gas_desc.get_vmr("h2o", ncol, nlay)[:, ::-1] if not top_at_1
         else gas_desc.get_vmr("h2o", ncol, nlay)),
        plev,
    ).T  # (nlay, ncol)

    # gases broadcast to 2-D then transposed (all small relative to 3-D)
    concs_t = {}
    for name, v in gas_desc.concs.items():
        full = gas_desc.get_vmr(name, ncol, nlay)
        if not top_at_1:
            full = full[:, ::-1]
        concs_t[name] = full.T
    gd_t = GasConcs(concs_t)

    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])  # (nlay, ncol, nf)
    tau, pfrac = predict_nn_lw(models, x, col_dry_t)
    lay_src, lev_src, sfc_src, _ = compute_planck_source_nn(
        pfrac, tlay.T, tlev.T, tsfc, spectral, planck_table,
        top_at_1=True, lay_axis=0, split_lev=split_lev,
    )
    emis = spectral.expand(sfc_emis_band)
    sol = lw_solver_noscat_lay_major(
        tau, lay_src, lev_src, emis, sfc_src, variant=solver_variant
    )
    up, dn = sol.flux_up, sol.flux_dn
    if not top_at_1:
        up, dn = up[:, ::-1], dn[:, ::-1]
    return FluxesBroadband(flux_up=up, flux_dn=dn, flux_net=dn - up)


_lw_core_jit = jax.jit(
    _lw_core, static_argnames=("spectral", "top_at_1", "n_gauss_angles",
                               "scan_mode"))
_lw_core_lay_major_jit = jax.jit(
    _lw_core_lay_major, static_argnames=("spectral", "top_at_1"))


def rfmip_clear_sky_lw(
    data: RFMIPData,
    models: Sequence[NNModel],
    spectral: Optional[SpectralMapping] = None,
    planck_table: Optional[PlanckTable] = None,
    n_gauss_angles: int = 1,
    scan_mode: str = "sequential",
    dtype=jnp.float32,
) -> FluxesBroadband:
    """End-to-end LW clear-sky flux computation with NN gas optics
    (reference rrtmgp_rfmip_lw.F90 main loop, :368-446).

    The single-angle sequential configuration runs the staged layer-major
    core; multi-angle or parallel-scan requests use the general
    column-major core."""
    spectral = spectral or lw_spectral_g128()
    planck_table = planck_table or PlanckTable.compute(spectral.band_lims_wvn_array, dtype=dtype)

    sfc_emis_band = jnp.broadcast_to(
        jnp.asarray(data.sfc_emis, dtype)[:, None], (data.ncol, spectral.nband)
    )
    args = (
        list(models), planck_table, spectral,
        jnp.asarray(data.play, dtype),
        jnp.asarray(data.plev, dtype),
        jnp.asarray(data.tlay, dtype),
        jnp.asarray(data.tlev, dtype),
        jnp.asarray(data.tsfc, dtype),
        sfc_emis_band,
        {k: jnp.asarray(v, dtype) for k, v in data.gas_concs.concs.items()},
    )
    if n_gauss_angles == 1 and scan_mode == "sequential":
        return _lw_core_lay_major_jit(*args, top_at_1=data.top_at_1)
    return _lw_core_jit(*args, top_at_1=data.top_at_1,
                        n_gauss_angles=n_gauss_angles, scan_mode=scan_mode)


def _sw_core(
    models: Sequence[NNModel],
    spectral: SpectralMapping,
    solar_source,
    play, plev, tlay, sfc_alb, mu0, usecol, tsi, concs_dict,
    top_at_1: bool,
    scan_mode: str,
):
    gas_desc = GasConcs(concs_dict)
    tau, ssa, toa_src = gas_optics_sw_nn(
        models, play, plev, tlay, gas_desc, spectral, solar_source
    )
    # TSI renormalization (reference rrtmgp_rfmip_sw.F90:407-427).
    toa_src = toa_src * (tsi / jnp.sum(toa_src, axis=-1))[:, None]
    g = jnp.zeros_like(tau)  # NN SW path: asymmetry zero (:542-569)
    optical_props = OpticalProps2str(tau, ssa, g, spectral)
    # albedo already per g-point: expand band-less (single) albedo
    alb_gpt = sfc_alb[:, None] * jnp.ones_like(toa_src)
    mu0_safe = jnp.where(usecol, mu0, 1.0)
    sol = rte_sw(
        optical_props, top_at_1, mu0_safe, toa_src, alb_gpt, alb_gpt,
        scan_mode=scan_mode, broadband=True,
    )
    # Night columns: zero fluxes (reference :455-459).
    mask = usecol[:, None]
    return FluxesBroadband(
        flux_up=jnp.where(mask, sol.flux_up, 0.0),
        flux_dn=jnp.where(mask, sol.flux_dn, 0.0),
        flux_net=jnp.where(mask, sol.flux_dn - sol.flux_up, 0.0),
        flux_dn_dir=jnp.where(mask, sol.flux_dn_dir, 0.0),
    )


def _sw_core_lay_major(
    models: Sequence[NNModel],
    spectral: SpectralMapping,
    solar_source,
    play, plev, tlay, sfc_alb, mu0, usecol, tsi, concs_dict,
    top_at_1: bool,
):
    """Layer-major SW core: the transpose-free fast path (see
    _lw_core_lay_major; numerics identical to _sw_core)."""
    from ..gasoptics.nn_gas_optics import (
        compute_nn_inputs,
        get_col_dry,
        predict_nn_sw,
    )
    from ..ops.sw_solver import sw_solver_2stream_lay_major

    gas_desc = GasConcs(concs_dict)
    ncol, nlay = play.shape

    if not top_at_1:
        play, tlay, plev = play[:, ::-1], tlay[:, ::-1], plev[:, ::-1]

    h2o = gas_desc.get_vmr("h2o", ncol, nlay)
    if not top_at_1:
        h2o = h2o[:, ::-1]
    col_dry_t = get_col_dry(h2o, plev).T

    concs_t = {}
    for name in gas_desc.concs:
        full = gas_desc.get_vmr(name, ncol, nlay)
        if not top_at_1:
            full = full[:, ::-1]
        concs_t[name] = full.T
    gd_t = GasConcs(concs_t)

    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])
    tau, ssa = predict_nn_sw(models, x, col_dry_t)  # (nlay, ncol, ngpt)
    toa_src = jnp.broadcast_to(solar_source[None, :], (ncol, spectral.ngpt))
    # TSI renormalization (reference rrtmgp_rfmip_sw.F90:407-427).
    toa_src = toa_src * (tsi / jnp.sum(toa_src, axis=-1))[:, None]
    g = jnp.zeros_like(tau)  # NN SW path: asymmetry zero (:542-569)
    alb_gpt = sfc_alb[:, None] * jnp.ones_like(toa_src)
    mu0_safe = jnp.where(usecol, mu0, 1.0)
    sol = sw_solver_2stream_lay_major(tau, ssa, g, mu0_safe, toa_src, alb_gpt, alb_gpt)
    up, dn, dn_dir = sol.flux_up, sol.flux_dn, sol.flux_dn_dir
    if not top_at_1:
        up, dn, dn_dir = up[:, ::-1], dn[:, ::-1], dn_dir[:, ::-1]
    mask = usecol[:, None]
    return FluxesBroadband(
        flux_up=jnp.where(mask, up, 0.0),
        flux_dn=jnp.where(mask, dn, 0.0),
        flux_net=jnp.where(mask, dn - up, 0.0),
        flux_dn_dir=jnp.where(mask, dn_dir, 0.0),
    )


_sw_core_jit = jax.jit(
    _sw_core, static_argnames=("spectral", "top_at_1", "scan_mode"))
_sw_core_lay_major_jit = jax.jit(
    _sw_core_lay_major, static_argnames=("spectral", "top_at_1"))


def rfmip_clear_sky_sw(
    data: RFMIPData,
    models: Sequence[NNModel],
    spectral: Optional[SpectralMapping] = None,
    solar_source: Optional[np.ndarray] = None,
    kdist=None,
    scan_mode: str = "sequential",
    dtype=jnp.float32,
) -> FluxesBroadband:
    """End-to-end SW clear-sky flux computation with NN gas optics
    (reference rrtmgp_rfmip_sw.F90). When a k-distribution carrying NRLSSI2
    solar terms is supplied, the TOA source uses it (resolve_solar_source);
    otherwise the brightness-temperature approximation."""
    spectral = spectral or sw_spectral_g112()
    if solar_source is None:
        solar_source = resolve_solar_source(spectral, kdist)

    mu0 = np.cos(np.deg2rad(data.sza))
    usecol = data.sza < 90.0 - 0.5 * np.finfo(np.float32).eps  # day columns

    args = (
        list(models), spectral, jnp.asarray(solar_source, dtype),
        jnp.asarray(data.play, dtype),
        jnp.asarray(data.plev, dtype),
        jnp.asarray(data.tlay, dtype),
        jnp.asarray(data.sfc_alb, dtype),
        jnp.asarray(mu0, dtype),
        jnp.asarray(usecol),
        jnp.asarray(data.tsi, dtype),
        {k: jnp.asarray(v, dtype) for k, v in data.gas_concs.concs.items()},
    )
    if scan_mode == "sequential":
        return _sw_core_lay_major_jit(*args, top_at_1=data.top_at_1)
    return _sw_core_jit(*args, top_at_1=data.top_at_1, scan_mode=scan_mode)


def _conc_specs(concs):
    """shard_map specs for a gas dict: (ncol, nlay) fields split over
    'col', scalars and per-layer profiles replicated."""
    from jax.sharding import PartitionSpec as P

    return {k: (P("col") if getattr(v, "ndim", 0) == 2 else P())
            for k, v in concs.items()}


def lw_core_sharded(mesh, models, planck_table, spectral, top_at_1):
    """The staged LW core under ``shard_map`` over the mesh's 'col' axis:
    each device solves its own column shard (columns are halo-free, so the
    program holds no collective). Returns a jittable ``fn(play, plev,
    tlay, tlev, tsfc, emis_band, concs) -> (flux_up, flux_dn)`` on
    column-leading inputs whose column count the 'col' axis divides
    (pad with parallel.sharding.pad_to_multiple)."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.shard_ops import shard_map

    col = P("col")

    def body(play, plev, tlay, tlev, tsfc, emis, concs):
        fb = _lw_core_lay_major(models, planck_table, spectral, play, plev,
                                tlay, tlev, tsfc, emis, concs,
                                top_at_1=top_at_1)
        return fb.flux_up, fb.flux_dn

    def wrapped(play, plev, tlay, tlev, tsfc, emis, concs):
        return shard_map(
            body, mesh=mesh,
            in_specs=(col,) * 6 + (_conc_specs(concs),),
            out_specs=(col, col), check_vma=False,
        )(play, plev, tlay, tlev, tsfc, emis, concs)

    return wrapped


def sw_core_sharded(mesh, models, spectral, solar_source, top_at_1):
    """The staged SW core under ``shard_map`` over 'col' (see
    lw_core_sharded). Returns a jittable ``fn(play, plev, tlay, sfc_alb,
    mu0, usecol, tsi, concs) -> (flux_up, flux_dn, flux_dn_dir)``."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.shard_ops import shard_map

    col = P("col")

    def body(play, plev, tlay, sfc_alb, mu0, usecol, tsi, concs):
        fb = _sw_core_lay_major(models, spectral, solar_source, play, plev,
                                tlay, sfc_alb, mu0, usecol, tsi, concs,
                                top_at_1=top_at_1)
        return fb.flux_up, fb.flux_dn, fb.flux_dn_dir

    def wrapped(play, plev, tlay, sfc_alb, mu0, usecol, tsi, concs):
        return shard_map(
            body, mesh=mesh,
            in_specs=(col,) * 7 + (_conc_specs(concs),),
            out_specs=(col, col, col), check_vma=False,
        )(play, plev, tlay, sfc_alb, mu0, usecol, tsi, concs)

    return wrapped
