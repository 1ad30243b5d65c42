"""All-sky (clouds + gases) example driver.

Reference parity: ``examples/all-sky/rrtmgp_allsky.F90`` -- Garand
atmosphere replicated to ncol columns; idealized cloud placement (clouds in
2/3 of columns, between 100 and 900 hPa, liquid where T > 263 K and ice
where T < 273 K, lwp = iwp = 10 g/m2, effective radii at the middle of the
valid range; :329-350); cloud optics -> (SW) delta-scale -> increment into
the gas optical props -> solver; ocean-ish SW albedo 0.06, mu0 = 0.86,
LW emissivity 0.98 (:280-304).

Gas optics here uses the NN path (the reference example uses the LUT path;
its k-distribution file is not shipped). Reference smoke values from the
LUT path (mean LW dn/up 144.14/269.76, SW dn/up 946.98/325.29;
rrtmgp_allsky.F90:479,487) remain the comparison target at NN accuracy.

The entry points take either file paths (the reference's Garand file and
cloud-optics coefficient files) or in-memory inputs (a ``GarandAtmosphere``
and a ``CloudOptics``, e.g. from ``drivers.seeded_inputs``), plus optional
cloud fields replacing the idealized placement.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..fluxes import FluxesBroadband, reduce_broadband
from ..gas_concs import GasConcs
from ..gasoptics.nn_gas_optics import gas_optics_lw_nn, gas_optics_sw_nn
from ..gasoptics.planck import PlanckTable, lw_spectral_g128, sw_spectral_g112
from ..models.network import NNModel
from ..optical_props import OpticalProps1scl, OpticalProps2str, delta_scale, increment
from ..rte import rte_lw, rte_sw
from ..spectral import SpectralMapping
from .allsky_io import GarandAtmosphere
from .allsky_io import read_garand
from .rfmip import default_solar_source, resolve_solar_source
from ..extensions.cloud_optics import CloudOptics, cloud_optics

# Idealized cloud-placement thresholds (reference rrtmgp_allsky.F90:329-350).
# Exported so the mixed-precision GCM packer can keep quantized play/tlay on
# the same side of each hard branch (drivers/gcm._pack_columns_mixed).
CLOUD_P_MIN = 100.0 * 100.0   # Pa
CLOUD_P_MAX = 900.0 * 100.0   # Pa
CLOUD_T_LIQ = 263.0           # K: liquid where tlay > this
CLOUD_T_ICE = 273.0           # K: ice where tlay < this


def make_clouds(play, tlay, co: CloudOptics, cloud_col=None):
    """Idealized cloud fields (reference rrtmgp_allsky.F90:329-350).

    Works on host numpy arrays or device (jit-traced) arrays. ``cloud_col``
    optionally supplies the per-column "2/3 of columns are cloudy" mask
    (truthy = may hold cloud); streamed drivers pass the GLOBAL-index mask
    so block decomposition does not change which columns are cloudy."""
    xp = jnp if isinstance(play, jax.Array) else np
    ncol, nlay = play.shape
    if cloud_col is None:
        icol = xp.arange(ncol)[:, None] + 1  # 1-based like the reference
        cloud_col = (icol % 3) != 0
    else:
        cloud_col = (cloud_col > 0.5)
        if cloud_col.ndim == 1:
            cloud_col = cloud_col[:, None]
    cloud_mask = (play > CLOUD_P_MIN) & (play < CLOUD_P_MAX) & cloud_col
    rel_val = 0.5 * (co.min_radius_liq + co.max_radius_liq)
    rei_val = 0.5 * (co.min_radius_ice + co.max_radius_ice)
    lwp = xp.where(cloud_mask & (tlay > CLOUD_T_LIQ), 10.0, 0.0)
    iwp = xp.where(cloud_mask & (tlay < CLOUD_T_ICE), 10.0, 0.0)
    rel = xp.where(lwp > 0.0, rel_val, 0.0)
    rei = xp.where(iwp > 0.0, rei_val, 0.0)
    return lwp, iwp, rel, rei


def _allsky_lw_core(
    models, table, spectral, cloud_co,
    play, plev, tlay, tlev, tsfc, emis_band, lwp, iwp, rel, rei, concs,
    top_at_1, n_gauss_angles, scan_mode,
):
    gas_desc = GasConcs(concs)
    tau, sources = gas_optics_lw_nn(
        models, play, plev, tlay, tsfc, gas_desc, spectral, table,
        tlev=tlev, top_at_1=top_at_1,
    )
    atmos = OpticalProps1scl(tau, spectral)
    clouds = cloud_optics(cloud_co, lwp, iwp, rel, rei, as_2str=False)
    atmos = increment(atmos, clouds)  # by-band broadcast add (1scl += 1scl)
    sol = rte_lw(atmos, top_at_1, sources, emis_band,
                 n_gauss_angles=n_gauss_angles, scan_mode=scan_mode)
    return reduce_broadband(sol.flux_up, sol.flux_dn)


def _allsky_sw_core(
    models, spectral, solar, cloud_co,
    play, plev, tlay, mu0, sfc_alb_dir, sfc_alb_dif, lwp, iwp, rel, rei, concs,
    top_at_1, scan_mode,
):
    gas_desc = GasConcs(concs)
    tau, ssa, toa_src = gas_optics_sw_nn(
        models, play, plev, tlay, gas_desc, spectral, solar
    )
    atmos = OpticalProps2str(tau, ssa, jnp.zeros_like(tau), spectral)
    clouds = cloud_optics(cloud_co, lwp, iwp, rel, rei, as_2str=True)
    clouds = delta_scale(clouds)  # reference: clouds%delta_scale() before increment
    atmos = increment(atmos, clouds)
    alb_dir = spectral.expand(sfc_alb_dir)
    alb_dif = spectral.expand(sfc_alb_dif)
    sol = rte_sw(atmos, top_at_1, mu0, toa_src, alb_dir, alb_dif, scan_mode=scan_mode)
    return reduce_broadband(sol.flux_up, sol.flux_dn, gpt_flux_dn_dir=sol.flux_dn_dir)


def _flip_all(top_at_1, *arrs):
    return arrs if top_at_1 else tuple(a[:, ::-1] for a in arrs)


def _allsky_lw_core_lay_major(
    models, table, spectral, cloud_co,
    play, plev, tlay, tlev, tsfc, emis_band, lwp, iwp, rel, rei, concs,
    top_at_1,
):
    """Layer-major all-sky LW core: the cloud absorption tau is expanded
    band->gpt (gather) and folded into the gas tau BEFORE the
    broadband solve, so the in-scan spectral reduction survives clouds
    (the generic path re-materializes gpt-resolved incremented props).
    Numerics identical to _allsky_lw_core (same increment formula:
    1scl += (1-ssa)*tau is trivial here since as_2str=False already
    returns absorption tau)."""
    from ..gasoptics.nn_gas_optics import (
        compute_nn_inputs,
        get_col_dry,
        predict_nn_lw,
    )
    from ..gasoptics.planck import compute_planck_source_nn
    from ..ops.lw_solver import lw_solver_noscat_lay_major

    gas_desc = GasConcs(concs)
    ncol, nlay = play.shape
    play, plev, tlay, tlev, lwp, iwp, rel, rei = _flip_all(
        top_at_1, play, plev, tlay, tlev, lwp, iwp, rel, rei)
    concs_t = {}
    for name in gas_desc.concs:
        full = gas_desc.get_vmr(name, ncol, nlay)
        if not top_at_1:
            full = full[:, ::-1]
        concs_t[name] = full.T
    gd_t = GasConcs(concs_t)

    col_dry_t = get_col_dry(gd_t.get_vmr("h2o", nlay, ncol).T, plev).T
    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])
    tau, pfrac = predict_nn_lw(models, x, col_dry_t)
    lay_src, lev_src, sfc_src, _ = compute_planck_source_nn(
        pfrac, tlay.T, tlev.T, tsfc, spectral, table,
        top_at_1=True, lay_axis=0,
    )
    cld = cloud_optics(cloud_co, lwp.T, iwp.T, rel.T, rei.T, as_2str=False)
    tau = tau + spectral.expand(cld.tau)
    emis = spectral.expand(emis_band)
    sol = lw_solver_noscat_lay_major(tau, lay_src, lev_src, emis, sfc_src)
    up, dn = sol.flux_up, sol.flux_dn
    if not top_at_1:
        up, dn = up[:, ::-1], dn[:, ::-1]
    return FluxesBroadband(flux_up=up, flux_dn=dn, flux_net=dn - up)


def _allsky_sw_core_lay_major(
    models, spectral, solar, cloud_co,
    play, plev, tlay, mu0, sfc_alb_dir, sfc_alb_dif, lwp, iwp, rel, rei,
    concs,
    top_at_1,
):
    """Layer-major all-sky SW core: delta-scaled cloud 2-stream props are
    combined with the (g=0) gas props analytically in the g-point domain
    before the broadband solve (inc_2stream_by_2stream_bybnd,
    mo_optical_props_kernels.F90:269-305, with tau_gas*0 asymmetry terms
    dropped). Numerics identical to _allsky_sw_core."""
    from ..gasoptics.nn_gas_optics import (
        compute_nn_inputs,
        get_col_dry,
        predict_nn_sw,
    )
    from ..ops.sw_solver import sw_solver_2stream_lay_major

    gas_desc = GasConcs(concs)
    ncol, nlay = play.shape
    play, plev, tlay, lwp, iwp, rel, rei = _flip_all(
        top_at_1, play, plev, tlay, lwp, iwp, rel, rei)
    concs_t = {}
    for name in gas_desc.concs:
        full = gas_desc.get_vmr(name, ncol, nlay)
        if not top_at_1:
            full = full[:, ::-1]
        concs_t[name] = full.T
    gd_t = GasConcs(concs_t)

    col_dry_t = get_col_dry(gd_t.get_vmr("h2o", nlay, ncol).T, plev).T
    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])
    tau, ssa = predict_nn_sw(models, x, col_dry_t)  # gas: g = 0

    cld = cloud_optics(cloud_co, lwp.T, iwp.T, rel.T, rei.T, as_2str=True)
    cld = delta_scale(cld)
    eps = jnp.finfo(tau.dtype).eps
    tau_c = spectral.expand(cld.tau)
    ssa_c = spectral.expand(cld.ssa)
    g_c = spectral.expand(cld.g)
    tau12 = tau + tau_c
    tauscat12 = tau * ssa + tau_c * ssa_c
    g12 = (tau_c * ssa_c * g_c) / jnp.maximum(eps, tauscat12)
    ssa12 = tauscat12 / jnp.maximum(eps, tau12)

    toa_src = jnp.broadcast_to(solar[None, :], (ncol, spectral.ngpt))
    alb_dir = spectral.expand(sfc_alb_dir)
    alb_dif = spectral.expand(sfc_alb_dif)
    sol = sw_solver_2stream_lay_major(
        tau12, ssa12, g12, mu0, toa_src, alb_dir, alb_dif)
    up, dn, dn_dir = sol.flux_up, sol.flux_dn, sol.flux_dn_dir
    if not top_at_1:
        up, dn, dn_dir = up[:, ::-1], dn[:, ::-1], dn_dir[:, ::-1]
    return FluxesBroadband(
        flux_up=up, flux_dn=dn, flux_net=dn - up, flux_dn_dir=dn_dir)


_allsky_lw_core_jit = jax.jit(
    _allsky_lw_core,
    static_argnames=("spectral", "top_at_1", "n_gauss_angles", "scan_mode"))
_allsky_lw_core_lay_major_jit = jax.jit(
    _allsky_lw_core_lay_major, static_argnames=("spectral", "top_at_1"))
_allsky_sw_core_jit = jax.jit(
    _allsky_sw_core, static_argnames=("spectral", "top_at_1", "scan_mode"))
_allsky_sw_core_lay_major_jit = jax.jit(
    _allsky_sw_core_lay_major, static_argnames=("spectral", "top_at_1"))


def _allsky_inputs(atmosphere, cloud_optics_src, ncol, clouds):
    """(GarandAtmosphere, CloudOptics, (lwp, iwp, rel, rei), top_at_1)
    from paths or in-memory inputs; clouds default to make_clouds."""
    if isinstance(atmosphere, str):
        atm = read_garand(atmosphere, ncol)
    else:
        atm = atmosphere
    if isinstance(cloud_optics_src, str):
        co = load_cloud_optics_checked(cloud_optics_src)
    else:
        co = cloud_optics_src
    if clouds is None:
        clouds = make_clouds(atm.play, atm.tlay, co)
    top_at_1 = bool(atm.play[0, 0] < atm.play[0, -1])
    return atm, co, clouds, top_at_1


def allsky_lw(
    atmosphere: Union[str, GarandAtmosphere],
    cloud_optics_src: Union[str, CloudOptics],
    models: Sequence[NNModel],
    ncol: int = 128,
    spectral: Optional[SpectralMapping] = None,
    n_gauss_angles: int = 1,
    scan_mode: str = "sequential",
    dtype=jnp.float32,
    clouds=None,
) -> FluxesBroadband:
    """Full all-sky LW run (reference rrtmgp_allsky LW branch).

    atmosphere: a Garand file path (tiled to ``ncol`` columns) or a
    ``GarandAtmosphere`` (``ncol`` is then its own); cloud_optics_src: a
    coefficient file path or a ``CloudOptics``; clouds: optional
    (lwp, iwp, rel, rei), default the idealized ``make_clouds``."""
    spectral = spectral or lw_spectral_g128()
    atm, co, (lwp, iwp, rel, rei), top_at_1 = _allsky_inputs(
        atmosphere, cloud_optics_src, ncol, clouds)
    ncol = atm.ncol
    table = PlanckTable.compute(spectral.band_lims_wvn_array, dtype=dtype)
    sfc_lev = -1 if top_at_1 else 0
    tsfc = atm.tlev[:, sfc_lev]
    emis = jnp.full((ncol, spectral.nband), 0.98, dtype)

    args = (
        list(models), table, spectral, co,
        jnp.asarray(atm.play, dtype), jnp.asarray(atm.plev, dtype),
        jnp.asarray(atm.tlay, dtype), jnp.asarray(atm.tlev, dtype),
        jnp.asarray(tsfc, dtype), emis,
        jnp.asarray(lwp, dtype), jnp.asarray(iwp, dtype),
        jnp.asarray(rel, dtype), jnp.asarray(rei, dtype),
        {k: jnp.asarray(v, dtype) for k, v in atm.gas_concs.concs.items()},
    )
    if n_gauss_angles == 1 and scan_mode == "sequential":
        return _allsky_lw_core_lay_major_jit(*args, top_at_1=top_at_1)
    return _allsky_lw_core_jit(*args, top_at_1=top_at_1,
                               n_gauss_angles=n_gauss_angles,
                               scan_mode=scan_mode)


def allsky_sw(
    atmosphere: Union[str, GarandAtmosphere],
    cloud_optics_src: Union[str, CloudOptics],
    models: Sequence[NNModel],
    ncol: int = 128,
    spectral: Optional[SpectralMapping] = None,
    kdist=None,
    solar_source: Optional[np.ndarray] = None,
    scan_mode: str = "sequential",
    dtype=jnp.float32,
    clouds=None,
) -> FluxesBroadband:
    """Full all-sky SW run (reference rrtmgp_allsky SW branch); inputs as
    for ``allsky_lw``. A supplied kdist's NRLSSI2 solar terms take
    precedence over the brightness-temperature approximation (see
    rfmip.resolve_solar_source)."""
    spectral = spectral or sw_spectral_g112()
    atm, co, (lwp, iwp, rel, rei), top_at_1 = _allsky_inputs(
        atmosphere, cloud_optics_src, ncol, clouds)
    ncol = atm.ncol
    if solar_source is None:
        solar_source = resolve_solar_source(spectral, kdist)
    solar = jnp.asarray(solar_source, dtype)
    mu0 = jnp.full((ncol,), 0.86, dtype)
    alb = jnp.full((ncol, spectral.nband), 0.06, dtype)

    args = (
        list(models), spectral, solar, co,
        jnp.asarray(atm.play, dtype), jnp.asarray(atm.plev, dtype),
        jnp.asarray(atm.tlay, dtype), mu0, alb, alb,
        jnp.asarray(lwp, dtype), jnp.asarray(iwp, dtype),
        jnp.asarray(rel, dtype), jnp.asarray(rei, dtype),
        {k: jnp.asarray(v, dtype) for k, v in atm.gas_concs.concs.items()},
    )
    if scan_mode == "sequential":
        return _allsky_sw_core_lay_major_jit(*args, top_at_1=top_at_1)
    return _allsky_sw_core_jit(*args, top_at_1=top_at_1, scan_mode=scan_mode)


def load_cloud_optics_checked(path: str) -> CloudOptics:
    from ..extensions.cloud_optics import load_cloud_optics

    return load_cloud_optics(path)
