"""LUT gas-optics kernels: interpolation, absorption/Rayleigh optical
depths, Planck sources.

Reference parity: ``rrtmgp/kernels/mo_gas_optics_kernels.F90`` --
``interpolation`` (:47-144), ``compute_tau_absorption`` (:150-295) with
``gas_optical_depths_major`` (3-D interpolation per band flavor) and
``gas_optical_depths_minor`` (per-minor density/complement scaling,
including the single-precision overflow-ordering fix :436-440),
``compute_tau_rayleigh`` (:469-511), ``compute_Planck_source`` (:514-611),
and the ``interpolate2D/3D_byflav`` stencils (:1060-1165).

Design: the gather-heavy table interpolation is reformulated
densely per g-point -- per-g-point flavor indices are precomputed statically
so each of the 8 trilinear corners becomes ONE flat gather over
(ncol*nlay*ngpt) elements from the flattened kmajor, with XLA fusing the
weight multiplies; band and minor-gas loops are static Python loops
(unrolled at trace time, contiguous static g-point slices). The
troposphere split is a mask, not a layer-range loop.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..gasoptics.kdist import KDist, MinorGasData

PA_TO_HPA = 0.01


class InterpCoeffs(NamedTuple):
    """Interpolation state; shapes (ncol, nlay, ...)."""

    jtemp: jnp.ndarray  # (ncol, nlay) 0-based lower temperature index
    ftemp: jnp.ndarray  # (ncol, nlay)
    jpress: jnp.ndarray  # (ncol, nlay) 0-based lower pressure index
    fpress: jnp.ndarray  # (ncol, nlay)
    tropo: jnp.ndarray  # (ncol, nlay) bool, True = lower atmosphere
    jeta: jnp.ndarray  # (ncol, nlay, nflav, 2) 0-based eta index per temp level
    feta: jnp.ndarray  # (ncol, nlay, nflav, 2)
    col_mix: jnp.ndarray  # (ncol, nlay, nflav, 2)


def compute_col_gas(kd: KDist, gas_desc, col_dry: jnp.ndarray) -> jnp.ndarray:
    """col_gas (ncol, nlay, 1+ngas): molecular column amounts; index 0 is
    dry air (reference compute_gas_optics :896-912)."""
    ncol, nlay = col_dry.shape
    cols = [col_dry]
    for g in kd.gas_names:
        cols.append(gas_desc.get_vmr(g, ncol, nlay) * col_dry)
    return jnp.stack(cols, axis=-1)


def interpolation(kd: KDist, play: jnp.ndarray, tlay: jnp.ndarray, col_gas: jnp.ndarray) -> InterpCoeffs:
    """Reference ``interpolation`` (:47-144), vectorized over flavors."""
    dtype = play.dtype
    ntemp, npres = kd.ntemp, kd.npres
    neta = kd.neta
    temp_ref = jnp.asarray(kd.temp_ref, dtype)
    press_ref_log = jnp.asarray(kd.press_ref_log, dtype)
    tmin, dt = kd.temp_ref_min, kd.temp_ref_delta
    dlogp = kd.press_ref_log_delta

    jtemp = jnp.clip(((tlay - (tmin - dt)) / dt).astype(jnp.int32) - 1, 0, ntemp - 2)
    ftemp = (tlay - temp_ref[jtemp]) / dt

    play_log = jnp.log(play)
    locpress = (play_log - press_ref_log[0]) / dlogp  # 0-based fractional
    jpress = jnp.clip(locpress.astype(jnp.int32), 0, npres - 2)
    fpress = locpress - jpress.astype(dtype)

    tropo = play_log > kd.press_ref_trop_log

    # flavors: (nflav, 2) col_gas indices
    flav = np.asarray(kd.flavor, dtype=np.int64)  # (nflav, 2)
    nflav = flav.shape[0]
    # vmr_ref gathers: (2, 1+ngas, ntemp) -> per flavor gas pair per temp level
    itropo = jnp.where(tropo, 0, 1)  # (ncol, nlay)
    # vmr_ref[itropo, gas, jtemp + dt] for dt in (0, 1)
    g1 = col_gas[..., flav[:, 0]]  # (ncol, nlay, nflav)
    g2 = col_gas[..., flav[:, 1]]

    jetas, fetas, col_mixes = [], [], []
    for dtl in (0, 1):
        vr = kd.vmr_ref[:, :, :]  # (2, 1+ngas, ntemp)
        # gather [itropo, flavgas, jtemp+dtl]: build (ncol, nlay, nflav) per pair
        jt = jtemp + dtl  # (ncol, nlay)
        # vmr_ref transposed to (ntemp, 2, 1+ngas) for flat gather
        vrt = jnp.transpose(vr, (2, 0, 1))  # (ntemp, 2, 1+ngas)
        v_sel = vrt[jt, itropo]  # (ncol, nlay, 1+ngas)
        r1 = v_sel[..., flav[:, 0]]  # (ncol, nlay, nflav)
        r2 = v_sel[..., flav[:, 1]]
        ratio_eta_half = r1 / r2
        col_mix = g1 + ratio_eta_half * g2
        tiny = jnp.finfo(dtype).tiny
        col_mix_safe = jnp.where(col_mix > 2.0 * tiny, col_mix, 1.0)
        eta = jnp.where(col_mix > 2.0 * tiny, g1 / col_mix_safe, 0.5)
        loceta = eta * (neta - 1)
        je = jnp.clip(loceta.astype(jnp.int32), 0, neta - 2)
        fe = loceta - je.astype(dtype)
        jetas.append(je)
        fetas.append(fe)
        col_mixes.append(col_mix)

    return InterpCoeffs(
        jtemp=jtemp,
        ftemp=ftemp,
        jpress=jpress,
        fpress=fpress,
        tropo=tropo,
        jeta=jnp.stack(jetas, axis=-1),
        feta=jnp.stack(fetas, axis=-1),
        col_mix=jnp.stack(col_mixes, axis=-1),
    )


def _per_gpt_flavor(kd: KDist, ic: InterpCoeffs):
    """Per-(col,lay,gpt) flavor index via the static per-g-point flavor
    arrays (lower/upper atmosphere selected by the troposphere mask)."""
    gf = np.asarray(kd.gpoint_flavor, dtype=np.int64)  # (ngpt, 2) [lower, upper]
    flav_lower = jnp.asarray(gf[:, 0])
    flav_upper = jnp.asarray(gf[:, 1])
    iflav = jnp.where(ic.tropo[..., None], flav_lower, flav_upper)  # (ncol, nlay, ngpt)
    return iflav


def _select_flavored(arr, iflav):
    """Gather per-flavor arrays (ncol, nlay, nflav, ...) to per-g-point
    (ncol, nlay, ngpt, ...) using the (ncol, nlay, ngpt) flavor index."""
    ncol, nlay, ngpt = iflav.shape
    moved = jnp.moveaxis(arr, 2, -1)  # (..., nflav)
    out = jnp.take_along_axis(
        moved[..., None, :],
        iflav.reshape(ncol, nlay, *([1] * (arr.ndim - 3)), ngpt, 1),
        axis=-1,
    )[..., 0]
    return jnp.moveaxis(out, -1, 2)


def tau_major(kd: KDist, ic: InterpCoeffs) -> jnp.ndarray:
    """Major-species optical depth (gas_optical_depths_major, dense
    formulation). Returns (ncol, nlay, ngpt)."""
    ncol, nlay = ic.jtemp.shape
    ngpt = kd.ngpt
    neta, npres = kd.neta, kd.npres
    dtype = ic.ftemp.dtype

    iflav = _per_gpt_flavor(kd, ic)  # (ncol, nlay, ngpt)
    itropo0 = jnp.where(ic.tropo, 0, 1)  # 0 lower -> pressure plane offset

    _sel = lambda a: _select_flavored(a, iflav)
    jeta_g = _sel(ic.jeta)  # (ncol, nlay, ngpt, 2)
    feta_g = _sel(ic.feta)
    colmix_g = _sel(ic.col_mix)
    ftemp_term = jnp.stack([1.0 - ic.ftemp, ic.ftemp], axis=-1)  # (ncol, nlay, 2)
    fpress_term = jnp.stack([1.0 - ic.fpress, ic.fpress], axis=-1)  # (ncol, nlay, 2)

    kflat = kd.kmajor.reshape(-1, ngpt)  # (ntemp*(npres+1)*neta, ngpt)
    gidx = jnp.arange(ngpt)

    tau = jnp.zeros((ncol, nlay, ngpt), dtype)
    for dtl in (0, 1):
        jt = ic.jtemp + dtl  # (ncol, nlay)
        for dp in (0, 1):
            jp = ic.jpress + itropo0 + dp  # (ncol, nlay)
            base = (jt * (npres + 1) + jp) * neta  # (ncol, nlay)
            for de in (0, 1):
                je = jeta_g[..., dtl] + de  # (ncol, nlay, ngpt)
                rows = base[..., None] + je  # (ncol, nlay, ngpt)
                kval = kflat[rows, gidx]  # (ncol, nlay, ngpt)
                w_eta = jnp.where(de == 0, 1.0 - feta_g[..., dtl], feta_g[..., dtl])
                w = (
                    colmix_g[..., dtl]
                    * ftemp_term[..., dtl : dtl + 1]
                    * fpress_term[..., dp : dp + 1]
                    * w_eta
                )
                tau = tau + w * kval
    return tau


def tau_minor_one_atmos(
    kd: KDist,
    minor: MinorGasData,
    atmos_is_lower: bool,
    ic: InterpCoeffs,
    play: jnp.ndarray,
    tlay: jnp.ndarray,
    col_gas: jnp.ndarray,
    idx_h2o: int,
    tau: jnp.ndarray,
) -> jnp.ndarray:
    """Add minor-gas optical depths for one atmosphere (lower or upper);
    reference gas_optical_depths_minor (:360-462). The layer-range loop
    becomes a troposphere mask."""
    if minor.n_minor == 0:
        return tau
    ncol, nlay = play.shape
    dtype = play.dtype
    gf = np.asarray(kd.gpoint_flavor, dtype=np.int64)
    mask = ic.tropo if atmos_is_lower else ~ic.tropo  # (ncol, nlay)
    ntemp, neta = kd.ntemp, kd.neta
    kflat = minor.kminor.reshape(-1, minor.kminor.shape[-1])  # (ntemp*neta, ncontrib)

    vmr_fact = 1.0 / col_gas[..., 0]
    dry_fact = 1.0 / (1.0 + col_gas[..., idx_h2o] * vmr_fact)
    dens = PA_TO_HPA * play / tlay

    for im in range(minor.n_minor):
        gptS, gptE = minor.limits_gpt[im]
        nb_g = gptE - gptS
        scaling = col_gas[..., minor.idx_minor[im]]
        if minor.scales_with_density[im]:
            scaling = scaling * dens
            iscl = minor.idx_minor_scaling[im]
            if iscl > 0:
                frac = col_gas[..., iscl] * vmr_fact * dry_fact
                if minor.scale_by_complement[im]:
                    scaling = scaling * (1.0 - frac)
                else:
                    # sp-safety: small factor computed first (reference :436-440)
                    scaling = scaling * frac
        # flavor of this minor's g-point range (constant over the range)
        iflav = int(gf[gptS, 0 if atmos_is_lower else 1])
        je = ic.jeta[:, :, iflav, :]  # (ncol, nlay, 2)
        fe = ic.feta[:, :, iflav, :]
        ks = minor.kminor_start[im]
        # static slice BEFORE the gather: only this minor's nb_g columns
        # ride the (ncol, nlay) row gather, not all ncontrib
        ksub = kflat[:, ks:ks + nb_g]
        contrib = jnp.zeros((ncol, nlay, nb_g), dtype)
        for dtl in (0, 1):
            jt = ic.jtemp + dtl
            for de in (0, 1):
                rows = jt * neta + je[..., dtl] + de  # (ncol, nlay)
                kval = ksub[rows]  # (ncol, nlay, nb_g)
                w_eta = jnp.where(de == 0, 1.0 - fe[..., dtl], fe[..., dtl])
                ftt = jnp.where(dtl == 0, 1.0 - ic.ftemp, ic.ftemp)
                contrib = contrib + (w_eta * ftt)[..., None] * kval
        add = jnp.where(mask[..., None], scaling[..., None] * contrib, 0.0)
        tau = tau.at[..., gptS:gptE].add(add)
    return tau


def compute_tau_absorption(
    kd: KDist,
    ic: InterpCoeffs,
    play: jnp.ndarray,
    tlay: jnp.ndarray,
    col_gas: jnp.ndarray,
) -> jnp.ndarray:
    """Major + minor-lower + minor-upper absorption optical depth
    (reference compute_tau_absorption :150-295)."""
    idx_h2o = 1 + kd.gas_names.index("h2o")
    tau = tau_major(kd, ic)
    tau = tau_minor_one_atmos(kd, kd.minor_lower, True, ic, play, tlay, col_gas, idx_h2o, tau)
    tau = tau_minor_one_atmos(kd, kd.minor_upper, False, ic, play, tlay, col_gas, idx_h2o, tau)
    return tau


def compute_tau_rayleigh(
    kd: KDist,
    ic: InterpCoeffs,
    col_gas: jnp.ndarray,
    col_dry: jnp.ndarray,
) -> jnp.ndarray:
    """Rayleigh-scattering optical depth (reference compute_tau_rayleigh
    :469-511): 2-D (eta, temp) interpolation of krayl per g-point, scaled
    by the moist column amount."""
    idx_h2o = 1 + kd.gas_names.index("h2o")
    ncol, nlay = col_dry.shape
    ngpt, neta = kd.ngpt, kd.neta
    dtype = col_dry.dtype

    iflav = _per_gpt_flavor(kd, ic)  # (ncol, nlay, ngpt)

    _sel = lambda a: _select_flavored(a, iflav)
    jeta_g = _sel(ic.jeta)  # (ncol, nlay, ngpt, 2)
    feta_g = _sel(ic.feta)
    itropo0 = jnp.where(ic.tropo, 0, 1)[..., None]  # (ncol, nlay, 1)

    # krayl (2, ntemp, neta, ngpt) -> flat (2*ntemp*neta, ngpt)
    kflat = kd.krayl.reshape(-1, ngpt)
    gidx = jnp.arange(ngpt)
    k = jnp.zeros((ncol, nlay, ngpt), dtype)
    for dtl in (0, 1):
        jt = (ic.jtemp + dtl)[..., None]  # (ncol, nlay, 1)
        ftt = jnp.where(dtl == 0, 1.0 - ic.ftemp, ic.ftemp)[..., None]
        base = (itropo0 * kd.ntemp + jt) * neta
        for de in (0, 1):
            rows = base + jeta_g[..., dtl] + de
            kval = kflat[rows, gidx]
            w_eta = jnp.where(de == 0, 1.0 - feta_g[..., dtl], feta_g[..., dtl])
            k = k + ftt * w_eta * kval
    return k * (col_gas[..., idx_h2o] + col_dry)[..., None]


def compute_planck_source(
    kd: KDist,
    ic: InterpCoeffs,
    tlay: jnp.ndarray,
    tlev: jnp.ndarray,
    tsfc: jnp.ndarray,
    top_at_1: bool,
    save_pfrac: bool = False,
):
    """Planck sources from the LUT Planck-fraction table (reference
    compute_Planck_source :514-611). Returns (lay_source, lev_source,
    sfc_source, sfc_source_jac[, pfrac])."""
    ncol, nlay = tlay.shape
    ngpt, neta, npres = kd.ngpt, kd.neta, kd.npres
    dtype = tlay.dtype

    # pfrac: 3-D interpolation with scaling = 1 on the pfracin table
    iflav = _per_gpt_flavor(kd, ic)

    _sel = lambda a: _select_flavored(a, iflav)
    jeta_g = _sel(ic.jeta)
    feta_g = _sel(ic.feta)
    ftemp_term = jnp.stack([1.0 - ic.ftemp, ic.ftemp], axis=-1)
    fpress_term = jnp.stack([1.0 - ic.fpress, ic.fpress], axis=-1)
    itropo0 = jnp.where(ic.tropo, 0, 1)

    kflat = kd.pfracin.reshape(-1, ngpt)
    gidx = jnp.arange(ngpt)
    pfrac = jnp.zeros((ncol, nlay, ngpt), dtype)
    for dtl in (0, 1):
        jt = ic.jtemp + dtl
        for dp in (0, 1):
            jp = ic.jpress + itropo0 + dp
            base = (jt * (npres + 1) + jp) * neta
            for de in (0, 1):
                je = jeta_g[..., dtl] + de
                rows = base[..., None] + je
                kval = kflat[rows, gidx]
                w_eta = jnp.where(de == 0, 1.0 - feta_g[..., dtl], feta_g[..., dtl])
                w = ftemp_term[..., dtl : dtl + 1] * fpress_term[..., dp : dp + 1] * w_eta
                pfrac = pfrac + w * kval

    from ..gasoptics.planck import compute_planck_source_nn

    lay, lev, sfc, sfc_jac = compute_planck_source_nn(
        pfrac, tlay, tlev, tsfc, kd.spectral, kd.planck, top_at_1=top_at_1
    )
    if save_pfrac:
        return lay, lev, sfc, sfc_jac, pfrac
    return lay, lev, sfc, sfc_jac
