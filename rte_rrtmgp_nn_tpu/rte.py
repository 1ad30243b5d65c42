"""Top-level RTE drivers: ``rte_lw`` and ``rte_sw``.

Reference parity: ``rte/mo_rte_lw.F90`` (validation, band-emissivity
expansion, dispatch by optical-props type: 1scl -> no-scat Gauss-quad with
optional per-g-point optimal secants, 2str -> two-stream or Tang-rescaled
no-scat, nstr -> not implemented) and ``rte/mo_rte_sw.F90`` (1scl ->
direct-beam only, 2str -> two-stream+adding; per-g-point albedos supplied
by the caller, as in this fork).

Design: pure functions returning spectral fluxes (plus optional
broadband-reduced containers); everything jit-friendly with static
configuration arguments.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .config import config
from .optical_props import (
    OpticalProps1scl,
    OpticalProps2str,
    OpticalPropsNstr,
    validate,
)
from .ops.lw_solver import LWSolution, lw_solver_2stream, lw_solver_noscat
from .ops.sw_solver import SWSolution, sw_solver_2stream, sw_solver_noscat
from .sources import SourceFuncLW
from .utils.validation import any_vals_less_than, any_vals_outside


def _concrete_or_raise(a, who: str):
    # config.check_values runs the reference's HOST-side range checks
    # (mo_rte_util_array); under jit the arrays are tracers and cannot be
    # inspected -- surface that instead of a cryptic concretization error
    import jax

    if isinstance(a, jax.core.Tracer):
        raise ValueError(
            f"{who}: config.check_values requires concrete (un-jitted) "
            "inputs; validate before jit or disable check_values")


def _check_values_lw(optical_props, sfc_emis, inc_flux, lw_ds,
                     n_gauss_angles):
    """Reference mo_rte_lw.F90:190-205,266 value checks."""
    _concrete_or_raise(optical_props.tau, "rte_lw")
    errs = validate(optical_props)
    if any_vals_outside(sfc_emis, 0.0, 1.0):
        errs.append("rte_lw: sfc_emis has values < 0 or > 1")
    if inc_flux is not None and any_vals_less_than(inc_flux, 0.0):
        errs.append("rte_lw: inc_flux has values < 0")
    if not 1 <= n_gauss_angles <= 4:
        errs.append("rte_lw: n_gauss_angles must be in 1..4")
    if lw_ds is not None and any_vals_less_than(lw_ds, 1.0):
        errs.append("rte_lw: one or more values of lw_ds < 1.")
    if errs:
        raise ValueError("; ".join(errs))


def _check_values_sw(optical_props, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif,
                     inc_flux_dif):
    """Reference mo_rte_sw.F90:120-133 value checks."""
    _concrete_or_raise(optical_props.tau, "rte_sw")
    errs = validate(optical_props)
    if any_vals_outside(mu0, 0.0, 1.0):
        errs.append("rte_sw: one or more mu0 <= 0 or > 1")
    if any_vals_less_than(inc_flux, 0.0):
        errs.append("rte_sw: inc_flux has values < 0")
    if any_vals_outside(sfc_alb_dir, 0.0, 1.0):
        errs.append("rte_sw: sfc_alb_dir out of range [0,1]")
    if any_vals_outside(sfc_alb_dif, 0.0, 1.0):
        errs.append("rte_sw: sfc_alb_dif out of range [0,1]")
    if inc_flux_dif is not None and any_vals_less_than(inc_flux_dif, 0.0):
        errs.append("rte_sw: inc_flux_dif has values < 0")
    if errs:
        raise ValueError("; ".join(errs))


def rte_lw(
    optical_props,
    top_at_1: bool,
    sources: SourceFuncLW,
    sfc_emis: jnp.ndarray,
    inc_flux: Optional[jnp.ndarray] = None,
    n_gauss_angles: int = 1,
    use_2stream: bool = False,
    lw_ds: Optional[jnp.ndarray] = None,
    compute_jac: bool = False,
    scan_mode: str = "sequential",
    broadband: bool = False,
) -> LWSolution:
    """Longwave transport. sfc_emis is per band (ncol, nband), expanded to
    g-points here (reference mo_rte_lw.F90:295-303).

    Returns spectral fluxes (apply fluxes.reduce_* for diagnostics), or
    in-scan-reduced broadband fluxes with ``broadband=True`` (no-scat path
    only -- the fast path when spectral fluxes aren't needed).
    """
    spectral = optical_props.spectral
    ncol, nlay, ngpt = optical_props.tau.shape
    want_jac = compute_jac or config.compute_jac

    # argument-consistency errors are unconditional, like the reference's
    # select-type block (mo_rte_lw.F90:235-259)
    if use_2stream and isinstance(optical_props, OpticalProps1scl):
        raise ValueError(
            "rte_lw: can't use two-stream methods with only absorption "
            "optical depth")
    if lw_ds is not None:
        if not isinstance(optical_props, OpticalProps1scl):
            raise ValueError(
                "rte_lw: lw_ds not valid input for 2str optical props")
        if n_gauss_angles != 1:
            raise ValueError(
                "rte_lw: providing lw_ds incompatible with specifying "
                "n_gauss_angles")
    if use_2stream and n_gauss_angles != 1:
        raise ValueError(
            "rte_lw: use_2stream incompatible with specifying "
            "n_gauss_angles")
    if use_2stream and want_jac:
        raise ValueError(
            "rte_lw: can't provide Jacobian of fluxes w.r.t surface "
            "temperature with 2-stream")

    if config.check_extents:
        if sources.lay_source.shape != (ncol, nlay, ngpt):
            raise ValueError("rte_lw: sources inconsistently sized")
        if sources.lev_source.shape != (ncol, nlay + 1, ngpt):
            raise ValueError(
                "rte_lw: lev_source must be (ncol, nlay+1, ngpt)")
        if sources.sfc_source.shape != (ncol, ngpt):
            raise ValueError("rte_lw: sfc_source must be (ncol, ngpt)")
        if sfc_emis.shape != (ncol, spectral.nband):
            raise ValueError("rte_lw: sfc_emis must be (ncol, nband)")
        if lw_ds is not None and lw_ds.shape != (ncol, ngpt):
            raise ValueError("rte_lw: lw_ds inconsistently sized")
        if inc_flux is not None and inc_flux.shape != (ncol, ngpt):
            raise ValueError("rte_lw: inc_flux must be (ncol, ngpt)")
    if config.check_values:
        _check_values_lw(optical_props, sfc_emis, inc_flux, lw_ds,
                         n_gauss_angles)

    sfc_emis_gpt = spectral.expand(sfc_emis)
    jac = sources.sfc_source_jac if want_jac else None

    def with_dn_jac(sol: LWSolution) -> LWSolution:
        # flux_dn_Jac parity (mo_rte_lw.F90:85): the reference accepts the
        # output but never computes it -- in the no-scat solver the down
        # flux is independent of surface temperature, so the Jacobian is
        # exactly zero. Expose it whenever the up-Jacobian was requested.
        if jac is None or sol.flux_up_jac is None:
            return sol
        return sol._replace(flux_dn_jac=jnp.zeros_like(sol.flux_dn))

    if isinstance(optical_props, OpticalProps1scl):
        return with_dn_jac(lw_solver_noscat(
            optical_props.tau,
            sources.lay_source,
            sources.lev_source,
            sfc_emis_gpt,
            sources.sfc_source,
            inc_flux=inc_flux,
            top_at_1=top_at_1,
            n_gauss_angles=n_gauss_angles,
            lw_ds=lw_ds,
            sfc_source_jac=jac,
            scan_mode=scan_mode,
            broadband=broadband,
        ))
    if isinstance(optical_props, OpticalProps2str):
        if use_2stream:
            return lw_solver_2stream(
                optical_props.tau,
                optical_props.ssa,
                optical_props.g,
                sources.lay_source,
                sources.lev_source,
                sfc_emis_gpt,
                sources.sfc_source,
                inc_flux=inc_flux,
                top_at_1=top_at_1,
                scan_mode=scan_mode,
            )
        # Tang-2018 rescaled no-scattering solution (reference :357-389).
        return with_dn_jac(lw_solver_noscat(
            optical_props.tau,
            sources.lay_source,
            sources.lev_source,
            sfc_emis_gpt,
            sources.sfc_source,
            inc_flux=inc_flux,
            top_at_1=top_at_1,
            n_gauss_angles=n_gauss_angles,
            sfc_source_jac=jac,
            ssa=optical_props.ssa,
            g=optical_props.g,
            do_rescaling=True,
            scan_mode=scan_mode,
        ))
    if isinstance(optical_props, OpticalPropsNstr):
        raise NotImplementedError(
            "rte_lw(...nstr...) not yet implemented"  # parity: mo_rte_lw.F90:391-395
        )
    raise TypeError(f"rte_lw: unknown optical props {type(optical_props)}")


def rte_sw(
    optical_props,
    top_at_1: bool,
    mu0: jnp.ndarray,
    inc_flux: jnp.ndarray,
    sfc_alb_dir: jnp.ndarray,
    sfc_alb_dif: jnp.ndarray,
    inc_flux_dif: Optional[jnp.ndarray] = None,
    scan_mode: str = "sequential",
    broadband: bool = False,
) -> SWSolution:
    """Shortwave transport (reference mo_rte_sw.F90:48-242).

    mu0: (ncol,) cosine of solar zenith angle (positive).
    inc_flux: (ncol, ngpt) TOA direct spectral flux.
    sfc_alb_dir / sfc_alb_dif: (ncol, ngpt) -- ALREADY per g-point, matching
    this fork's convention of expanding outside the solver.
    """
    if config.check_extents:
        ncol, nlay, ngpt = optical_props.tau.shape
        for nm, a, shp in [
            ("mu0", mu0, (ncol,)),
            ("inc_flux", inc_flux, (ncol, ngpt)),
            ("sfc_alb_dir", sfc_alb_dir, (ncol, ngpt)),
            ("sfc_alb_dif", sfc_alb_dif, (ncol, ngpt)),
        ]:
            if a.shape != shp:
                raise ValueError(f"rte_sw: {nm} has shape {a.shape}, want {shp}")
    if config.check_values:
        _check_values_sw(optical_props, mu0, inc_flux, sfc_alb_dir,
                         sfc_alb_dif, inc_flux_dif)

    if isinstance(optical_props, OpticalProps1scl):
        flux_dir = sw_solver_noscat(optical_props.tau, mu0, inc_flux, top_at_1=top_at_1)
        if broadband:  # same rank contract as the 2str broadband path
            bb = jnp.sum(flux_dir, -1)
            return SWSolution(jnp.zeros_like(bb), bb, bb)
        return SWSolution(jnp.zeros_like(flux_dir), flux_dir, flux_dir)
    if isinstance(optical_props, OpticalProps2str):
        return sw_solver_2stream(
            optical_props.tau,
            optical_props.ssa,
            optical_props.g,
            mu0,
            inc_flux,
            sfc_alb_dir,
            sfc_alb_dif,
            inc_flux_dif=inc_flux_dif,
            top_at_1=top_at_1,
            scan_mode=scan_mode,
            broadband=broadband,
        )
    raise TypeError(f"rte_sw: unsupported optical props {type(optical_props)}")
