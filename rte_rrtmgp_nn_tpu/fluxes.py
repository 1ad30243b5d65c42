"""Flux containers and spectral reductions.

Reference parity: ``rte/mo_fluxes.F90`` (ty_fluxes_broadband and the
flexible g-point variant), ``rte/kernels/mo_fluxes_broadband_kernels.F90``
(sum/net over the g-point dimension), ``extensions/mo_fluxes_byband.F90`` +
kernels, and ``extensions/mo_fluxes_bygpoint.F90``.

Design: the solvers return spectral (g-point) fluxes or in-scan broadband
accumulations; "reducers" here are pure functions from g-point fluxes
(ncol, nlev, ngpt) to the requested diagnostics. The abstract reduce() /
are_desired() machinery of the Fortran collapses into selecting which
reducer to apply.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .spectral import SpectralMapping


@dataclasses.dataclass(frozen=True)
class FluxesBroadband:
    """(ncol, nlev) broadband fluxes; dn_dir and jacobian optional."""

    flux_up: jnp.ndarray
    flux_dn: jnp.ndarray
    flux_net: Optional[jnp.ndarray] = None
    flux_dn_dir: Optional[jnp.ndarray] = None
    flux_up_jac: Optional[jnp.ndarray] = None


@dataclasses.dataclass(frozen=True)
class FluxesByband:
    """Broadband plus per-band resolved fluxes (ncol, nlev, nband)."""

    broadband: FluxesBroadband
    bnd_flux_up: jnp.ndarray
    bnd_flux_dn: jnp.ndarray
    bnd_flux_net: Optional[jnp.ndarray] = None
    bnd_flux_dn_dir: Optional[jnp.ndarray] = None


@dataclasses.dataclass(frozen=True)
class FluxesBygpoint:
    """Spectral fluxes stored verbatim (ncol, nlev, ngpt)."""

    gpt_flux_up: jnp.ndarray
    gpt_flux_dn: jnp.ndarray
    gpt_flux_net: Optional[jnp.ndarray] = None
    gpt_flux_dn_dir: Optional[jnp.ndarray] = None


for _cls, _fields in [
    (FluxesBroadband, ["flux_up", "flux_dn", "flux_net", "flux_dn_dir", "flux_up_jac"]),
    (FluxesByband, ["broadband", "bnd_flux_up", "bnd_flux_dn", "bnd_flux_net", "bnd_flux_dn_dir"]),
    (FluxesBygpoint, ["gpt_flux_up", "gpt_flux_dn", "gpt_flux_net", "gpt_flux_dn_dir"]),
]:
    jax.tree_util.register_dataclass(_cls, data_fields=_fields, meta_fields=[])


# -- kernels -----------------------------------------------------------------

def sum_broadband(gpt_flux: jnp.ndarray) -> jnp.ndarray:
    """(ncol, nlev, ngpt) -> (ncol, nlev). Reference sum_broadband
    (mo_fluxes_broadband_kernels.F90:21-43)."""
    return jnp.sum(gpt_flux, axis=-1)


def net_broadband(flux_dn: jnp.ndarray, flux_up: jnp.ndarray) -> jnp.ndarray:
    """Net = dn - up (mo_fluxes_broadband_kernels.F90 net_broadband_precalc)."""
    return flux_dn - flux_up


def net_broadband_full(gpt_flux_dn: jnp.ndarray, gpt_flux_up: jnp.ndarray) -> jnp.ndarray:
    """Net from spectral fluxes directly (net_broadband_full)."""
    return jnp.sum(gpt_flux_dn - gpt_flux_up, axis=-1)


def sum_byband(gpt_flux: jnp.ndarray, spectral: SpectralMapping) -> jnp.ndarray:
    """(ncol, nlev, ngpt) -> (ncol, nlev, nband). Reference sum_byband
    (mo_fluxes_byband_kernels.F90:31-66)."""
    return spectral.reduce_sum(gpt_flux)


def net_byband(bnd_flux_dn: jnp.ndarray, bnd_flux_up: jnp.ndarray) -> jnp.ndarray:
    return bnd_flux_dn - bnd_flux_up


# -- reducers ----------------------------------------------------------------

def reduce_broadband(
    gpt_flux_up: jnp.ndarray,
    gpt_flux_dn: jnp.ndarray,
    gpt_flux_dn_dir: Optional[jnp.ndarray] = None,
    gpt_flux_up_jac: Optional[jnp.ndarray] = None,
    with_net: bool = True,
) -> FluxesBroadband:
    up = sum_broadband(gpt_flux_up)
    dn = sum_broadband(gpt_flux_dn)
    return FluxesBroadband(
        flux_up=up,
        flux_dn=dn,
        flux_net=(dn - up) if with_net else None,
        flux_dn_dir=None if gpt_flux_dn_dir is None else sum_broadband(gpt_flux_dn_dir),
        flux_up_jac=None if gpt_flux_up_jac is None else sum_broadband(gpt_flux_up_jac),
    )


def reduce_byband(
    spectral: SpectralMapping,
    gpt_flux_up: jnp.ndarray,
    gpt_flux_dn: jnp.ndarray,
    gpt_flux_dn_dir: Optional[jnp.ndarray] = None,
    with_net: bool = True,
) -> FluxesByband:
    bu = sum_byband(gpt_flux_up, spectral)
    bd = sum_byband(gpt_flux_dn, spectral)
    return FluxesByband(
        broadband=FluxesBroadband(
            flux_up=jnp.sum(bu, -1),
            flux_dn=jnp.sum(bd, -1),
            flux_net=jnp.sum(bd - bu, -1) if with_net else None,
            flux_dn_dir=None
            if gpt_flux_dn_dir is None
            else jnp.sum(gpt_flux_dn_dir, -1),
        ),
        bnd_flux_up=bu,
        bnd_flux_dn=bd,
        bnd_flux_net=(bd - bu) if with_net else None,
        bnd_flux_dn_dir=None if gpt_flux_dn_dir is None else sum_byband(gpt_flux_dn_dir, spectral),
    )
