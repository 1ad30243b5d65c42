"""Optical-property containers and their algebra.

Reference parity: ``rte/mo_optical_props.F90`` (ty_optical_props_1scl /
_2str / _nstr plus delta_scale, increment, subset, validate) and the
element-wise kernels in ``rte/kernels/mo_optical_props_kernels.F90``.

Design:
  - arrays are ``(ncol, nlay, ngpt)`` with the g-point dimension minor
    (112-256 wide, contiguous for XLA fusion). The reference's Fortran ``(ngpt, nlay, ncol)`` is the same
    memory order, transposed notation.
  - containers are frozen dataclass pytrees; the spectral mapping is static
    aux data so jit keys on it.
  - the 9+9 increment combinations collapse to three jnp functions with a
    by-band broadcast handled by ``SpectralMapping.expand``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .spectral import SpectralMapping


def _register(cls, data_fields, meta_fields=()):
    jax.tree_util.register_dataclass(cls, data_fields=list(data_fields), meta_fields=list(meta_fields))
    return cls


@dataclasses.dataclass(frozen=True)
class OpticalProps1scl:
    """Absorption-only optical depth (reference _1scl, mo_optical_props.F90:162)."""

    tau: jnp.ndarray  # (ncol, nlay, ngpt)
    spectral: SpectralMapping

    @property
    def ncol(self):
        return self.tau.shape[0]

    @property
    def nlay(self):
        return self.tau.shape[1]

    @property
    def ngpt(self):
        return self.tau.shape[2]


@dataclasses.dataclass(frozen=True)
class OpticalProps2str:
    """Two-stream: tau, single-scattering albedo, asymmetry
    (reference _2str, mo_optical_props.F90:178-180)."""

    tau: jnp.ndarray  # (ncol, nlay, ngpt)
    ssa: jnp.ndarray  # (ncol, nlay, ngpt)
    g: jnp.ndarray  # (ncol, nlay, ngpt)
    spectral: SpectralMapping

    @property
    def ncol(self):
        return self.tau.shape[0]

    @property
    def nlay(self):
        return self.tau.shape[1]

    @property
    def ngpt(self):
        return self.tau.shape[2]


@dataclasses.dataclass(frozen=True)
class OpticalPropsNstr:
    """n-stream: tau, ssa, phase-function moments p(nmom, ...)
    (reference _nstr, mo_optical_props.F90:195-197)."""

    tau: jnp.ndarray  # (ncol, nlay, ngpt)
    ssa: jnp.ndarray  # (ncol, nlay, ngpt)
    p: jnp.ndarray  # (nmom, ncol, nlay, ngpt)
    spectral: SpectralMapping

    @property
    def ncol(self):
        return self.tau.shape[0]

    @property
    def nlay(self):
        return self.tau.shape[1]

    @property
    def ngpt(self):
        return self.tau.shape[2]

    @property
    def nmom(self):
        return self.p.shape[0]


_register(OpticalProps1scl, ["tau"], ["spectral"])
_register(OpticalProps2str, ["tau", "ssa", "g"], ["spectral"])
_register(OpticalPropsNstr, ["tau", "ssa", "p"], ["spectral"])

OpticalProps = OpticalProps1scl | OpticalProps2str | OpticalPropsNstr


# -- constructors ------------------------------------------------------------

def zeros_1scl(ncol, nlay, spectral: SpectralMapping, dtype=jnp.float32) -> OpticalProps1scl:
    return OpticalProps1scl(jnp.zeros((ncol, nlay, spectral.ngpt), dtype), spectral)


def zeros_2str(ncol, nlay, spectral: SpectralMapping, dtype=jnp.float32) -> OpticalProps2str:
    z = jnp.zeros((ncol, nlay, spectral.ngpt), dtype)
    return OpticalProps2str(z, z, z, spectral)


def zeros_nstr(nmom, ncol, nlay, spectral: SpectralMapping, dtype=jnp.float32) -> OpticalPropsNstr:
    z = jnp.zeros((ncol, nlay, spectral.ngpt), dtype)
    return OpticalPropsNstr(z, z, jnp.zeros((nmom,) + z.shape, dtype), spectral)


# -- validation (host-side; reference mo_optical_props.F90:619-710) ----------

def validate(op: OpticalProps) -> list[str]:
    """Value checks. Returns list of error strings (empty = valid).
    Host-side only (pulls values); mirrors the reference's validate(),
    including the ssa<=1.0001 fast-math tolerance (mo_optical_props.F90:663)."""
    errs = []
    tau = np.asarray(op.tau)
    if np.any(tau < 0):
        errs.append("validate: tau values out of range")
    if isinstance(op, (OpticalProps2str, OpticalPropsNstr)):
        ssa = np.asarray(op.ssa)
        if np.any(ssa < 0) or np.any(ssa > 1.0001):
            errs.append("validate: ssa values out of range [0,1]")
    if isinstance(op, OpticalProps2str):
        g = np.asarray(op.g)
        if np.any(g < -1) or np.any(g > 1):
            errs.append("validate: g values out of range [-1,1]")
    return errs


# -- delta scaling (reference mo_optical_props_kernels.F90:46-107) -----------

def delta_scale(op: OpticalProps2str, forward_frac: Optional[jnp.ndarray] = None) -> OpticalProps2str:
    """Delta-scale two-stream properties. With no ``forward_frac``, f = g**2
    (delta_scale_2str_kernel); with it, the user-supplied forward fraction
    (delta_scale_2str_f_kernel)."""
    eps = jnp.finfo(op.tau.dtype).eps
    f = op.g * op.g if forward_frac is None else forward_frac
    wf = op.ssa * f
    tau = op.tau * (1.0 - wf)
    g = (op.g - f) / jnp.maximum(eps, 1.0 - f)
    ssa = (op.ssa - wf) / jnp.maximum(eps, 1.0 - wf)
    return dataclasses.replace(op, tau=tau, ssa=ssa, g=g)


# -- increment: op1 += op2 (reference mo_optical_props.F90:882-1023) ---------

def _expand_if_byband(arr: jnp.ndarray, src: SpectralMapping, dst: SpectralMapping) -> jnp.ndarray:
    """If src is band-resolved (ngpt == nband of dst), broadcast bands to the
    dst g-point grid (the ``inc_X_by_Y_bybnd`` kernels)."""
    if src.ngpt == dst.ngpt:
        return arr
    if src.ngpt == dst.nband:
        return dst.expand(arr)
    raise ValueError(
        f"increment: incompatible spectral discretizations (src ngpt {src.ngpt}, dst ngpt {dst.ngpt}, dst nband {dst.nband})"
    )


def increment(op1: OpticalProps, op2: OpticalProps) -> OpticalProps:
    """Return op1 with op2's optical properties added (op1 = op1 + op2).

    Handles all 9 same-gpt combinations and the 9 by-band-broadcast
    combinations of the reference (mo_optical_props_kernels.F90:109-636).
    Moment counts must match for nstr+nstr.
    """
    eps = jnp.finfo(op1.tau.dtype).eps
    tau2 = _expand_if_byband(op2.tau, op2.spectral, op1.spectral)

    if isinstance(op1, OpticalProps1scl):
        if isinstance(op2, OpticalProps1scl):
            return dataclasses.replace(op1, tau=op1.tau + tau2)
        # absorption-only accumulates (1-ssa)*tau from scattering media
        ssa2 = _expand_if_byband(op2.ssa, op2.spectral, op1.spectral)
        return dataclasses.replace(op1, tau=op1.tau + tau2 * (1.0 - ssa2))

    if isinstance(op2, OpticalProps1scl):
        # absorption-only increment: g / p UNCHANGED (reference
        # increment_2stream_by_1scalar :169-189 "g is unchanged",
        # increment_nstream_by_1scalar :255-275 "p is unchanged") -- the
        # generic tauscat recombination below would rewrite them (to 0
        # where the scattering optical depth underflows eps)
        tau12 = op1.tau + tau2
        ssa = op1.tau * op1.ssa / jnp.maximum(eps, tau12)
        return dataclasses.replace(op1, tau=tau12, ssa=ssa)
    else:
        ssa2 = _expand_if_byband(op2.ssa, op2.spectral, op1.spectral)
        if isinstance(op2, OpticalProps2str):
            g2 = _expand_if_byband(op2.g, op2.spectral, op1.spectral)
        else:  # nstr: use first moment as asymmetry when folding into 2str
            g2 = _expand_if_byband(op2.p[0], op2.spectral, op1.spectral)

    tau12 = op1.tau + tau2
    tauscat12 = op1.tau * op1.ssa + tau2 * ssa2

    if isinstance(op1, OpticalProps2str):
        g = (op1.tau * op1.ssa * op1.g + tau2 * ssa2 * g2) / jnp.maximum(eps, tauscat12)
        ssa = tauscat12 / jnp.maximum(eps, tau12)
        return dataclasses.replace(op1, tau=tau12, ssa=ssa, g=g)

    # nstr destination
    if isinstance(op2, OpticalPropsNstr):
        p2 = jax.vmap(lambda m: _expand_if_byband(m, op2.spectral, op1.spectral))(op2.p)
        if p2.shape[0] != op1.p.shape[0]:
            raise ValueError("increment: moment counts differ for nstr+nstr")
    else:  # 2str source (1scl returned above)
        # build moments from asymmetry: p_m = g**(m+1) (Henyey-Greenstein-like,
        # matching the reference inc_nstr_by_2str moment reconstruction)
        m = jnp.arange(1, op1.p.shape[0] + 1, dtype=op1.tau.dtype)
        p2 = g2[None] ** m[:, None, None, None]
    p = (op1.p * (op1.tau * op1.ssa)[None] + p2 * (tau2 * ssa2)[None]) / jnp.maximum(eps, tauscat12)[None]
    ssa = tauscat12 / jnp.maximum(eps, tau12)
    return dataclasses.replace(op1, tau=tau12, ssa=ssa, p=p)


# -- column subset (reference mo_optical_props.F90:723-874) ------------------

def subset(op: OpticalProps, start: int, n: int) -> OpticalProps:
    sl = slice(start, start + n)
    if isinstance(op, OpticalProps1scl):
        return dataclasses.replace(op, tau=op.tau[sl])
    if isinstance(op, OpticalProps2str):
        return dataclasses.replace(op, tau=op.tau[sl], ssa=op.ssa[sl], g=op.g[sl])
    return dataclasses.replace(op, tau=op.tau[sl], ssa=op.ssa[sl], p=op.p[:, sl])
