"""Shortwave RTE solvers.

Reference parity: ``rte/kernels/mo_rte_solver_kernels.F90`` --
``sw_solver_noscat`` (:496-532, direct-beam Beer-Lambert),
``sw_solver_2stream`` (:541-692) built on the fused
``sw_two_stream_source`` (:1364-1480: PIFM/Zdunkowski gammas, the ecRAD
single-precision-safe forms with the Rdir/Tdir clamping of :1467-1469 and
the k_min floor of :76-82) and the shared ``adding`` (:1526-1637).

Design: the direct beam is exp(-cumsum(tau/mu0)) -- a stable
closed form of the layer recurrence (exponents are nonpositive, so no
overflow) that XLA computes in one fused pass; layer reflectances/sources
are elementwise; diffuse transport is the adding method (see ops/adding).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import config
from .adding import adding
from .expfast import exp_fast, exp_maybe_fast as _exp


class SWSolution(NamedTuple):
    """Spectral fluxes (ncol, nlay+1, ngpt). flux_dn is the TOTAL downward
    flux (diffuse + direct); flux_dn_dir the direct beam alone."""

    flux_up: jnp.ndarray
    flux_dn: jnp.ndarray
    flux_dn_dir: jnp.ndarray


def _flip_lay(x):
    return jnp.flip(x, axis=1)


def direct_beam(tau, mu0, inc_flux_dir):
    """Direct-beam flux at all levels (canonical top-at-0).

    tau: (ncol, nlay, ngpt); mu0: (ncol,); inc_flux_dir: (ncol, ngpt) --
    already the flux on a horizontal plane at TOA times mu0 is applied here.
    Returns (ncol, nlay+1, ngpt).
    """
    mu0_inv = (1.0 / mu0)[:, None, None]
    if config.fast_exponential:
        # The reference applies exp_fast PER LAYER in the downward
        # recurrence (mo_rte_solver_kernels.F90:520-526); cumprod of the
        # per-layer Pade transmittances reproduces those per-layer
        # SEMANTICS (exp_fast(a)*exp_fast(b) != exp_fast(a+b), so the
        # closed form below would not). XLA may lower cumprod as a
        # log-depth associative scan, so the f32 product GROUPING can
        # differ from the sequential recurrence at the ulp level.
        atten = jnp.cumprod(exp_fast(-tau * mu0_inv), axis=1)
    else:
        atten = jnp.exp(-jnp.cumsum(tau * mu0_inv, axis=1))
    top = inc_flux_dir[:, None, :]
    return jnp.concatenate([top, top * atten], axis=1)


def direct_beam_lay_major(tau, mu0, inc_flux_dir):
    """direct_beam for (nlay, ncol, ngpt) tau: returns (nlay+1, ncol, ngpt)."""
    mu0_inv = (1.0 / mu0)[None, :, None]
    if config.fast_exponential:
        atten = jnp.cumprod(exp_fast(-tau * mu0_inv), axis=0)  # see direct_beam
    else:
        atten = jnp.exp(-jnp.cumsum(tau * mu0_inv, axis=0))
    top = inc_flux_dir[None, :, :]
    return jnp.concatenate([top, top * atten], axis=0)


def sw_solver_noscat(tau, mu0, inc_flux, top_at_1=True) -> jnp.ndarray:
    """Direct beam only (reference sw_solver_noscat, :496-532).

    inc_flux: (ncol, ngpt) TOA spectral flux; the solver applies mu0.
    Returns spectral direct flux (ncol, nlay+1, ngpt)."""
    if not top_at_1:
        tau = _flip_lay(tau)
    flux_dir = direct_beam(tau, mu0, inc_flux * mu0[:, None])
    if not top_at_1:
        flux_dir = _flip_lay(flux_dir)
    return flux_dir


def sw_two_stream_source(tau, ssa, g, mu0, sfc_alb_dir, flux_dn_dir):
    """Fused PIFM two-stream + direct-beam source (canonical top-at-0),
    reference sw_two_stream_source (:1364-1480).

    flux_dn_dir: (ncol, nlay+1, ngpt) precomputed direct beam.
    Returns (rdif, tdif, source_up, source_dn, source_sfc).
    """
    rdif, tdif, rdir, tdir, _ = _sw_two_stream_coeffs(
        tau, ssa, g, mu0[:, None, None])
    dir_inc = flux_dn_dir[:, :-1, :]
    source_up = rdir * dir_inc
    source_dn = tdir * dir_inc
    source_sfc = flux_dn_dir[:, -1, :] * sfc_alb_dir
    return rdif, tdif, source_up, source_dn, source_sfc


def _sw_two_stream_coeffs(tau_l, ssa_l, g_l, mu0b):
    """PIFM two-stream coefficients (rdif, tdif, rdir, tdir, tnoscat);
    elementwise over any layout (mu0b pre-broadcast against tau_l), shared
    by sw_two_stream_source and both fused broadband sweeps."""
    dtype = tau_l.dtype
    eps = jnp.finfo(dtype).eps
    # Zdunkowski Practical Improved Flux Method coefficients.
    gamma1 = (8.0 - ssa_l * (5.0 + 3.0 * g_l)) * 0.25
    gamma2 = 3.0 * (ssa_l * (1.0 - g_l)) * 0.25
    k = jnp.sqrt(jnp.maximum((gamma1 - gamma2) * (gamma1 + gamma2), config.k_min))
    # _exp honors config.fast_exponential (reference Tnoscat :1293,
    # exp_minusktau :1311 under -DFAST_EXPONENTIAL).
    tnoscat = _exp(-tau_l / mu0b)
    e1 = _exp(-tau_l * k)
    e2 = e1 * e1
    k2e = 2.0 * k * e1
    # Refactored to avoid rounding error when k and gamma1 differ in magnitude.
    rt_term = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    rdif = rt_term * gamma2 * (1.0 - e2)  # MW Eq 25
    tdif = rt_term * k2e  # MW Eq 26
    # Near the resonance k*mu0 == 1, Eqs 14-15 are a removable 0/0 that
    # float32 evaluates by cancellation (errors ~eps/|1 - k*mu0|; measured
    # 0.055 W/m2 of flux from one g-point at |1 - (k*mu0)^2| = 3e-5). There
    # they are evaluated at a mu0 moved by a relative sqrt(eps) away from
    # 1/k, which balances the rounding (~eps/shift) against the shift; the
    # direct beam itself keeps the true mu0.
    shift = float(eps) ** 0.5
    k_mu = k * mu0b
    near = jnp.abs(1.0 - k_mu) < shift
    mu0r = jnp.where(near, mu0b * jnp.where(k_mu < 1.0, 1.0 - shift,
                                            1.0 + shift), mu0b)
    tnoscat_r = jnp.where(near, _exp(-tau_l / mu0r), tnoscat)
    gamma3 = (2.0 - 3.0 * mu0r * g_l) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3  # MW Eq 16
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4  # MW Eq 17
    k_mu = k * mu0r
    k_mu2 = k_mu * k_mu
    k_g3 = k * gamma3
    k_g4 = k * gamma4
    # Divide by (1 - k_mu^2) guarded by eps (the resonance k*mu0 == 1).
    denom = jnp.where(jnp.abs(1.0 - k_mu2) >= eps, 1.0 - k_mu2, eps)
    rt2 = ssa_l * rt_term / denom
    # MW Eq 14 (reflectance to direct beam), ecRAD arrangement.
    rdir = rt2 * (
        (1.0 - k_mu) * (alpha2 + k_g3)
        - (1.0 + k_mu) * (alpha2 - k_g3) * e2
        - k2e * (gamma3 - alpha2 * mu0r) * tnoscat_r
    )
    # MW Eq 15 (diffuse transmittance of direct beam), direct part omitted.
    tdir = rt2 * (
        k2e * (gamma4 + alpha1 * mu0r)
        - tnoscat_r * ((1.0 + k_mu) * (alpha1 + k_g4) - (1.0 - k_mu) * (alpha1 - k_g4) * e2)
    )
    # Energy-safety clamps (credit Robin Hogan / ecRAD; reference :1467-1469).
    rdir = jnp.clip(rdir, 0.0, 1.0 - tnoscat)
    tdir = jnp.clip(tdir, 0.0, 1.0 - tnoscat - rdir)
    return rdif, tdif, rdir, tdir, tnoscat


def _sw_2stream_broadband_fused(tau, ssa, g, mu0, inc_flux_dir, sfc_alb_dir,
                                sfc_alb_dif, inc_flux_dif, lay_major=False):
    """Fused broadband SW two-stream + adding (canonical top-at-0).

    The two-stream coefficients and direct-beam sources are computed inside
    BOTH adding sweeps (recomputation is cheaper than round-
    tripping rdif/tdif/source arrays through HBM); only the direct beam and
    the cumulative albedo/source stacks are materialized. Returns
    (bb_up, bb_dn_total, bb_dir), each (ncol, nlay+1).

    lay_major=True: tau/ssa/g are (nlay, ncol, ngpt) -- the scan layout,
    so no transposed copies are materialized; surface/TOA arrays and the
    returned broadband fluxes keep their column-major shapes."""
    dtype = jnp.result_type(
        tau.dtype, ssa.dtype, g.dtype, inc_flux_dir.dtype,
        sfc_alb_dir.dtype, sfc_alb_dif.dtype, inc_flux_dif.dtype,
    )
    tau, ssa, g = tau.astype(dtype), ssa.astype(dtype), g.astype(dtype)
    inc_flux_dir = inc_flux_dir.astype(dtype)
    sfc_alb_dir, sfc_alb_dif = sfc_alb_dir.astype(dtype), sfc_alb_dif.astype(dtype)
    inc_flux_dif = inc_flux_dif.astype(dtype)
    mu0 = mu0.astype(dtype)

    if lay_major:
        dir_levels = direct_beam_lay_major(tau, mu0, inc_flux_dir)
        tau_l, ssa_l, g_l = tau, ssa, g
        dir_top_l = dir_levels[:-1]
        dir_next_l = dir_levels[1:]
        dir_sfc = dir_levels[-1]
        bb_dir = jnp.sum(dir_levels, -1).T  # (ncol, nlay+1)
    else:
        flux_dn_dir = direct_beam(tau, mu0, inc_flux_dir)
        tau_l = jnp.moveaxis(tau, 1, 0)
        ssa_l = jnp.moveaxis(ssa, 1, 0)
        g_l = jnp.moveaxis(g, 1, 0)
        dir_top_l = jnp.moveaxis(flux_dn_dir[:, :-1, :], 1, 0)  # incident on layer top
        dir_next_l = jnp.moveaxis(flux_dn_dir[:, 1:, :], 1, 0)
        dir_sfc = flux_dn_dir[:, -1, :]
        bb_dir = jnp.sum(flux_dn_dir, -1)

    mu0c = mu0[:, None]

    # ---- surface-to-top sweep: cumulative albedo and upwelling source ----
    # Emits the PRE-update carry: when processing layer l (bottom-up) the
    # incoming carry is (albedo, source) at level l+1 -- exactly what the
    # downward sweep needs as alb_below/src_below. Stacking that instead
    # of the post-update value avoids re-assembling shifted copies of two
    # (nlay, ncol, ngpt) arrays afterwards (a pair of HBM round-trips).
    def up(carry, xs):
        alb_below, src_below = carry
        tl, wl, gl, dinc = xs
        rdif, tdif, rdir, tdir, _ = _sw_two_stream_coeffs(tl, wl, gl, mu0c)
        src_up = rdir * dinc
        src_dn = tdir * dinc
        d = 1.0 / (1.0 - rdif * alb_below)
        alb = rdif + tdif * tdif * alb_below * d
        src = src_up + tdif * d * (src_below + alb_below * src_dn)
        return (alb, src), (alb_below, src_below)

    alb_sfc = sfc_alb_dif
    src_sfc = dir_sfc * sfc_alb_dir
    # reverse=True walks surface-to-top and stacks outputs in layer order
    # directly -- no reversed copies of the four scan inputs in HBM
    (alb_top, src_top), (alb_below_l, src_below_l) = jax.lax.scan(
        up, (alb_sfc, src_sfc),
        (tau_l, ssa_l, g_l, dir_top_l),
        reverse=True,
    )

    # ---- top-to-surface flux sweep with in-scan broadband reduction ------
    def down(fdn, xs):
        tl, wl, gl, dinc, alb_b, src_b, dir_next = xs
        rdif, tdif, rdir, tdir, _ = _sw_two_stream_coeffs(tl, wl, gl, mu0c)
        src_dn = tdir * dinc
        d = 1.0 / (1.0 - rdif * alb_b)
        fdn_next = (tdif * fdn + rdif * src_b + src_dn) * d
        fup_next = fdn_next * alb_b + src_b
        return fdn_next, (
            jnp.sum(fdn_next, -1) + jnp.sum(dir_next, -1),
            jnp.sum(fup_next, -1),
        )

    _, (dn_sums, up_sums) = jax.lax.scan(
        down, inc_flux_dif,
        (tau_l, ssa_l, g_l, dir_top_l, alb_below_l, src_below_l, dir_next_l),
    )
    bb_dn0 = jnp.sum(inc_flux_dif, -1) + bb_dir[:, 0]
    bb_up0 = jnp.sum(inc_flux_dif * alb_top + src_top, -1)
    bb_dn = jnp.concatenate([bb_dn0[:, None], jnp.moveaxis(dn_sums, 0, 1)], 1)
    bb_up = jnp.concatenate([bb_up0[:, None], jnp.moveaxis(up_sums, 0, 1)], 1)
    return bb_up, bb_dn, bb_dir


def sw_solver_2stream(
    tau,
    ssa,
    g,
    mu0,
    inc_flux,
    sfc_alb_dir,
    sfc_alb_dif,
    inc_flux_dif=None,
    top_at_1=True,
    scan_mode="sequential",
    broadband=False,
) -> SWSolution:
    """Full SW two-stream + adding solve (reference sw_solver_2stream).

    inc_flux: (ncol, ngpt) TOA direct spectral flux (before mu0 weighting);
    sfc_alb_dir/dif: (ncol, ngpt) per-g-point surface albedos (expansion to
    g-points happens outside, as in this fork's rte_sw, mo_rte_sw.F90:180-186).
    With ``broadband=True`` the diffuse transport reduces spectrally inside
    the adding sweep and the returned fluxes are (ncol, nlay+1) sums (the
    analogue of the reference's fused up/dn/dir reductions, :640-689).
    """
    ncol, nlay, ngpt = tau.shape
    dtype = tau.dtype
    if inc_flux_dif is None:
        inc_flux_dif = jnp.zeros((ncol, ngpt), dtype)

    if not top_at_1:
        tau, ssa, g = _flip_lay(tau), _flip_lay(ssa), _flip_lay(g)

    if broadband:
        bb_up, bb_dn, bb_dir = _sw_2stream_broadband_fused(
            tau, ssa, g, mu0, inc_flux * mu0[:, None], sfc_alb_dir, sfc_alb_dif,
            inc_flux_dif,
        )
        if not top_at_1:
            bb_up, bb_dn = _flip_lay(bb_up), _flip_lay(bb_dn)
            bb_dir = _flip_lay(bb_dir)
        return SWSolution(bb_up, bb_dn, bb_dir)

    flux_dn_dir = direct_beam(tau, mu0, inc_flux * mu0[:, None])
    rdif, tdif, source_up, source_dn, source_sfc = sw_two_stream_source(
        tau, ssa, g, mu0, sfc_alb_dir, flux_dn_dir
    )
    flux_up, flux_dn = adding(
        sfc_alb_dif, rdif, tdif, source_dn, source_up, source_sfc, inc_flux_dif,
        mode=scan_mode,
    )
    flux_dn = flux_dn + flux_dn_dir  # adding yields diffuse only; total = + direct

    if not top_at_1:
        flux_up, flux_dn = _flip_lay(flux_up), _flip_lay(flux_dn)
        flux_dn_dir = _flip_lay(flux_dn_dir)
    return SWSolution(flux_up, flux_dn, flux_dn_dir)


def sw_solver_2stream_lay_major(
    tau, ssa, g, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif, inc_flux_dif=None,
) -> SWSolution:
    """Layer-major broadband SW two-stream + adding (canonical top-at-0):
    tau/ssa/g (nlay, ncol, ngpt), surface/TOA arrays (ncol, ngpt). Returns
    broadband (ncol, nlay+1) fluxes (up, dn_total, dn_dir).

    The transpose-free fast path for layer-major gas optics: the adding
    sweeps consume the inputs as laid out instead of materializing
    moveaxis'd copies (see sw_solver_2stream broadband path)."""
    nlay, ncol, ngpt = tau.shape
    if inc_flux_dif is None:
        inc_flux_dif = jnp.zeros((ncol, ngpt), tau.dtype)
    bb_up, bb_dn, bb_dir = _sw_2stream_broadband_fused(
        tau, ssa, g, mu0, inc_flux * mu0[:, None], sfc_alb_dir, sfc_alb_dif,
        inc_flux_dif, lay_major=True,
    )
    return SWSolution(bb_up, bb_dn, bb_dir)
