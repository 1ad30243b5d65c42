"""Longwave RTE solvers.

Reference parity: ``rte/kernels/mo_rte_solver_kernels.F90`` --
``lw_solver_noscat`` (:119-330), ``lw_solver_noscat_GaussQuad`` (:332-415),
``lw_solver_2stream`` (:426-486), ``lw_source_noscat`` (:742-776, Clough 1992
Eq 13 with the Blossey series expansion below tau_thresh), ``lw_two_stream``
(:1018-1069, Meador-Weaver with LW diffusivity secant 1.66),
``lw_source_2str`` (:1112-1162, Toon 1989), Tang-2018 rescaling
(``lw_transport_1rescl`` :1729-1795 with Cn = 0.4*wb/scaleTau :211-233), and
the Gauss quadrature table of ``rte/mo_rte_lw.F90:113-125``.

Design:
  - arrays are (ncol, nlay, ngpt), g-points minor.
  - all transports are affine layer recurrences solved with
    ``ops.scan.affine_scan`` (lax.scan or log-depth associative scan).
  - orientation is canonicalized to top-at-index-0 by flipping, so both
    vertical orientations share one code path. (The reference's
    ``lw_source_noscat`` computes sources in the top-at-1 convention
    regardless of orientation and relies on the transport branches; flipping
    makes the vertical-reverse invariant hold by construction.)
  - no data-dependent control flow: the tau_thresh branch is jnp.where, the
    quadrature-angle loop is unrolled (nmus <= 4, static).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MATMUL_PRECISION, config
from .scan import affine_scan, affine_scan_reverse
from .adding import adding

# Gauss quadrature secants/weights, Table 2 of Clough et al. 1992
# (reference rte/mo_rte_lw.F90:113-125). Row n-1 holds the n-angle set.
GAUSS_DS = np.array(
    [
        [1.66, 0.0, 0.0, 0.0],  # diffusivity angle
        [1.18350343, 2.81649655, 0.0, 0.0],
        [1.09719858, 1.69338507, 4.70941630, 0.0],
        [1.06056257, 1.38282560, 2.40148179, 7.15513024],
    ]
)
GAUSS_WTS = np.array(
    [
        [0.5, 0.0, 0.0, 0.0],
        [0.3180413817, 0.1819586183, 0.0, 0.0],
        [0.2009319137, 0.2292411064, 0.0698269799, 0.0],
        [0.1355069134, 0.2034645680, 0.1298475476, 0.0311809710],
    ]
)


# Pade approximant applied to x/8, squared three times, when
# config.fast_exponential (reference exp_fast,
# mo_rte_solver_kernels.F90:90-106); shared with the SW solvers.
from .expfast import exp_maybe_fast as _exp


def _flip_lay(x):
    return jnp.flip(x, axis=1)


def _noscat_sources(tl, trans, lay, lev_t, lev_b, tau_thresh):
    """(src_dn, src_up) for the no-scat transport from the optical path tl
    and its transmittance: the linear-in-tau form by default, or the Pade
    form when config.use_pade_source (reference lw_source_noscat,
    mo_rte_solver_kernels.F90; Clough et al. 1992 Eq 15). Shared by every
    broadband fast path so the flag is honored everywhere."""
    one_m_t = 1.0 - trans
    if config.use_pade_source:
        coeff = 0.2 * tl
        denom = 1.0 + coeff
        return (one_m_t * (lay + coeff * lev_b) / denom,
                one_m_t * (lay + coeff * lev_t) / denom)
    tl_safe = jnp.where(tl > tau_thresh, tl, 1.0)
    fact = jnp.where(
        tl > tau_thresh,
        (1.0 - trans) / tl_safe - trans,
        tl * (0.5 - (1.0 / 3.0) * tl),
    )
    two_fact = 2.0 * fact
    return (one_m_t * lev_b + two_fact * (lay - lev_b),
            one_m_t * lev_t + two_fact * (lay - lev_t))


class LWSolution(NamedTuple):
    """Spectral fluxes (ncol, nlay+1, ngpt), W/m2, level 0 = top of domain
    in the caller's orientation. In broadband mode the arrays are
    (ncol, nlay+1) spectral sums."""

    flux_up: jnp.ndarray
    flux_dn: jnp.ndarray
    flux_up_jac: Optional[jnp.ndarray] = None
    # Surface-temperature Jacobian of the DOWN flux: identically zero in the
    # no-scat solver (downwelling radiation never sees the surface). The
    # reference accepts an optional flux_dn_Jac output but never writes it
    # (mo_rte_lw.F90:85, computation commented out :398-405); we expose the
    # exact value instead. Populated (with zeros) whenever flux_up_jac is.
    flux_dn_jac: Optional[jnp.ndarray] = None


def _affine_scan_broadband(trans, source, r0):
    """Downward affine recurrence emitting per-level spectral sums instead
    of the full radiance field: scan carry is the (ncol, ngpt) radiance,
    outputs are (ncol,) broadband sums -- the in-scan reduction that keeps
    gpt-resolved fluxes out of device memory (the analogue of the reference's
    inlined 4-way-unrolled broadband reduction,
    mo_rte_solver_kernels.F90:296-320). Returns (bb_levels, r_last)."""

    def step(r, ts):
        t, s = ts
        r_next = t * r + s
        return r_next, jnp.sum(r_next, axis=-1)

    t = jnp.moveaxis(trans, 1, 0)
    s = jnp.moveaxis(source, 1, 0)
    r_last, sums = jax.lax.scan(step, r0, (t, s))
    bb = jnp.concatenate([jnp.sum(r0, -1)[:, None], jnp.moveaxis(sums, 0, 1)], axis=1)
    return bb, r_last


def _affine_scan_broadband_reverse(trans, source, r_last):
    # lax.scan(reverse=True) iterates bottom-up without materializing
    # reversed copies of the (ncol, nlay, ngpt) inputs (each flip is a
    # full HBM round-trip at RFMIP scale).
    def step(r, ts):
        t, s = ts
        r_next = t * r + s
        return r_next, jnp.sum(r_next, axis=-1)

    t = jnp.moveaxis(trans, 1, 0)
    s = jnp.moveaxis(source, 1, 0)
    r_top, sums = jax.lax.scan(step, r_last, (t, s), reverse=True)
    bb = jnp.concatenate([jnp.moveaxis(sums, 0, 1), jnp.sum(r_last, -1)[:, None]], axis=1)
    return bb, r_top


def lw_source_noscat(tau_loc, trans, lay_source, lev_source):
    """Linear-in-tau layer sources (canonical top-at-0); the spectral-path
    front-end of the shared ``_noscat_sources`` math (the double-where
    there guards the unselected branch's backward pass: 1/tau at tau -> 0
    would otherwise produce Inf * 0 = NaN gradients).

    Returns (source_dn, source_up), each (ncol, nlay, ngpt).
    source_dn exits the layer bottom (level l+1), source_up the top (level l).
    """
    tau_thresh = jnp.sqrt(jnp.finfo(tau_loc.dtype).eps)
    return _noscat_sources(
        tau_loc, trans, lay_source,
        lev_source[:, :-1, :], lev_source[:, 1:, :], tau_thresh)


def _lw_noscat_broadband_fused(
    tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux, D, weight,
    sfc_source_jac=None, lay_major=False,
):
    """Fully-fused broadband no-scat solve: optical path, transmittance,
    linear-in-tau sources, transport, and spectral reduction all inside the
    two layer scans -- no (ncol, nlay, ngpt) intermediates ever reach HBM.
    The up-sweep recomputes trans/source_up from tau (one extra exp) rather
    than storing them, trading one exp for a device-memory round trip. Canonical top-at-0; single angle.

    lay_major=True: tau/lay_source are (nlay, ncol, ngpt) and lev_source
    (nlay+1, ncol, ngpt) -- already in scan layout, so no transposed
    copies of the three large fields are materialized (the layout the
    layer-major gas-optics path produces). Surface/TOA arrays and the
    returned (ncol, nlay+1) broadband fluxes are unchanged."""
    dtype = tau.dtype
    two_pi_w = jnp.asarray(2.0 * np.pi * weight, dtype)
    tau_thresh = jnp.sqrt(jnp.finfo(dtype).eps)

    if lay_major:
        Db = D[None, :, :] if D.ndim == 2 else D
        tau_l = tau * Db
        lay_l = lay_source
        if isinstance(lev_source, tuple):
            lev_top_l, lev_bot_l = lev_source  # pre-split per-layer views
        else:
            lev_top_l = lev_source[:-1]
            lev_bot_l = lev_source[1:]
    else:
        Db = D[:, None, :] if D.ndim == 2 else D
        tau_l = jnp.moveaxis(tau * Db, 1, 0)  # (nlay, ncol, ngpt) optical path
        lay_l = jnp.moveaxis(lay_source, 1, 0)
        lev_top_l = jnp.moveaxis(lev_source[:, :-1, :], 1, 0)
        lev_bot_l = jnp.moveaxis(lev_source[:, 1:, :], 1, 0)

    def sources_of(tl, lay, lev_t, lev_b):
        trans = _exp(-tl)
        src_dn, src_up = _noscat_sources(
            tl, trans, lay, lev_t, lev_b, tau_thresh)
        return trans, src_dn, src_up

    def down(rad, xs):
        tl, lay, lev_t, lev_b = xs
        trans, src_dn, _ = sources_of(tl, lay, lev_t, lev_b)
        rad_next = trans * rad + src_dn
        return rad_next, jnp.sum(rad_next, -1)

    rad_top = inc_flux / two_pi_w
    rad_sfc_dn, dn_sums = jax.lax.scan(down, rad_top, (tau_l, lay_l, lev_top_l, lev_bot_l))
    bb_dn = jnp.concatenate([jnp.sum(rad_top, -1)[:, None], jnp.moveaxis(dn_sums, 0, 1)], 1)

    rad_sfc = rad_sfc_dn * (1.0 - sfc_emis) + sfc_emis * sfc_source

    def up(carry, xs):
        rad, jac = carry
        tl, lay, lev_t, lev_b = xs
        trans, _, src_up = sources_of(tl, lay, lev_t, lev_b)
        rad_next = trans * rad + src_up
        jac_next = trans * jac
        return (rad_next, jac_next), (jnp.sum(rad_next, -1), jnp.sum(jac_next, -1))

    jac_sfc = (
        sfc_emis * sfc_source_jac if sfc_source_jac is not None else jnp.zeros_like(rad_sfc)
    )
    # reverse=True walks bottom-up and stacks outputs in layer order --
    # no reversed copies of the three (nlay, ncol, ngpt) inputs in HBM
    (_, _), (up_sums, jac_sums) = jax.lax.scan(
        up, (rad_sfc, jac_sfc),
        (tau_l, lay_l, lev_top_l, lev_bot_l),
        reverse=True,
    )
    bb_up = jnp.concatenate(
        [jnp.moveaxis(up_sums, 0, 1), jnp.sum(rad_sfc, -1)[:, None]], 1
    )
    flux_up_jac = None
    if sfc_source_jac is not None:
        flux_up_jac = jnp.concatenate(
            [jnp.moveaxis(jac_sums, 0, 1), jnp.sum(jac_sfc, -1)[:, None]], 1
        ) * two_pi_w
    return LWSolution(bb_up * two_pi_w, bb_dn * two_pi_w, flux_up_jac)


def lw_noscat_broadband_from_pfrac(
    tau,
    pfrac,
    planck_lay,
    planck_lev,
    planck_sfc,
    planck_sfc_jac,
    one_hot,
    sfc_emis,
    inc_flux=None,
    D=None,
    weight=0.5,
    top_at_1=True,
    compute_jac=False,
):
    """End-to-end fused LW no-scat broadband solve straight from the Planck
    fraction: the per-layer sources (pfrac x band-Planck, expanded to
    g-points with a one-hot matmul) are computed INSIDE the scan bodies, so
    neither lay_source nor lev_source ever reaches HBM. This fuses the
    reference's compute_Planck_source_nn + lw_solver_noscat pipeline
    (mo_gas_optics_kernels.F90:615-683 + mo_rte_solver_kernels.F90:119-330).

    It trades 60 per-step (ncol, nband) @ (nband, ngpt) products inside the
    scans for the lay/lev_source traffic; it removes two (ncol, nlay, ngpt)
    arrays from the footprint (for memory-limited cases).

    tau, pfrac: (ncol, nlay, ngpt); planck_lay: (ncol, nlay, nband);
    planck_lev: (ncol, nlay+1, nband); planck_sfc[_jac]: (ncol, nband);
    one_hot: (nband, ngpt); sfc_emis: (ncol, ngpt) per-g-point.
    """
    ncol, nlay, ngpt = tau.shape
    dtype = tau.dtype
    if not top_at_1:
        tau, pfrac = _flip_lay(tau), _flip_lay(pfrac)
        planck_lay, planck_lev = _flip_lay(planck_lay), _flip_lay(planck_lev)
    if D is None:
        D = jnp.full((ncol, ngpt), GAUSS_DS[0, 0], dtype)
    if inc_flux is None:
        inc_flux = jnp.zeros((ncol, ngpt), dtype)
    two_pi_w = jnp.asarray(2.0 * np.pi * weight, dtype)
    tau_thresh = jnp.sqrt(jnp.finfo(dtype).eps)

    tau_l = jnp.moveaxis(tau * D[:, None, :], 1, 0)
    pf_l = jnp.moveaxis(pfrac, 1, 0)
    pf_next = jnp.concatenate([pf_l[1:], pf_l[-1:]], 0)  # level l+1 takes layer min(l+1, nlay-1)
    blay_l = jnp.moveaxis(planck_lay, 1, 0)
    blev_l = jnp.moveaxis(planck_lev[:, :-1, :], 1, 0)
    blev_next = jnp.moveaxis(planck_lev[:, 1:, :], 1, 0)
    oh = one_hot.astype(dtype)
    expand = lambda b: jnp.dot(b, oh, precision=MATMUL_PRECISION)

    def sources_of(tl, pf, pfn, bla, ble, blen):
        trans = _exp(-tl)
        lay = pf * expand(bla)
        lev_t = pf * expand(ble)
        lev_b = pfn * expand(blen)
        src_dn, src_up = _noscat_sources(
            tl, trans, lay, lev_t, lev_b, tau_thresh)
        return trans, src_dn, src_up

    def down(rad, xs):
        trans, src_dn, _ = sources_of(*xs)
        rad_next = trans * rad + src_dn
        return rad_next, jnp.sum(rad_next, -1)

    xs = (tau_l, pf_l, pf_next, blay_l, blev_l, blev_next)
    rad_top = inc_flux / two_pi_w
    rad_sfc_dn, dn_sums = jax.lax.scan(down, rad_top, xs)
    bb_dn = jnp.concatenate([jnp.sum(rad_top, -1)[:, None], jnp.moveaxis(dn_sums, 0, 1)], 1)

    pf_sfc = pfrac[:, -1, :]
    sfc_source = pf_sfc * expand(planck_sfc)
    rad_sfc = rad_sfc_dn * (1.0 - sfc_emis) + sfc_emis * sfc_source

    def up(carry, xs_):
        rad, jac = carry
        trans, _, src_up = sources_of(*xs_)
        rad_next = trans * rad + src_up
        jac_next = trans * jac
        return (rad_next, jac_next), (jnp.sum(rad_next, -1), jnp.sum(jac_next, -1))

    jac_sfc = (
        sfc_emis * (pf_sfc * expand(planck_sfc_jac - planck_sfc))
        if compute_jac
        else jnp.zeros_like(rad_sfc)
    )
    # reverse=True: bottom-up sweep, outputs stacked in layer order, no
    # reversed copies of the six scan inputs in HBM
    (_, _), (up_sums, jac_sums) = jax.lax.scan(
        up, (rad_sfc, jac_sfc), xs, reverse=True
    )
    bb_up = jnp.concatenate(
        [jnp.moveaxis(up_sums, 0, 1), jnp.sum(rad_sfc, -1)[:, None]], 1
    )
    jac_bb = None
    if compute_jac:
        jac_bb = jnp.concatenate(
            [jnp.moveaxis(jac_sums, 0, 1), jnp.sum(jac_sfc, -1)[:, None]], 1
        ) * two_pi_w
    out = LWSolution(bb_up * two_pi_w, bb_dn * two_pi_w, jac_bb)
    if not top_at_1:
        out = LWSolution(
            _flip_lay(out.flux_up), _flip_lay(out.flux_dn),
            None if jac_bb is None else _flip_lay(out.flux_up_jac),
        )
    return out


def _lw_noscat_broadband_presrc(
    tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux, D, weight,
    sfc_source_jac=None,
):
    """Broadband no-scat solve with PRECOMPUTED per-sweep fields: trans,
    src_dn, src_up are produced in one fused elementwise pass over the
    (nlay, ncol, ngpt) batch, so each scan consumes only TWO xs arrays
    (trans + its source) instead of four (tau, lay, lev_top, lev_bot).

    Rationale (docs/PERFORMANCE.md roofline): the scans are HBM-bound on
    their xs streams; 4 xs -> 2 xs halves the dominant traffic term, and
    the one-time write of the three precomputed fields is cheaper than
    re-streaming lay/lev sources through both sweeps. The recompute-in-sweep
    variant (_lw_noscat_broadband_fused) re-reads 4 fields per sweep =
    8 x 55 MB at RFMIP scale; this path writes 3 + reads 2+2 = 7, with the
    exp/fact arithmetic done once instead of twice.

    Layer-major only (tau/lay_source (nlay, ncol, ngpt), lev_source
    (nlay+1, ncol, ngpt) or a pre-split (lev_top, lev_bot) tuple).
    Canonical top-at-0, single angle."""
    tau_thresh = jnp.sqrt(jnp.finfo(tau.dtype).eps)

    Db = D[None, :, :] if D.ndim == 2 else D
    tl = tau * Db
    if isinstance(lev_source, tuple):
        lev_top, lev_bot = lev_source
    else:
        lev_top = lev_source[:-1]
        lev_bot = lev_source[1:]

    trans = _exp(-tl)
    src_dn, src_up = _noscat_sources(
        tl, trans, lay_source, lev_top, lev_bot, tau_thresh)
    return lw_broadband_sweeps(
        trans, src_dn, src_up, sfc_emis, sfc_source, inc_flux, weight,
        sfc_source_jac,
    )


def lw_broadband_sweeps(
    trans, src_dn, src_up, sfc_emis, sfc_source, inc_flux=None,
    weight=GAUSS_WTS[0, 0], sfc_source_jac=None,
):
    """The two broadband layer sweeps from PRECOMPUTED layer-major
    transmittance and sources: down then (after surface reflection +
    emission) up, each a minimal 2-xs affine lax.scan with in-scan spectral
    reduction. trans/src_dn/src_up: (nlay, ncol, ngpt); surface arrays
    (ncol, ngpt). Canonical top-at-0; returns broadband (ncol, nlay+1)
    LWSolution (reference transport loops mo_rte_solver_kernels.F90:264-330).
    """
    dtype = trans.dtype
    two_pi_w = jnp.asarray(2.0 * np.pi * weight, dtype)
    if inc_flux is None:
        inc_flux = jnp.zeros(trans.shape[1:], dtype)

    def down(rad, ts):
        t, s = ts
        rad_next = t * rad + s
        return rad_next, jnp.sum(rad_next, -1)

    rad_top = inc_flux / two_pi_w
    rad_sfc_dn, dn_sums = jax.lax.scan(down, rad_top, (trans, src_dn))
    bb_dn = jnp.concatenate(
        [jnp.sum(rad_top, -1)[:, None], jnp.moveaxis(dn_sums, 0, 1)], 1
    )

    rad_sfc = rad_sfc_dn * (1.0 - sfc_emis) + sfc_emis * sfc_source

    if sfc_source_jac is not None:

        def up_jac(carry, ts):
            rad, jac = carry
            t, s = ts
            rad_next = t * rad + s
            jac_next = t * jac
            return (rad_next, jac_next), (
                jnp.sum(rad_next, -1), jnp.sum(jac_next, -1)
            )

        jac_sfc = sfc_emis * sfc_source_jac
        (_, _), (up_sums, jac_sums) = jax.lax.scan(
            up_jac, (rad_sfc, jac_sfc), (trans, src_up), reverse=True
        )
        flux_up_jac = jnp.concatenate(
            [jnp.moveaxis(jac_sums, 0, 1), jnp.sum(jac_sfc, -1)[:, None]], 1
        ) * two_pi_w
    else:
        _, up_sums = jax.lax.scan(down, rad_sfc, (trans, src_up), reverse=True)
        flux_up_jac = None
    bb_up = jnp.concatenate(
        [jnp.moveaxis(up_sums, 0, 1), jnp.sum(rad_sfc, -1)[:, None]], 1
    )
    return LWSolution(bb_up * two_pi_w, bb_dn * two_pi_w, flux_up_jac)


def _lw_solver_noscat_1angle(
    tau,
    lay_source,
    lev_source,
    sfc_emis,
    sfc_source,
    inc_flux,
    D,
    weight,
    sfc_source_jac=None,
    ssa=None,
    g=None,
    do_rescaling=False,
    scan_mode="sequential",
    broadband=False,
):
    """Single-angle no-scattering solve, canonical top-at-0 orientation.

    tau: (ncol, nlay, ngpt); D: (ncol, ngpt) secants; weight: scalar.
    Returns LWSolution of spectral fluxes; with ``broadband=True`` (not
    supported with rescaling) the fluxes are reduced inside the layer scans
    and only (ncol, nlay+1) broadband sums are produced.
    """
    dtype = tau.dtype
    two_pi_w = jnp.asarray(2.0 * np.pi * weight, dtype)

    if broadband and not do_rescaling and not config.use_pade_source:
        return _lw_noscat_broadband_fused(
            tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux,
            D, weight, sfc_source_jac,
        )

    if do_rescaling:
        # Tang et al. 2018 scaling for scattering within a no-scat transport
        # (reference mo_rte_solver_kernels.F90:211-233).
        wb = ssa * (1.0 - g) * 0.5
        scale_tau = 1.0 - ssa + wb
        Cn = 0.4 * wb / scale_tau
        tau_loc = tau * D[:, None, :] * scale_tau
        trans = jnp.exp(-tau_loc)
        An = 1.0 - trans * trans
    else:
        tau_loc = tau * D[:, None, :]
        trans = _exp(-tau_loc)

    source_dn, source_up = lw_source_noscat(tau_loc, trans, lay_source, lev_source)

    # Downward: intensity BC at top, affine recurrence through layers.
    rad_top = inc_flux / two_pi_w

    if broadband and not do_rescaling:
        bb_dn, rad_dn_sfc = _affine_scan_broadband(trans, source_dn, rad_top)
        rad_sfc = rad_dn_sfc * (1.0 - sfc_emis) + sfc_emis * sfc_source
        bb_up, _ = _affine_scan_broadband_reverse(trans, source_up, rad_sfc)
        flux_up_jac = None
        if sfc_source_jac is not None:
            jac_sfc = sfc_emis * sfc_source_jac
            bb_jac, _ = _affine_scan_broadband_reverse(
                trans, jnp.zeros_like(source_up), jac_sfc
            )
            flux_up_jac = bb_jac * two_pi_w
        return LWSolution(bb_up * two_pi_w, bb_dn * two_pi_w, flux_up_jac)

    rad_dn = affine_scan(trans, source_dn, rad_top, axis=1, mode=scan_mode)

    # Surface reflection + emission (reference :269).
    rad_sfc = rad_dn[:, -1, :] * (1.0 - sfc_emis) + sfc_emis * sfc_source

    if do_rescaling:
        # Upward with adjustment from the downward radiances
        # (lw_transport_1rescl, top_at_1 branch).
        adj_up = Cn * (An * rad_dn[:, :-1, :] - trans * source_dn - source_up)
        rad_up = affine_scan_reverse(trans, source_up + adj_up, rad_sfc, axis=1, mode=scan_mode)
        # Second downward pass with adjustment from the upward radiances.
        adj_dn = Cn * (An * rad_up[:, :-1, :] - trans * source_up - source_dn)
        rad_dn = affine_scan(trans, source_dn + adj_dn, rad_top, axis=1, mode=scan_mode)
    else:
        rad_up = affine_scan_reverse(trans, source_up, rad_sfc, axis=1, mode=scan_mode)

    flux_up_jac = None
    if sfc_source_jac is not None:
        # Jacobian propagates with transmission only: cumulative product of
        # trans from the surface upward == exp(-reverse-cumsum(tau_loc)).
        jac_sfc = sfc_emis * sfc_source_jac
        if config.fast_exponential and not do_rescaling:
            # exp_fast(a)*exp_fast(b) != exp_fast(a+b): the Jacobian must
            # ride the SAME per-layer Pade transmittances as the fluxes
            # (reference propagates it through the trans recurrence,
            # mo_rte_lw.F90 Jacobian branch)
            prod_up = jnp.flip(jnp.cumprod(jnp.flip(trans, 1), axis=1), 1)
        else:
            # suffix sum without materialized flips; in exact-exp mode
            # exp(-cumsum) is the mathematically-equal, lower-error form
            # of the per-layer trans product (see the SW direct beam note)
            prod_up = jnp.exp(-jax.lax.cumsum(tau_loc, axis=1, reverse=True))
        flux_up_jac = jnp.concatenate(
            [prod_up * jac_sfc[:, None, :], jac_sfc[:, None, :]], axis=1
        ) * two_pi_w

    return LWSolution(rad_up * two_pi_w, rad_dn * two_pi_w, flux_up_jac)


def lw_solver_noscat(
    tau,
    lay_source,
    lev_source,
    sfc_emis,
    sfc_source,
    inc_flux=None,
    top_at_1=True,
    n_gauss_angles=1,
    lw_ds=None,
    sfc_source_jac=None,
    ssa=None,
    g=None,
    do_rescaling=False,
    scan_mode="sequential",
    broadband=False,
) -> LWSolution:
    """No-scattering LW solve with first-order Gaussian quadrature.

    Reference parity: lw_solver_noscat_GaussQuad (mo_rte_solver_kernels
    .F90:332-415). ``lw_ds`` (ncol, ngpt) optional per-g-point secants
    (the optimal-angle path, mo_rte_lw.F90:329-341) -- used with one angle.
    ``broadband=True`` reduces spectrally inside the scans (no gpt-resolved
    flux arrays are materialized); unsupported with rescaling.
    """
    ncol, nlay, ngpt = tau.shape
    dtype = tau.dtype
    broadband = broadband and not do_rescaling
    if inc_flux is None:
        inc_flux = jnp.zeros((ncol, ngpt), dtype)

    if not top_at_1:
        tau, lay_source = _flip_lay(tau), _flip_lay(lay_source)
        lev_source = _flip_lay(lev_source)
        if ssa is not None:
            ssa, g = _flip_lay(ssa), _flip_lay(g)

    if lw_ds is not None:
        sols = [
            _lw_solver_noscat_1angle(
                tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux,
                lw_ds.astype(dtype), GAUSS_WTS[0, 0], sfc_source_jac,
                ssa, g, do_rescaling, scan_mode, broadband,
            )
        ]
    else:
        n = n_gauss_angles
        if not 1 <= n <= 4:
            raise ValueError("n_gauss_angles must be in 1..4")
        sols = []
        for imu in range(n):
            D = jnp.full((ncol, ngpt), GAUSS_DS[n - 1, imu], dtype)
            sols.append(
                _lw_solver_noscat_1angle(
                    tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux,
                    D, GAUSS_WTS[n - 1, imu], sfc_source_jac,
                    ssa, g, do_rescaling, scan_mode, broadband,
                )
            )

    flux_up = sum(s.flux_up for s in sols)
    flux_dn = sum(s.flux_dn for s in sols)
    jac = None if sfc_source_jac is None else sum(s.flux_up_jac for s in sols)

    if not top_at_1:
        flux_up, flux_dn = _flip_lay(flux_up), _flip_lay(flux_dn)
        jac = None if jac is None else _flip_lay(jac)
    return LWSolution(flux_up, flux_dn, jac)


def lw_solver_noscat_lay_major(
    tau,
    lay_source,
    lev_source,
    sfc_emis,
    sfc_source,
    inc_flux=None,
    lw_ds=None,
    sfc_source_jac=None,
    variant: str = "presrc",
) -> LWSolution:
    """Layer-major broadband no-scat solve (single angle, canonical
    top-at-0): tau/lay_source (nlay, ncol, ngpt), lev_source
    (nlay+1, ncol, ngpt), surface arrays (ncol, ngpt). Returns broadband
    (ncol, nlay+1) fluxes.

    The transpose-free fast path for layer-major gas optics: the scan
    inputs are consumed as laid out, so no (nlay, ncol, ngpt) transposed
    copies are materialized (vs lw_solver_noscat, whose column-major
    inputs must be moveaxis'd into scan layout).

    variant="presrc" (default) precomputes trans/src_dn/src_up in one
    fused pass so each scan streams 2 fields instead of 4;
    "fused" recomputes trans+sources inside both sweeps."""
    nlay, ncol, ngpt = tau.shape
    dtype = tau.dtype
    if inc_flux is None:
        inc_flux = jnp.zeros((ncol, ngpt), dtype)
    D = lw_ds.astype(dtype) if lw_ds is not None else jnp.full(
        (ncol, ngpt), GAUSS_DS[0, 0], dtype
    )
    if variant == "presrc":
        return _lw_noscat_broadband_presrc(
            tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux,
            D, GAUSS_WTS[0, 0], sfc_source_jac,
        )
    return _lw_noscat_broadband_fused(
        tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux,
        D, GAUSS_WTS[0, 0], sfc_source_jac, lay_major=True,
    )


def lw_two_stream(tau, ssa, g):
    """Meador-Weaver diffuse reflectance/transmittance with LW diffusivity
    secant 1.66 (reference lw_two_stream, :1018-1069).

    Returns (gamma1, gamma2, rdif, tdif)."""
    dtype = tau.dtype
    lw_diff_sec = jnp.asarray(1.66, dtype)
    gamma1 = lw_diff_sec * (1.0 - 0.5 * ssa * (1.0 + g))  # Fu et al. Eq 2.9
    gamma2 = lw_diff_sec * 0.5 * ssa * (1.0 - g)  # Fu et al. Eq 2.10
    k = jnp.sqrt(jnp.maximum((gamma1 - gamma2) * (gamma1 + gamma2), config.k_min))
    e1 = _exp(-tau * k)
    e2 = e1 * e1
    rt_term = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    rdif = rt_term * gamma2 * (1.0 - e2)  # MW Eq 25
    tdif = rt_term * 2.0 * k * e1  # MW Eq 26
    return gamma1, gamma2, rdif, tdif


def lw_source_2str(sfc_emis, sfc_source, lay_source, lev_source, gamma1, gamma2, rdif, tdif, tau):
    """Toon et al. 1989 two-stream sources (canonical top-at-0; reference
    lw_source_2str, :1112-1162). Factor pi converts radiance to flux."""
    dtype = tau.dtype
    pi = jnp.asarray(np.pi, dtype)
    lev_top = lev_source[:, :-1, :]
    lev_bot = lev_source[:, 1:, :]
    big = tau > 1.0e-8
    denom = jnp.where(big, tau * (gamma1 + gamma2), 1.0)
    Z = jnp.where(big, (lev_bot - lev_top) / denom, 0.0)
    Zup_top = Z + lev_top
    Zup_bot = Z + lev_bot
    Zdn_top = -Z + lev_top
    Zdn_bot = -Z + lev_bot
    source_up = jnp.where(big, pi * (Zup_top - rdif * Zdn_top - tdif * Zup_bot), 0.0)
    source_dn = jnp.where(big, pi * (Zdn_bot - rdif * Zup_bot - tdif * Zdn_top), 0.0)
    source_sfc = pi * sfc_emis * sfc_source
    return source_dn, source_up, source_sfc


def lw_solver_2stream(
    tau,
    ssa,
    g,
    lay_source,
    lev_source,
    sfc_emis,
    sfc_source,
    inc_flux=None,
    top_at_1=True,
    scan_mode="sequential",
) -> LWSolution:
    """Two-stream LW with scattering (reference lw_solver_2stream, :426-486)."""
    ncol, nlay, ngpt = tau.shape
    dtype = tau.dtype
    if inc_flux is None:
        inc_flux = jnp.zeros((ncol, ngpt), dtype)

    if not top_at_1:
        tau, ssa, g = _flip_lay(tau), _flip_lay(ssa), _flip_lay(g)
        lay_source, lev_source = _flip_lay(lay_source), _flip_lay(lev_source)

    gamma1, gamma2, rdif, tdif = lw_two_stream(tau, ssa, g)
    source_dn, source_up, source_sfc = lw_source_2str(
        sfc_emis, sfc_source, lay_source, lev_source, gamma1, gamma2, rdif, tdif, tau
    )
    sfc_albedo = 1.0 - sfc_emis
    flux_up, flux_dn = adding(
        sfc_albedo, rdif, tdif, source_dn, source_up, source_sfc, inc_flux, mode=scan_mode
    )
    if not top_at_1:
        flux_up, flux_dn = _flip_lay(flux_up), _flip_lay(flux_dn)
    return LWSolution(flux_up, flux_dn, None)
