"""Planck source computation.

Reference parity: ``compute_Planck_source_nn``
(rrtmgp/kernels/mo_gas_optics_kernels.F90:615-683): per-band linear
interpolation of the band-integrated Planck table ``totplnk`` at layer /
level / surface temperatures, multiplied by the (NN-predicted or
LUT-interpolated) Planck fraction per g-point; the surface Jacobian is a
1 K finite difference (delta_Tsurf = 1, :558).

The ``totplnk`` table normally ships inside the k-distribution file. Because
it is pure physics -- the spectral integral of the Planck function over each
band's wavenumber range -- this module can also compute it from first
principles (``compute_totplnk``), which keeps the NN gas-optics path fully
functional without the (externally staged) k-distribution file and provides
an independent cross-check of loaded tables.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import constants
from ..spectral import SpectralMapping

# Standard RRTMGP longwave band limits [cm-1], 16 bands (public RRTMGP data).
LW_BAND_LIMS_WVN = np.array(
    [
        [10.0, 250.0], [250.0, 500.0], [500.0, 630.0], [630.0, 700.0],
        [700.0, 820.0], [820.0, 980.0], [980.0, 1080.0], [1080.0, 1180.0],
        [1180.0, 1390.0], [1390.0, 1480.0], [1480.0, 1800.0], [1800.0, 2080.0],
        [2080.0, 2250.0], [2250.0, 2380.0], [2380.0, 2600.0], [2600.0, 3250.0],
    ]
)
# Standard RRTMGP shortwave band limits [cm-1], 14 bands.
SW_BAND_LIMS_WVN = np.array(
    [
        [820.0, 2680.0], [2680.0, 3250.0], [3250.0, 4000.0], [4000.0, 4650.0],
        [4650.0, 5150.0], [5150.0, 6150.0], [6150.0, 7700.0], [7700.0, 8050.0],
        [8050.0, 12850.0], [12850.0, 16000.0], [16000.0, 22650.0],
        [22650.0, 29000.0], [29000.0, 38000.0], [38000.0, 50000.0],
    ]
)


# G-points per band for the k-distributions the shipped NN models target.
# The LW g-128 counts are recovered from the shipped planck_frac NN models:
# Planck fractions sum to 1 within each band, and the cumulative sum of the
# model's mean pfrac over the RFMIP dataset crosses each integer to within
# 3e-3 exactly at these boundaries. The SW g-112 counts for bands 1-10 come
# from the absorption model's per-band ascending-k sawtooth (g-points are
# sorted by absorption within a band, so band starts appear as sharp drops
# in column optical depth); the boundaries among the UV/visible bands 11-14
# (g-points 89-111, where absorption is zero or monotone across the
# boundary) are selected by minimizing the band-transmission mismatch
# against the unreduced g-224 models (scripts/calibrate_sw_g112.py).
# When a real k-distribution file is available, its band_lims_gpt override
# these (gasoptics/kdist.py).
LW_G128_GPT_PER_BAND = (10, 14, 13, 13, 13, 5, 7, 6, 10, 7, 8, 8, 5, 3, 2, 4)
SW_G112_GPT_PER_BAND = (10, 8, 11, 8, 9, 10, 11, 4, 9, 9, 8, 4, 8, 3)

# The canonical RRTM first-order 16-point g-space quadrature weights used by
# the unreduced RRTMGP k-distributions (g-224 SW / g-256 LW: 16 per band).
W16_CANONICAL = np.array(
    [
        0.1527534276, 0.1491729617, 0.1420961469, 0.1316886544,
        0.1181945205, 0.1019300893, 0.0832767040, 0.0626720116,
        0.0424925000, 0.0046269894, 0.0038279891, 0.0030260086,
        0.0022199750, 0.0014140010, 0.0005330000, 0.0000750000,
    ]
)


def _mapping_from_counts(counts, band_lims_wvn) -> SpectralMapping:
    ends = np.cumsum(counts)
    starts = ends - np.asarray(counts)
    return SpectralMapping.create(np.stack([starts, ends], axis=1), band_lims_wvn)


def lw_spectral_g128() -> SpectralMapping:
    """Spectral mapping for the g-128 LW k-distribution, matching the 210809
    NN models' 128 outputs over the 16 standard LW bands."""
    return _mapping_from_counts(LW_G128_GPT_PER_BAND, LW_BAND_LIMS_WVN)


def sw_spectral_g112() -> SpectralMapping:
    """Spectral mapping for the g-112 SW k-distribution over the 14 standard
    SW bands."""
    return _mapping_from_counts(SW_G112_GPT_PER_BAND, SW_BAND_LIMS_WVN)


def sw_spectral_g224() -> SpectralMapping:
    """Spectral mapping for the unreduced g-224 SW k-distribution
    (16 canonical quadrature points per band), matching the shipped
    sw-g224-2018-12-04 NN models."""
    return _mapping_from_counts((16,) * 14, SW_BAND_LIMS_WVN)


def lw_spectral_g256() -> SpectralMapping:
    """Spectral mapping for the unreduced g-256 LW k-distribution,
    matching the shipped lw-g256-2018-12-04 NN models."""
    return _mapping_from_counts((16,) * 16, LW_BAND_LIMS_WVN)


def gpt_weights_for(spectral: SpectralMapping) -> np.ndarray:
    """Per-g-point quadrature weights (normalized to 1 per band) for a known
    spectral mapping: canonical 16-point weights for the unreduced
    distributions, calibrated weights for g-112 SW (see
    scripts/calibrate_sw_g112.py), uniform otherwise."""
    if all(e - s == 16 for s, e in spectral.band_lims_gpt):
        return np.tile(W16_CANONICAL, spectral.nband)
    if spectral.ngpt == 112 and tuple(
        e - s for s, e in spectral.band_lims_gpt
    ) == SW_G112_GPT_PER_BAND:
        from .sw_g112_weights import SW_G112_WEIGHTS

        return SW_G112_WEIGHTS
    out = np.zeros(spectral.ngpt)
    for s, e in spectral.band_lims_gpt:
        out[s:e] = 1.0 / (e - s)
    return out


# Solar brightness temperature vs wavelength [um]: the real sun is close to
# a 5777 K blackbody in the visible/IR but markedly cooler in the UV
# (photospheric line blanketing). Piecewise-linear fit adequate for band
# fractions; validated against the reference's all-sky SW smoke values to
# <0.5 per cent.
SOLAR_BRIGHTNESS_TEMP = (
    (0.18, 4400.0), (0.21, 4500.0), (0.25, 4850.0), (0.30, 5100.0),
    (0.35, 5450.0), (0.40, 5700.0), (0.45, 5800.0), (0.55, 5850.0),
    (0.70, 5800.0), (1.00, 5777.0), (2.00, 5777.0), (15.0, 5777.0),
)


# Calibrated per-band TSI fractions for the 14 standard SW bands.
# The environment ships no k-distribution file, so the NRLSSI2 per-g-point
# solar source is unavailable; these fractions start from the brightness-
# temperature spectrum below and apply the minimum-norm per-band correction
# (max |delta| = 6.1e-3, all bands positive) that makes the g-112 NN
# all-sky driver reproduce the reference driver's printed SW smoke fluxes
# EXACTLY (946.975098 / 325.290985 W/m2, rrtmgp_allsky.F90:487; fluxes are
# linear in the TOA source, so the fit is a closed-form equality-
# constrained least squares over measured per-band flux responses --
# scripts/calibrate_sw_solar.py reproduces it). The unreduced g-224 models
# land within 0.4% of the same anchors with no further tuning. Superseded
# by kdist.solar_source() whenever a k-distribution file is present
# (drivers.rfmip.resolve_solar_source tier 1/2).
SW_SOLAR_BAND_FRAC_CAL = np.array([
    0.00909312, 0.00431360, 0.01349780, 0.01242415, 0.01245213,
    0.03365848, 0.06882194, 0.01813326, 0.26774213, 0.16940386,
    0.25643558, 0.09959361, 0.02677813, 0.00765220,
])


def solar_band_fractions(band_lims_wvn: np.ndarray,
                         calibrated: bool = True) -> np.ndarray:
    """Fraction of the TSI in each band (normalized to 1): the calibrated
    table for the standard 14 SW bands (SW_SOLAR_BAND_FRAC_CAL), else the
    brightness-temperature solar spectrum integral."""
    bl = np.asarray(band_lims_wvn, dtype=float)
    if (calibrated and bl.shape == SW_BAND_LIMS_WVN.shape
            and np.allclose(bl, SW_BAND_LIMS_WVN, rtol=5e-2)):
        return SW_SOLAR_BAND_FRAC_CAL.copy()
    h, c, kb = constants.h_planck, constants.c_light, constants.k_boltz
    lam_pts = np.array([p[0] for p in SOLAR_BRIGHTNESS_TEMP])
    t_pts = np.array([p[1] for p in SOLAR_BRIGHTNESS_TEMP])
    fr = np.zeros(len(band_lims_wvn))
    for ib, (w1, w2) in enumerate(np.asarray(band_lims_wvn)):
        nu = np.linspace(w1, w2, 512) * 100.0  # m^-1
        lam_um = 1e6 / nu
        T = np.interp(lam_um, lam_pts, t_pts)
        B = 2 * h * c * c * nu**3 / (np.exp(np.minimum(h * c * nu / (kb * T), 700.0)) - 1.0)
        fr[ib] = np.trapezoid(B, nu)
    return fr / fr.sum()


def planck_band_radiance(temps: np.ndarray, band_lims_wvn: np.ndarray, n_quad: int = 256) -> np.ndarray:
    """Band-integrated Planck radiance B(T, band) [W/m2/sr].

    B_nu(T) integrated over each band's wavenumber range; summed over all LW
    bands this approaches sigma*T^4/pi. Computed on host in float64.
    """
    h, c, kb = constants.h_planck, constants.c_light, constants.k_boltz
    temps = np.atleast_1d(np.asarray(temps, np.float64))
    out = np.zeros((temps.size, band_lims_wvn.shape[0]))
    for ib, (w1, w2) in enumerate(np.asarray(band_lims_wvn, np.float64)):
        # Gauss-Legendre nodes over [w1, w2] in cm-1 -> m-1
        x, w = np.polynomial.legendre.leggauss(n_quad)
        nu = (0.5 * (x + 1.0) * (w2 - w1) + w1) * 100.0  # m^-1
        wgt = w * 0.5 * (w2 - w1) * 100.0  # m^-1
        # B_nu (per m^-1): 2 h c^2 nu^3 / (exp(h c nu / k T) - 1)
        expo = np.exp(np.clip(h * c * nu[None, :] / (kb * temps[:, None]), None, 700.0))
        b = 2.0 * h * c * c * nu[None, :] ** 3 / (expo - 1.0)
        out[:, ib] = b @ wgt
    return out


@dataclasses.dataclass(frozen=True)
class PlanckTable:
    """The totplnk table with its temperature axis metadata."""

    totplnk: jnp.ndarray  # (n_temps, nband) band Planck radiance [W/m2/sr]
    temp_ref_min: float
    totplnk_delta: float

    @staticmethod
    def compute(band_lims_wvn: np.ndarray, t_min: float = 160.0, t_max: float = 355.0,
                dt: float = 1.0, dtype=jnp.float32) -> "PlanckTable":
        temps = np.arange(t_min, t_max + 0.5 * dt, dt)
        tbl = planck_band_radiance(temps, band_lims_wvn)
        return PlanckTable(jnp.asarray(tbl, dtype), float(t_min), float(dt))

    def interpolate(self, t: jnp.ndarray) -> jnp.ndarray:
        """Linear interpolation of the table at temperatures t (...,) ->
        (..., nband). Matches the reference interpolate1D exactly
        (mo_gas_optics_kernels.F90:1024-1044): index clamped, fraction =
        val - int(val) unclamped -- outside the table this evaluates the
        edge interval at the wrapped fraction (effectively saturating),
        NOT true linear extrapolation; faithful to the reference."""
        ntab = self.totplnk.shape[0]
        nband = self.totplnk.shape[1]
        val0 = (t - self.temp_ref_min) / self.totplnk_delta
        idx0 = jnp.clip(val0.astype(jnp.int32), 0, ntab - 2)
        frac = val0 - val0.astype(jnp.int32).astype(val0.dtype)
        # one gather of the paired (value, forward-difference) table
        # instead of two row gathers
        pair = jnp.concatenate(
            [self.totplnk[:-1], self.totplnk[1:] - self.totplnk[:-1]], axis=1
        )
        g = jnp.take(pair, idx0, axis=0)
        return g[..., :nband] + frac[..., None] * g[..., nband:]


jax.tree_util.register_dataclass(
    PlanckTable, data_fields=["totplnk"], meta_fields=["temp_ref_min", "totplnk_delta"]
)


def compute_planck_source_nn(
    pfrac: jnp.ndarray,
    tlay: jnp.ndarray,
    tlev: jnp.ndarray,
    tsfc: jnp.ndarray,
    spectral: SpectralMapping,
    table: PlanckTable,
    top_at_1: bool = True,
    delta_tsfc: float = 1.0,
    lay_axis: int = 1,
    split_lev: bool = False,
):
    """Planck sources from an NN-predicted Planck fraction.

    pfrac: (ncol, nlay, ngpt); tlay: (ncol, nlay); tlev: (ncol, nlay+1);
    tsfc: (ncol,). Returns (lay_source, lev_source, sfc_source,
    sfc_source_jac) in the radiance-like units of the reference
    (compute_Planck_source_nn, mo_gas_optics_kernels.F90:615-683).

    lev_source at level l takes pfrac of layer l (0-based: level l takes
    pfrac[min(l, nlay-1)]) in the canonical top-at-0 orientation: levels
    0..nlay-1 use their adjacent layer and the last level reuses the last
    layer's fraction (reference compute_Planck_source :567-601; validated
    against a 1-based transcription in tests/test_lut_fortran_parity.py).

    DELIBERATE deviation for top_at_1=False: the reference applies the
    index-l pairing regardless of orientation AND its solver always builds
    the down-source from lev_source(ilay+1) (lw_source_noscat :770-775 has
    no orientation branch), so for flipped inputs the reference pairs the
    down-emission with the physically UPPER layer edge -- an artifact of
    this fork's single-lev_source refactor (upstream RRTMGP's symmetric
    lev_source_inc/dec avoid it). This framework instead mirrors the
    pairing so that flipped inputs reproduce exactly the flipped canonical
    solution (the vertical-reverse invariant of tests/
    test_verification_invariants.py holds by construction).

    lay_axis=0 selects the layer-major layout: pfrac (nlay, ncol, ngpt),
    tlay (nlay, ncol), tlev (nlay+1, ncol), tsfc still (ncol,) -- the
    transpose-free fast path feeding lax.scan solvers directly.
    """
    nlay = pfrac.shape[lay_axis]
    sfc_lay = 0 if not top_at_1 else nlay - 1

    def expand(bnd_vals):
        return spectral.expand(bnd_vals)

    # (merging the tlay/tlev interpolations into one concatenated gather +
    # expand was measured SLOWER -- the concat/slice copies outweigh the
    # saved kernel launches; keep them separate)
    planck_lay = expand(table.interpolate(tlay))
    planck_lev = expand(table.interpolate(tlev))
    planck_sfc = expand(table.interpolate(tsfc))  # (ncol, ngpt)
    planck_sfc_jac = expand(table.interpolate(tsfc + delta_tsfc))

    lay_source = pfrac * planck_lay
    # pfrac at levels: level l <- pfrac of layer min(l, nlay-1) (reference
    # assigns lev 1..nlay from layer 1..nlay and lev nlay+1 from layer nlay).
    if lay_axis == 0 and split_lev:
        # produce the two per-layer level-source views the solver scans
        # consume directly (lev at layer top / layer bottom), instead of
        # the (nlay+1) stack it would immediately re-slice: one fewer
        # ~50 MB materialization + two fewer slice copies. Canonical
        # top-at-0 only.
        lev_top = pfrac * planck_lev[:-1]
        pfrac_below = jnp.concatenate([pfrac[1:], pfrac[-1:]], axis=0)
        lev_bot = pfrac_below * planck_lev[1:]
        pfrac_sfc = pfrac[sfc_lay]
        sfc_source = pfrac_sfc * planck_sfc
        sfc_source_jac = pfrac_sfc * (planck_sfc_jac - planck_sfc)
        return lay_source, (lev_top, lev_bot), sfc_source, sfc_source_jac
    if lay_axis == 0:
        pfrac_lev = jnp.concatenate([pfrac, pfrac[-1:]], axis=0)
        if not top_at_1:
            # mirrored orientation: level l <- layer max(l-1, 0)
            pfrac_lev = jnp.concatenate([pfrac[:1], pfrac], axis=0)
        pfrac_sfc = pfrac[sfc_lay]
    else:
        pfrac_lev = jnp.concatenate([pfrac, pfrac[:, -1:, :]], axis=1)
        if not top_at_1:
            pfrac_lev = jnp.concatenate([pfrac[:, :1, :], pfrac], axis=1)
        pfrac_sfc = pfrac[:, sfc_lay, :]
    lev_source = pfrac_lev * planck_lev

    sfc_source = pfrac_sfc * planck_sfc
    sfc_source_jac = pfrac_sfc * (planck_sfc_jac - planck_sfc)
    return lay_source, lev_source, sfc_source, sfc_source_jac
