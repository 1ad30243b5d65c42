"""Cloud optics: band-resolved cloud optical properties from water path and
particle effective radius.

Reference parity: ``extensions/cloud_optics/mo_cloud_optics.F90`` --
ty_cloud_optics with either LUT (linear in effective radius; liquid + ice
with 3 roughness categories; ``compute_all_from_table`` :603-645) or Pade
approximant data (3 size regimes, [2/3] for extinction and [2/2] for
ssa/asymmetry; ``compute_all_from_pade`` + ``pade_eval`` :650-775);
``cloud_optics()`` combines liquid and ice into tau / tau*ssa / tau*ssa*g
(:354-535); ``set_ice_roughness`` (:541-554). The shipped coefficient files
``rrtmgp-cloud-optics-coeffs-{lw,sw}.nc`` load directly.

Design: tables are small (16 bands x <=20 sizes); the per-(col,lay) size
interpolation is an exact gather of table rows that XLA vectorizes over the
band axis; masks are jnp.where, not branches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..spectral import SpectralMapping
from ..utils import ncio


@dataclasses.dataclass(frozen=True)
class CloudOptics:
    """Loaded cloud-optics data. Exactly one of (lut_*, pade_*) is present.

    LUT arrays are (nband, nsize) for liquid and (nrghice, nband, nsize)
    for ice; Pade arrays are (ncoeff, nsizereg, nband) for liquid and
    (nrghice, ncoeff, nsizereg, nband) for ice (file/C order).
    """

    spectral: SpectralMapping
    radliq_lwr: float
    radliq_upr: float
    radice_lwr: float
    radice_upr: float
    # LUT data
    lut_extliq: Optional[jnp.ndarray] = None
    lut_ssaliq: Optional[jnp.ndarray] = None
    lut_asyliq: Optional[jnp.ndarray] = None
    lut_extice: Optional[jnp.ndarray] = None
    lut_ssaice: Optional[jnp.ndarray] = None
    lut_asyice: Optional[jnp.ndarray] = None
    # Pade data
    pade_extliq: Optional[jnp.ndarray] = None
    pade_ssaliq: Optional[jnp.ndarray] = None
    pade_asyliq: Optional[jnp.ndarray] = None
    pade_extice: Optional[jnp.ndarray] = None
    pade_ssaice: Optional[jnp.ndarray] = None
    pade_asyice: Optional[jnp.ndarray] = None
    pade_sizreg_extliq: Optional[tuple] = None
    pade_sizreg_ssaliq: Optional[tuple] = None
    pade_sizreg_asyliq: Optional[tuple] = None
    pade_sizreg_extice: Optional[tuple] = None
    pade_sizreg_ssaice: Optional[tuple] = None
    pade_sizreg_asyice: Optional[tuple] = None
    icergh: int = 1  # ice roughness category, 1-based (set_ice_roughness)

    @property
    def is_lut(self) -> bool:
        return self.lut_extliq is not None

    @property
    def nband(self) -> int:
        return self.spectral.nband

    # reference get_min/max_radius_liq/ice
    @property
    def min_radius_liq(self):
        return self.radliq_lwr

    @property
    def max_radius_liq(self):
        return self.radliq_upr

    @property
    def min_radius_ice(self):
        return self.radice_lwr

    @property
    def max_radius_ice(self):
        return self.radice_upr

    def set_ice_roughness(self, icergh: int) -> "CloudOptics":
        nr = (self.lut_extice if self.is_lut else self.pade_extice).shape[0]
        if not 1 <= icergh <= nr:
            raise ValueError(f"ice roughness {icergh} out of range 1..{nr}")
        return dataclasses.replace(self, icergh=icergh)


jax.tree_util.register_dataclass(
    CloudOptics,
    data_fields=[
        "lut_extliq", "lut_ssaliq", "lut_asyliq",
        "lut_extice", "lut_ssaice", "lut_asyice",
        "pade_extliq", "pade_ssaliq", "pade_asyliq",
        "pade_extice", "pade_ssaice", "pade_asyice",
    ],
    meta_fields=[
        "spectral", "radliq_lwr", "radliq_upr", "radice_lwr", "radice_upr",
        "pade_sizreg_extliq", "pade_sizreg_ssaliq", "pade_sizreg_asyliq",
        "pade_sizreg_extice", "pade_sizreg_ssaice", "pade_sizreg_asyice",
        "icergh",
    ],
)


def load_cloud_optics(path: str, dtype=jnp.float32,
                      prefer: str = "lut") -> CloudOptics:
    """Load a cloud-optics coefficient file; auto-detects LUT vs Pade
    content (reference load_lut :91-173 / load_pade :179-301 dispatched by
    mo_load_cloud_coefficients). When a file carries BOTH parameterizations
    ``prefer`` picks one ('lut' matches the reference's per-file-flavour
    loaders; 'pade' forces the Pade approximants)."""
    with ncio.NCFile(path) as f:
        spectral = SpectralMapping.bands_only(f.read("bnd_limits_wavenumber"))
        kw = dict(
            spectral=spectral,
            radliq_lwr=float(f.read("radliq_lwr")),
            radliq_upr=float(f.read("radliq_upr")),
            radice_lwr=float(f.read("radice_lwr")),
            radice_upr=float(f.read("radice_upr")),
        )
        if f.has_var("lut_extliq"):
            for name in ("lut_extliq", "lut_ssaliq", "lut_asyliq",
                         "lut_extice", "lut_ssaice", "lut_asyice"):
                kw[name] = jnp.asarray(f.read(name, np.float64), dtype)
        if f.has_var("pade_extliq"):
            for name in ("pade_extliq", "pade_ssaliq", "pade_asyliq",
                         "pade_extice", "pade_ssaice", "pade_asyice"):
                kw[name] = jnp.asarray(f.read(name, np.float64), dtype)
            for name in ("pade_sizreg_extliq", "pade_sizreg_ssaliq", "pade_sizreg_asyliq",
                         "pade_sizreg_extice", "pade_sizreg_ssaice", "pade_sizreg_asyice"):
                kw[name] = tuple(float(x) for x in f.read(name, np.float64))
        # If both are present, keep the preferred one (default: LUT,
        # matching the reference, which loads one or the other per file
        # flavour).
        if "pade_extliq" in kw and "lut_extliq" in kw:
            drop = "pade" if prefer == "lut" else "lut"
            for name in list(kw):
                if name.startswith(drop):
                    del kw[name]
    return CloudOptics(**kw)


def _from_table(mask, wp_, re, offset, upr, ext_t, ssa_t, asy_t):
    """Linear LUT interpolation in effective radius; tables (nband, nsize).
    Returns tau, tau*ssa, tau*ssa*g with band as the minor axis. One gather
    of the paired (value | forward difference) rows per table, then
    lo + fint * (hi - lo)."""
    nband, nsteps = ext_t.shape
    step_size = (upr - offset) / (nsteps - 1)
    fidx = (re - offset) / step_size
    index = jnp.clip(jnp.floor(fidx).astype(jnp.int32), 0, nsteps - 2)
    fint = (fidx - index)[..., None]  # (ncol, nlay, 1)
    m = mask[..., None]

    def interp(tbl):
        rows = tbl.T  # (nsize, nband)
        pair = jnp.concatenate([rows[:-1], rows[1:] - rows[:-1]], axis=1)
        g = jnp.take(pair, index, axis=0)  # (ncol, nlay, 2 * nband)
        return g[..., :nband] + fint * g[..., nband:]

    e_v, s_v, a_v = interp(ext_t), interp(ssa_t), interp(asy_t)

    t = jnp.where(m, wp_[..., None] * e_v, 0.0)
    ts = t * s_v
    tsg = ts * a_v
    return t, jnp.where(m, ts, 0.0), jnp.where(m, tsg, 0.0)


def _pade_eval(re, coeffs, irad, m: int, n: int):
    """Horner-evaluated [m/n] Pade approximant; coeffs (ncoeff, nsizereg,
    nband), irad (ncol, nlay) 0-based regime index."""
    c = jnp.moveaxis(coeffs, 0, -1)  # (nsizereg, nband, ncoeff)
    sel = c[irad]  # (ncol, nlay, nband, ncoeff)
    re_ = re[..., None]
    denom = sel[..., n + m]
    for i in range(n - 1 + m, m, -1):
        denom = sel[..., i] + re_ * denom
    denom = 1.0 + re_ * denom
    numer = sel[..., m]
    for i in range(m - 1, 0, -1):
        numer = sel[..., i] + re_ * numer
    numer = sel[..., 0] + re_ * numer
    return numer / denom


def _pade_irad(re, bounds):
    """Size-regime index (0-based), replicating the reference's quirky
    three-regime formula (mo_cloud_optics.F90:689-702): uses bounds[1] as
    offset and bounds[2] as step."""
    return jnp.clip(jnp.floor((re - bounds[1]) / bounds[2]).astype(jnp.int32) + 1, 0, 2)


def _from_pade(co: CloudOptics, mask, wp_, re, ext, ssa, asy, b_ext, b_ssa, b_asy):
    t = wp_[..., None] * _pade_eval(re, ext, _pade_irad(re, b_ext), 2, 3)
    # Pade co-albedo can go slightly negative; clamp (reference :698).
    ts = t * (1.0 - jnp.maximum(0.0, _pade_eval(re, ssa, _pade_irad(re, b_ssa), 2, 2)))
    tsg = ts * _pade_eval(re, asy, _pade_irad(re, b_asy), 2, 2)
    m = mask[..., None]
    return jnp.where(m, t, 0.0), jnp.where(m, ts, 0.0), jnp.where(m, tsg, 0.0)


def cloud_optics(
    co: CloudOptics,
    clwp: jnp.ndarray,
    ciwp: jnp.ndarray,
    reliq: jnp.ndarray,
    reice: jnp.ndarray,
    as_2str: bool = True,
):
    """Compute band-resolved cloud optical properties.

    clwp/ciwp: (ncol, nlay) liquid/ice water path [g/m2];
    reliq/reice: (ncol, nlay) effective radii [microns].
    Returns OpticalProps2str (tau, ssa, g) or OpticalProps1scl (absorption
    tau) on the band grid (ngpt == nband), ready for ``increment`` with a
    by-band broadcast.
    """
    eps = jnp.finfo(clwp.dtype).eps
    liqmsk = clwp > 0.0
    icemsk = ciwp > 0.0

    if co.is_lut:
        lt, lts, ltsg = _from_table(
            liqmsk, clwp, reliq, co.radliq_lwr, co.radliq_upr,
            co.lut_extliq, co.lut_ssaliq, co.lut_asyliq,
        )
        it, its, itsg = _from_table(
            icemsk, ciwp, reice, co.radice_lwr, co.radice_upr,
            co.lut_extice[co.icergh - 1], co.lut_ssaice[co.icergh - 1],
            co.lut_asyice[co.icergh - 1],
        )
    else:
        lt, lts, ltsg = _from_pade(
            co, liqmsk, clwp, reliq,
            co.pade_extliq, co.pade_ssaliq, co.pade_asyliq,
            co.pade_sizreg_extliq, co.pade_sizreg_ssaliq, co.pade_sizreg_asyliq,
        )
        it, its, itsg = _from_pade(
            co, icemsk, ciwp, reice,
            co.pade_extice[co.icergh - 1], co.pade_ssaice[co.icergh - 1],
            co.pade_asyice[co.icergh - 1],
            co.pade_sizreg_extice, co.pade_sizreg_ssaice, co.pade_sizreg_asyice,
        )

    if not as_2str:
        # absorption optical depth = tau - tau*ssa (reference 1scl branch)
        return OpticalProps1scl((lt - lts) + (it - its), co.spectral)

    tau = lt + it
    taussa = lts + its
    g = (ltsg + itsg) / jnp.maximum(eps, taussa)
    ssa = taussa / jnp.maximum(eps, tau)
    return OpticalProps2str(tau, ssa, g, co.spectral)
