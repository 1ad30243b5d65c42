"""Spectral discretization: bands and g-points.

Reference parity: the base-class part of ``rte/mo_optical_props.F90:62-66,
223-279, 1073-1229`` (band2gpt / gpt2band / band_lims_wvn bookkeeping and the
band->g-point ``expand``).

Design: the mapping is *static* metadata (numpy, hashable), carried in the
aux_data of optical-props pytrees so that jit retraces only when the
spectral discretization actually changes. The band->gpt expansion is an
exact gather with a precomputed per-gpt band index; the gpt->band sum adds
each band's contiguous g-point slice.
"""
from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=64)
def _gpt2band(band_lims_gpt: tuple, ngpt: int) -> np.ndarray:
    out = np.zeros(ngpt, dtype=np.int32)
    for ib, (s, e) in enumerate(band_lims_gpt):
        out[s:e] = ib
    out.flags.writeable = False  # cached: shared across callers
    return out


@dataclasses.dataclass(frozen=True)
class SpectralMapping:
    """Bands <-> g-points. Internal g-point indices are 0-based half-open.

    band_lims_gpt: (nband, 2) int, [start, end) g-point range per band.
    band_lims_wvn: (nband, 2) float, wavenumber limits [cm-1] per band.
    """

    band_lims_gpt: tuple  # nested tuples for hashability
    band_lims_wvn: tuple

    # -- constructors -------------------------------------------------------
    @staticmethod
    def create(band_lims_gpt: np.ndarray, band_lims_wvn: np.ndarray) -> "SpectralMapping":
        blg = np.asarray(band_lims_gpt, dtype=np.int64)
        blw = np.asarray(band_lims_wvn, dtype=np.float64)
        if blg.shape != blw.shape or blg.ndim != 2 or blg.shape[1] != 2:
            raise ValueError(f"bad band-limit shapes {blg.shape} {blw.shape}")
        return SpectralMapping(
            band_lims_gpt=tuple(map(tuple, blg.tolist())),
            band_lims_wvn=tuple(map(tuple, blw.tolist())),
        )

    @staticmethod
    def from_fortran_limits(band_lims_gpt_1based: np.ndarray, band_lims_wvn: np.ndarray) -> "SpectralMapping":
        """From the k-distribution file's 1-based inclusive [start, end] pairs
        (reference ``bnd_limits_gpt``)."""
        blg = np.asarray(band_lims_gpt_1based, dtype=np.int64).copy()
        blg[:, 0] -= 1  # to 0-based start, end stays (inclusive 1-based == exclusive 0-based)
        return SpectralMapping.create(blg, band_lims_wvn)

    @staticmethod
    def bands_only(band_lims_wvn: np.ndarray) -> "SpectralMapping":
        """One g-point per band (used by band-resolved cloud optics;
        reference mo_optical_props.F90 init without band_lims_gpt)."""
        nband = np.asarray(band_lims_wvn).shape[0]
        blg = np.stack([np.arange(nband), np.arange(nband) + 1], axis=1)
        return SpectralMapping.create(blg, band_lims_wvn)

    # -- queries ------------------------------------------------------------
    @property
    def nband(self) -> int:
        return len(self.band_lims_gpt)

    @property
    def ngpt(self) -> int:
        return max(e for _, e in self.band_lims_gpt)

    @property
    def gpt2band(self) -> np.ndarray:
        """(ngpt,) 0-based band index of each g-point (cached per mapping)."""
        return _gpt2band(self.band_lims_gpt, self.ngpt)

    @property
    def band_lims_gpt_array(self) -> np.ndarray:
        return np.asarray(self.band_lims_gpt, dtype=np.int64)

    @property
    def band_lims_wvn_array(self) -> np.ndarray:
        return np.asarray(self.band_lims_wvn, dtype=np.float64)

    def gpts_are_equal(self, other: "SpectralMapping") -> bool:
        return self.band_lims_gpt == other.band_lims_gpt

    def bands_are_equal(self, other: "SpectralMapping") -> bool:
        return self.nband == other.nband and np.allclose(
            self.band_lims_wvn_array, other.band_lims_wvn_array
        )

    # -- ops ----------------------------------------------------------------
    def expand(self, band_values: jnp.ndarray) -> jnp.ndarray:
        """Expand a per-band array (..., nband) to per-g-point (..., ngpt).

        Reference parity: mo_rte_lw.F90:429-447 (emissivity expand) and
        mo_optical_props.F90 ``expand``. A gather along the band axis:
        exact, with no matrix product to round.
        """
        return jnp.take(band_values, jnp.asarray(self.gpt2band), axis=-1)

    def reduce_sum(self, gpt_values: jnp.ndarray) -> jnp.ndarray:
        """Sum per-g-point values (..., ngpt) into per-band (..., nband)
        (the byband flux reduction, mo_fluxes_byband_kernels.F90:31-66):
        one sum over each band's contiguous g-point slice."""
        return jnp.stack(
            [jnp.sum(gpt_values[..., s:e], axis=-1)
             for s, e in self.band_lims_gpt], axis=-1)
