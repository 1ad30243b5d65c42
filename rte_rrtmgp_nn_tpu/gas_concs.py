"""Gas volume-mixing-ratio container.

Reference parity: ``rrtmgp/mo_gas_concentrations.F90`` (ty_gas_concs:
scalar / 1-D profile / full 2-D VMR storage with broadcasting on read,
name normalization, subsetting) and ``rrtmgp/mo_gas_ref_concentrations.F90``
(reference scenario VMRs for gases missing from the input).

Design: a frozen pytree wrapping a dict of arrays; each entry is stored
with shape (), (nlay,), or (ncol, nlay) and broadcast on access. Gas names
are static metadata (dict keys), so jit retraces only when the gas *set*
changes, not the values.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

_CHEM_NAME_MAP = {
    # RFMIP-style long names -> kdist names (reference mo_rfmip_io determine_gas_names)
    "carbon_dioxide": "co2",
    "methane": "ch4",
    "nitrous_oxide": "n2o",
    "water_vapor": "h2o",
    "ozone": "o3",
    "carbon_monoxide": "co",
    "nitrogen": "n2",
    "oxygen": "o2",
}


def normalize_gas_name(name: str) -> str:
    n = name.lower().strip()
    return _CHEM_NAME_MAP.get(n, n)


@dataclasses.dataclass(frozen=True)
class GasConcs:
    """Mapping gas name -> VMR array of shape (), (nlay,), or (ncol, nlay)."""

    concs: dict  # str -> jnp.ndarray

    def __post_init__(self):
        for k in self.concs:
            if k != normalize_gas_name(k):
                raise ValueError(f"gas name {k!r} not normalized (use GasConcs.create)")

    @staticmethod
    def create(vmrs: Mapping[str, jnp.ndarray | float]) -> "GasConcs":
        out = {}
        for name, v in vmrs.items():
            arr = jnp.asarray(v)
            if arr.ndim > 2:
                raise ValueError(f"{name}: VMR must be scalar, (nlay,), or (ncol, nlay)")
            # same [0, 1] guard as set_vmr (the reference validates on its
            # only construction path, mo_gas_concentrations.F90:130-250)
            if not isinstance(arr, jax.core.Tracer):
                vv = np.asarray(arr)
                if np.any(vv < 0.0) or np.any(vv > 1.0):
                    raise ValueError(f"create({name}): values outside [0,1]")
            out[normalize_gas_name(name)] = arr
        return GasConcs(out)

    # -- queries ------------------------------------------------------------
    @property
    def gas_names(self) -> list[str]:
        return list(self.concs.keys())

    def __contains__(self, name: str) -> bool:
        return normalize_gas_name(name) in self.concs

    def get_vmr(self, name: str, ncol: int, nlay: int) -> jnp.ndarray:
        """Broadcast the stored VMR to (ncol, nlay)
        (reference get_vmr, mo_gas_concentrations.F90)."""
        arr = self.concs[normalize_gas_name(name)]
        if arr.ndim == 0:
            return jnp.broadcast_to(arr, (ncol, nlay))
        if arr.ndim == 1:
            return jnp.broadcast_to(arr[None, :], (ncol, nlay))
        return arr

    def get_raw(self, name: str) -> jnp.ndarray:
        return self.concs[normalize_gas_name(name)]

    def set_vmr(self, name: str, value) -> "GasConcs":
        """Functional update; validates range [0, 1] host-side when possible
        (reference set_vmr validation, mo_gas_concentrations.F90:130-250)."""
        arr = jnp.asarray(value)
        if not isinstance(arr, jax.core.Tracer):
            v = np.asarray(arr)
            if np.any(v < 0.0) or np.any(v > 1.0):
                raise ValueError(f"set_vmr({name}): values outside [0,1]")
        new = dict(self.concs)
        new[normalize_gas_name(name)] = arr
        return GasConcs(new)

    def subset(self, start: int, n: int) -> "GasConcs":
        """Column subset (reference get_subset_range). Scalar/1-D entries are
        shared; 2-D entries are sliced."""
        out = {}
        for k, v in self.concs.items():
            out[k] = v[start : start + n] if v.ndim == 2 else v
        return GasConcs(out)


jax.tree_util.register_dataclass(GasConcs, data_fields=["concs"], meta_fields=[])


# -- reference scenario concentrations ---------------------------------------
# (reference rrtmgp/mo_gas_ref_concentrations.F90:38-60; scenarios are
#  1 = present-day, 2 = pre-industrial, 3 = future)
# VMR values per (present-day, pre-industrial, future) scenario. These are
# physical data (RFMIP/CMIP6 global-mean mole fractions) transcribed from the
# reference table at mo_gas_ref_concentrations.F90:46-60.
_REF_VMR = {
    #            present-day    pre-industrial  future
    "co2":      (397.5470e-6,   284.3170e-6,    1066.850e-6),
    "n2o":      (326.9880e-9,   273.0211e-9,    389.3560e-9),
    "co":       (1.200000e-7,   1.000000e-8,    1.800000e-7),
    "ch4":      (1831.471e-9,   808.2490e-9,    2478.709e-9),
    "ccl4":     (83.06993e-12,  0.0250004e-12,  6.082623e-12),
    "cfc11":    (233.0799e-12,  0.0,            57.17037e-12),
    "cfc12":    (520.5810e-12,  0.0,            221.1720e-12),
    "cfc22":    (229.5421e-12,  0.0,            0.856923e-12),
    "hfc143a":  (15.25278e-12,  0.0,            713.8991e-12),
    "hfc125":   (15.35501e-12,  0.0,            966.1801e-12),
    "hfc23":    (26.89044e-12,  0.0,            24.61550e-12),
    "hfc32":    (8.336969e-12,  0.0002184e-12,  0.046355e-12),
    "hfc134a":  (80.51573e-12,  0.0,            421.3692e-12),
    "cf4":      (81.09249e-12,  34.050000e-12,  126.5040e-12),
}


def get_ref_vmr(scenario_index: int, gas: str) -> float:
    """Reference-scenario global-mean VMR for a gas
    (reference get_ref_vmr, mo_gas_ref_concentrations.F90:27-84).

    scenario_index: 1 = present-day, 2 = pre-industrial, 3 = future.
    Returns 0.0 for unknown gases (matching the NN packing's zero fallback
    for gases without a stored reference value).
    """
    g = normalize_gas_name(gas)
    if g not in _REF_VMR:
        return 0.0
    if scenario_index not in (1, 2, 3):
        raise ValueError(f"scenario_index must be 1..3, got {scenario_index}")
    return _REF_VMR[g][scenario_index - 1]
