"""Runtime configuration for the JAX RTE+RRTMGP-NN framework.

Mirrors the capabilities of the reference's runtime flag module
(``rte/mo_rte_rrtmgp_config.F90:23-40``): extent checking, value checking,
the missing-gas scenario index for the NN input packing, and the
compile-time choices the reference exposes as preprocessor macros
(``DOUBLE_PRECISION``, ``FAST_EXPONENTIAL``, ``compute_Jac``,
``use_Pade_source``).

Design: a single immutable-ish module-level config object. Fields that
affect traced computation (dtype, fast_exp, pade_source) are read at trace
time, so changing them invalidates nothing silently -- jit caches key on the
static values passed down by the front-ends.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import jax
import jax.numpy as jnp

# Precision of every matrix product in the package (NN gas-optics GEMMs
# and any other dot). A fixed choice, not a knob: on GPUs the float32
# default is TF32 (about 10 mantissa bits), and the NN output goes through
# (ystd*y + ymean)**8, so a relative operand error e becomes ~8e in tau.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class RTEConfig:
    # Validate array extents at the Python (trace-time) level.
    check_extents: bool = False
    # Validate array values (host-side helper; not usable inside jit).
    check_values: bool = False
    # Missing-gas handling for NN inputs: 0 = zero concentration,
    # 1 = present-day, 2 = pre-industrial, 3 = future reference VMR.
    # (reference: mo_rte_rrtmgp_config.F90:40, mo_gas_ref_concentrations.F90)
    nn_scenario_index: int = 0
    # Working precision: float32 mirrors the reference's default wp=sp;
    # float64 requires jax.config.update("jax_enable_x64", True).
    dtype: jnp.dtype = jnp.float32
    # Use the Pade-approximant exponential (reference -DFAST_EXPONENTIAL,
    # mo_rte_solver_kernels.F90:90-106).
    fast_exponential: bool = False
    # Use the Pade linear-in-tau source form (reference use_Pade_source,
    # mo_rte_rrtmgp_config.F90:30).
    use_pade_source: bool = False
    # Compute the surface-temperature Jacobian of upward flux
    # (reference compute_Jac, mo_rte_rrtmgp_config.F90:28).
    compute_jac: bool = False

    @property
    def eps(self) -> float:
        return float(jnp.finfo(self.dtype).eps)

    @property
    def tau_thresh(self) -> float:
        # Series-expansion threshold for the linear-in-tau source
        # (reference mo_rte_solver_kernels.F90:764-767).
        return float(jnp.sqrt(jnp.finfo(self.dtype).eps))

    @property
    def k_min(self) -> float:
        # Floor on the two-stream eigenvalue k to avoid div-by-zero
        # (reference mo_rte_solver_kernels.F90:76-82).
        return 1.0e-12 if self.dtype == jnp.float64 else 1.0e-4


config = RTEConfig()


def set_checks(check_extents: bool | None = None, check_values: bool | None = None):
    """Reference parity: rte_rrtmgp_config_checks (mo_rte_rrtmgp_config.F90:43-61)."""
    if check_extents is not None:
        config.check_extents = check_extents
    if check_values is not None:
        config.check_values = check_values


@contextmanager
def config_override(**kwargs):
    old = {k: getattr(config, k) for k in kwargs}
    try:
        for k, v in kwargs.items():
            setattr(config, k, v)
        yield config
    finally:
        for k, v in old.items():
            setattr(config, k, v)
