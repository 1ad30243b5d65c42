"""Vertical-recurrence primitives.

The reference's RTE transport is a set of strictly sequential per-column
recurrences over the layer dimension (``lw_transport_noscat_dn/up``,
``adding``, the SW direct beam; ``mo_rte_solver_kernels.F90:950-1009,
513-531, 1526-1637``). Here these become scans over the layer axis with
(ncol, ngpt) "vector" elements; ncol*ngpt supplies the parallelism of each
step, and an associative (log-depth) formulation is available for the affine
recurrences when nlay is large relative to the device's parallelism.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def affine_scan(
    trans: jnp.ndarray,
    source: jnp.ndarray,
    r0: jnp.ndarray,
    axis: int = 1,
    mode: str = "sequential",
) -> jnp.ndarray:
    """Solve r[k+1] = trans[k] * r[k] + source[k] along ``axis``.

    trans, source: (..., nlay, ...) layer quantities along ``axis``.
    r0: boundary value, shape = trans.shape without ``axis``.
    Returns r with nlay+1 entries along ``axis`` (r[0] = r0).

    mode="sequential": lax.scan, O(nlay) depth, minimal flops.
    mode="parallel": lax.associative_scan on affine-map composition,
    O(log nlay) depth, ~2x flops -- the key perf lever the reference cannot
    express (its loops are inherently serial).
    """
    dtype = jnp.result_type(trans.dtype, source.dtype, r0.dtype)
    trans = jnp.moveaxis(trans, axis, 0).astype(dtype)
    source = jnp.moveaxis(source, axis, 0).astype(dtype)
    r0 = r0.astype(dtype)

    if mode == "sequential":
        def step(r, ts):
            t, s = ts
            r_next = t * r + s
            return r_next, r_next

        _, rs = jax.lax.scan(step, r0, (trans, source))
        out = jnp.concatenate([r0[None], rs], axis=0)
    elif mode == "parallel":
        def combine(a, b):
            # a is the earlier affine map x -> ta*x + sa; b applied after.
            ta, sa = a
            tb, sb = b
            return ta * tb, tb * sa + sb

        pt, ps = jax.lax.associative_scan(combine, (trans, source), axis=0)
        out = jnp.concatenate([r0[None], pt * r0[None] + ps], axis=0)
    else:
        raise ValueError(f"unknown scan mode {mode!r}")
    return jnp.moveaxis(out, 0, axis)


def affine_scan_reverse(
    trans: jnp.ndarray,
    source: jnp.ndarray,
    r_last: jnp.ndarray,
    axis: int = 1,
    mode: str = "sequential",
) -> jnp.ndarray:
    """Solve r[k] = trans[k] * r[k+1] + source[k] (upward sweep).

    Returns r with nlay+1 entries along ``axis`` (r[nlay] = r_last).
    Sequential mode iterates bottom-up via ``lax.scan(reverse=True)`` --
    no materialized reversed copies of the inputs (each flip of an
    (ncol, nlay, ngpt) array is a full HBM round-trip).
    """
    if mode == "sequential":
        dtype = jnp.result_type(trans.dtype, source.dtype, r_last.dtype)
        t = jnp.moveaxis(trans, axis, 0).astype(dtype)
        s = jnp.moveaxis(source, axis, 0).astype(dtype)
        r_last = r_last.astype(dtype)

        def step(r, ts):
            tk, sk = ts
            r_prev = tk * r + sk
            return r_prev, r_prev

        _, rs = jax.lax.scan(step, r_last, (t, s), reverse=True)
        out = jnp.concatenate([rs, r_last[None]], axis=0)
        return jnp.moveaxis(out, 0, axis)
    t = jnp.flip(trans, axis)
    s = jnp.flip(source, axis)
    out = affine_scan(t, s, r_last, axis=axis, mode=mode)
    return jnp.flip(out, axis)
