"""Device-mesh sharding for column-parallel radiative transfer.

The reference's parallelism is OpenMP threads over column blocks
(rrtmgp_rfmip_lw.F90:364-367) on one node. The scaling story here
(SURVEY.md section 2.8) is:

  - 'col': columns are embarrassingly parallel (halo-free) -> the data-
    parallel mesh axis, across the cards of a host (NVLink) and across
    hosts (network).
  - 'gpt': the spectral axis can be sharded too ("tensor parallel" for this
    workload): the NN output layer's GEMM splits over output features, all
    solver math is g-point-elementwise, and only the broadband reduction
    needs a psum over the 'gpt' axis. XLA inserts that collective
    automatically under jit with NamedSharding inputs.

Everything is plain SPMD: pure functions + sharded arrays; no explicit
collectives in user code.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_col: Optional[int] = None, n_gpt: int = 1, devices=None) -> Mesh:
    """A ('col', 'gpt') mesh. Default: all devices on the column axis.
    The cards of a host are joined all to all, so the mesh follows the
    algorithm only: 'col' may span cards and hosts."""
    devices = list(devices if devices is not None else jax.devices())
    if n_col is None:
        n_col = len(devices) // n_gpt
    if n_col * n_gpt > len(devices):
        raise ValueError(f"mesh {n_col}x{n_gpt} needs {n_col*n_gpt} devices, have {len(devices)}")
    arr = np.array(devices[: n_col * n_gpt]).reshape(n_col, n_gpt)
    return Mesh(arr, ("col", "gpt"))


def column_sharding(mesh: Mesh, ndim: int, gpt_axis: Optional[int] = None) -> NamedSharding:
    """Sharding with axis 0 = columns over 'col'; optionally one axis over
    'gpt' (e.g. the minor spectral axis of tau/flux arrays)."""
    spec = [None] * ndim
    spec[0] = "col"
    if gpt_axis is not None:
        spec[gpt_axis] = "gpt"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_columns(tree, mesh: Mesh, gpt_minor: bool = False):
    """Device-put a pytree of column-leading arrays with 'col' sharding on
    axis 0 (and 'gpt' on the last axis if gpt_minor and the array has a
    g-point-sized minor dimension). Scalars/0-d stay replicated."""

    def put(x):
        x = jax.numpy.asarray(x)
        if x.ndim == 0:
            return jax.device_put(x, replicated(mesh))
        gpt_axis = x.ndim - 1 if (gpt_minor and x.ndim >= 2) else None
        return jax.device_put(x, column_sharding(mesh, x.ndim, gpt_axis))

    return jax.tree_util.tree_map(put, tree)


def pad_to_multiple(tree, multiple: int):
    """Pad the leading (column) axis of every array to a multiple, so the
    column count divides the mesh. Returns (padded_tree, original_ncol)."""
    ncol = jax.tree_util.tree_leaves(tree)[0].shape[0]
    pad = (-ncol) % multiple

    def padfn(x):
        if pad == 0 or x.ndim == 0:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths, mode="edge")

    return jax.tree_util.tree_map(padfn, tree), ncol
