"""Host -> device block streaming for problems larger than device memory.

The reference streams work as an OpenMP-parallel loop over column blocks
held in host memory (rrtmgp_rfmip_lw.F90:364-446). The accelerator
equivalent pipelines host->device transfers against device compute:
``device_put`` is asynchronous in JAX, so enqueueing block k+1's transfer
before consuming block k's result overlaps DMA with the running step;
outputs are fetched lazily. Combined with a mesh, each block is sharded
over the 'col' axis as it is put.
"""
from __future__ import annotations

from typing import Callable, Iterator, Sequence

import jax
import numpy as np


def iter_blocks(ncol: int, block_size: int) -> Iterator[tuple[int, int]]:
    """(start, size) pairs covering [0, ncol); the reference's nblocks
    split (block loop, rrtmgp_rfmip_lw.F90:213-215)."""
    for start in range(0, ncol, block_size):
        yield start, min(block_size, ncol - start)


def stream_blocks(
    fn: Callable,
    host_arrays: Sequence[np.ndarray],
    block_size: int,
    sharding=None,
    prefetch: int = 2,
):
    """Run ``fn`` over column blocks with transfer/compute overlap.

    fn: jitted function over device blocks (all argument arrays have the
    column axis leading). host_arrays: column-leading host arrays, equal
    ncol. Pads the last block to block_size so one compiled executable
    serves every step. Yields (start, size, result) triples.
    """
    ncol = host_arrays[0].shape[0]

    def put_block(start: int, size: int):
        args = []
        for a in host_arrays:
            blk = a[start : start + size]
            if size < block_size:
                widths = [(0, block_size - size)] + [(0, 0)] * (a.ndim - 1)
                blk = np.pad(blk, widths, mode="edge")
            args.append(jax.device_put(blk, sharding) if sharding is not None else jax.device_put(blk))
        return args

    blocks = list(iter_blocks(ncol, block_size))
    # prime the pipeline: transfers for the first `prefetch` blocks are
    # enqueued before any result is consumed
    staged = [put_block(s, n) for s, n in blocks[:prefetch]]
    for i, (start, size) in enumerate(blocks):
        if i + prefetch < len(blocks):
            staged.append(put_block(*blocks[i + prefetch]))
        args = staged.pop(0)
        yield start, size, fn(*args)


def stream_reduce(
    fn: Callable,
    host_arrays: Sequence[np.ndarray],
    block_size: int,
    out_builder: Callable[[int], list],
    sharding=None,
) -> list[np.ndarray]:
    """Stream blocks and gather trimmed results into host output arrays.

    out_builder(ncol) -> list of preallocated host outputs, one per output
    of fn (all column-leading).

    Memory contract: EVERY block's device results stay resident in HBM
    until the whole sweep finishes (see the deferred-fetch rationale
    below). That is free for the per-column-diagnostic callers this serves
    (a few floats per column), but a caller whose fn returns full
    (block, nlev, ...) profiles at >=1M columns would accumulate
    n_blocks * block-output bytes of HBM; such callers should fetch
    per-block themselves or reduce on device first.
    """
    ncol = host_arrays[0].shape[0]
    outs = out_builder(ncol)
    # Keep every block's results ON DEVICE until the sweep finishes, so no
    # device->host fetch sits between two host->device puts. Results are
    # small (per-column diagnostics), so parking them on the device is
    # free.
    pending = []
    for start, size, res in stream_blocks(fn, host_arrays, block_size, sharding):
        pending.append((start, size, res if isinstance(res, (tuple, list)) else [res]))
    for start, size, res_list in pending:
        for o, r in zip(outs, res_list):
            o[start : start + size] = np.asarray(r)[:size]
    return outs
