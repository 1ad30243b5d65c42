"""Multi-host initialization and cross-host meshes.

The reference has no distributed backend (single process + OpenMP). The
scaling path here (SURVEY.md section 2.8/5): initialize jax.distributed on
each host, build a global ('col', 'gpt') mesh over every process's
devices, shard columns host-locally (halo-free), and let XLA place the
collectives (NCCL over NVLink within a host, the network between hosts).
Only flux statistics / diagnostics reductions cross devices.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .sharding import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op on single-process setups).

    Pass coordinator_address (host:port of process 0), num_processes and
    process_id explicitly unless the cluster's launcher exports them for
    jax.distributed to discover. Must run before any backend use:
    probing the backend first (e.g. via jax.process_count or creating an
    array) makes distributed init impossible, so this checks
    jax.distributed's own state instead.
    """
    if jax.distributed.is_initialized():
        return
    multi = num_processes is not None and num_processes > 1
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except ValueError:
        # no coordinator discoverable from args/env: a single-process
        # environment. If the caller explicitly asked for multiple
        # processes, silently degrading to one host would compute a
        # fraction of the problem -- surface it.
        if multi:
            raise
    except RuntimeError:
        # backend already initialized (an array/device query ran first)
        # or double-init. Fatal for an intended multi-host run.
        if multi and jax.process_count() < num_processes:
            raise


def global_mesh(n_gpt: int = 1):
    """Mesh over ALL devices across hosts: 'col' spans hosts (data parallel
    over NVLink and the network), 'gpt' stays within a host's cards
    (NVLink only) so the spectral-axis collectives never cross hosts."""
    devices = np.array(jax.devices())
    return make_mesh(n_col=len(devices) // n_gpt, n_gpt=n_gpt, devices=devices.tolist())


def local_column_slice(ncol_global: int) -> tuple[int, int]:
    """This process's contiguous column range under even host splitting
    (the host-side analogue of the column block loop)."""
    p, n = jax.process_index(), jax.process_count()
    per = ncol_global // n
    start = p * per
    size = per if p < n - 1 else ncol_global - start
    return start, size
