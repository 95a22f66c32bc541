"""Multi-host initialization and cross-host reductions.

The reference has no distributed layer at all (SURVEY.md §2).  Multi-host
runs use ``jax.distributed.initialize`` to form the process group, a global
mesh over all devices of every host, and the same ``shard_map`` chain
drivers — chain simulation requires zero
communication, so scaling is linear by construction; only diagnostics
reductions cross hosts.
"""

from __future__ import annotations

import jax
import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Form the multi-host process group (no-op when single-process).

    Thin wrapper over ``jax.distributed.initialize`` so notebooks and tests
    can call it unconditionally.
    """
    if num_processes is None or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(n_dim_devices: int = 1):
    """Mesh over every device in the pod (all processes)."""
    from . import mesh as mesh_lib

    devs = jax.devices()
    return mesh_lib.make_mesh(len(devs) // n_dim_devices, n_dim_devices, devs)


def process_local_chain_slice(total_chains: int):
    """The [start, stop) chain-index range owned by this process, for
    building process-local initial conditions with
    ``jax.make_array_from_process_local_data``."""
    p = jax.process_index()
    n = jax.process_count()
    per = total_chains // n
    return p * per, (p + 1) * per if p < n - 1 else total_chains


def host_all_gather_stats(stats: dict) -> dict:
    """Sum simple scalar stats across hosts (single-host: identity)."""
    if jax.process_count() == 1:
        return stats
    from jax.experimental import multihost_utils

    vals = np.asarray([float(stats[k]) for k in sorted(stats)])
    summed = multihost_utils.process_allgather(vals).sum(axis=0)
    return {k: summed[i] for i, k in enumerate(sorted(stats))}
