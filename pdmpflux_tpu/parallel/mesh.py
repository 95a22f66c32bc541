"""Device-mesh helpers for multi-device PDMP sampling.

The reference is strictly single-process (SURVEY.md §2: no parallel or
distributed layer exists).  The scaling axes are:

* ``chains`` — the primary axis: independent PDMP chains are embarrassingly
  parallel, so they shard over devices with zero communication during
  simulation (collectives appear only in diagnostics reductions);
* ``dim``   — optional tensor-parallel axis for very large state dimensions
  (e.g. the dim-1000 sticky configuration): positions/velocities shard over
  ``dim`` and XLA's SPMD partitioner inserts the reduce-scatter/all-reduce
  for the dot products in BPS/ECMC rates.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chains"
DIM_AXIS = "dim"


def make_mesh(n_chain_devices: int | None = None, n_dim_devices: int = 1,
              devices=None) -> Mesh:
    """Build a ``(chains, dim)`` mesh over the available devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_chain_devices is None:
        n_chain_devices = len(devices) // n_dim_devices
    use = n_chain_devices * n_dim_devices
    grid = np.asarray(devices[:use]).reshape(n_chain_devices, n_dim_devices)
    return Mesh(grid, (CHAIN_AXIS, DIM_AXIS))


def chain_spec(mesh: Mesh) -> P:
    return P(CHAIN_AXIS)


def chain_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(CHAIN_AXIS))


def state_shardings(mesh: Mesh, shard_dim: bool = False):
    """Shardings for a batched ``PDMPState``: every leaf is chain-sharded;
    with ``shard_dim`` the ``(B, d)`` leaves additionally shard over ``dim``."""
    from ..core.types import PDMPState

    dim_p = P(CHAIN_AXIS, DIM_AXIS) if shard_dim else P(CHAIN_AXIS)
    per_field = {
        "x": dim_p,
        "v": dim_p,
        "is_active": dim_p,
        "error_value_ar": P(CHAIN_AXIS),
        "key": P(CHAIN_AXIS),
    }
    specs = PDMPState(
        **{
            f: NamedSharding(mesh, per_field.get(f, P(CHAIN_AXIS)))
            for f in PDMPState._fields
        }
    )
    return specs


def skeleton_shardings(mesh: Mesh, shard_dim: bool = False):
    from ..core.types import Skeleton

    dim_p = P(CHAIN_AXIS, None, DIM_AXIS) if shard_dim else P(CHAIN_AXIS)
    per_field = {"x": dim_p, "v": dim_p, "is_active": dim_p}
    return Skeleton(
        **{
            f: NamedSharding(mesh, per_field.get(f, P(CHAIN_AXIS)))
            for f in Skeleton._fields
        }
    )
