"""Scale-out layer: device meshes, sharded chain drivers, multi-host init,
checkpointing (SURVEY.md §2 parallelism table — all absent in the
reference)."""

from .mesh import CHAIN_AXIS, DIM_AXIS, chain_sharding, make_mesh
from .sharded import (
    ShardedRun,
    pooled_moments,
    sample_from_skeleton_batch,
    sample_skeleton_gspmd,
    sample_skeleton_sharded,
)
from .distributed import global_mesh, initialize
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "CHAIN_AXIS",
    "DIM_AXIS",
    "chain_sharding",
    "make_mesh",
    "ShardedRun",
    "pooled_moments",
    "sample_from_skeleton_batch",
    "sample_skeleton_gspmd",
    "sample_skeleton_sharded",
    "global_mesh",
    "initialize",
    "load_checkpoint",
    "save_checkpoint",
]
