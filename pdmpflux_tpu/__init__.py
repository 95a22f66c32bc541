"""pdmpflux_tpu — a Piecewise-Deterministic Markov Process sampling
framework in JAX / XLA, run on NVIDIA GPUs.

Built from scratch with the capabilities of PDMPFlux.jl (see SURVEY.md),
re-architected for batched accelerators:

* one flat jit-compiled transition state machine instead of nested
  interpreter loops (``core/engine.py``);
* thinning envelopes as pure batched tensor math with exact ``jax.jvp``
  time-derivatives (``core/bounds.py``);
* native chain batching via ``vmap`` and pod-scale sharding via
  ``jax.sharding`` meshes (``parallel/``);
* counter-based per-chain PRNG keys for full determinism.
"""

from .api import (
    sample,
    sample_from_skeleton,
    sample_skeleton,
    sample_skeleton_with_diagnostic,
)
from .core.types import (
    BoundBox,
    Event,
    PDMPState,
    Skeleton,
    EV_INIT,
    EV_JUMP,
    EV_NONE,
    EV_STICK,
    EV_TERMINAL,
    EV_THAW,
)
from .models import (
    BPS,
    BPSAD,
    Boomerang,
    BoomerangAD,
    ForwardECMC,
    ForwardECMCAD,
    PDMP,
    RHMC,
    RHMCAD,
    SpeedUpZigZag,
    SpeedUpZigZagAD,
    StickyZigZag,
    StickyZigZagAD,
    ZigZag,
    ZigZagAD,
)

from . import diagnostics, parallel, plotting, utils
from .diagnostics import RV_diagnostic, diagnostic, ess, ess_per_dim
from .streaming import sample_streaming_stats, streaming_summary
from .plotting import (
    anim_traj,
    anim_traj_,
    jointplot,
    marginalplot,
    plot_U_contour,
    plot_traj,
)

__version__ = "1.0.0"

__all__ = [
    "sample",
    "sample_from_skeleton",
    "sample_skeleton",
    "sample_skeleton_with_diagnostic",
    "sample_streaming_stats",
    "streaming_summary",
    "BoundBox",
    "Event",
    "PDMPState",
    "Skeleton",
    "EV_INIT",
    "EV_JUMP",
    "EV_NONE",
    "EV_STICK",
    "EV_TERMINAL",
    "EV_THAW",
    "PDMP",
    "ZigZag",
    "ZigZagAD",
    "BPS",
    "BPSAD",
    "Boomerang",
    "BoomerangAD",
    "ForwardECMC",
    "ForwardECMCAD",
    "RHMC",
    "RHMCAD",
    "SpeedUpZigZag",
    "SpeedUpZigZagAD",
    "StickyZigZag",
    "StickyZigZagAD",
]
