"""Tracing and compile-aware timing hooks (SURVEY §5 "Tracing / profiling").

The reference has no profiler; its only instrumentation is the per-event
counter set stored in the history (``src/Composites.jl:138-149``), which this
framework keeps as batched skeleton fields (``ar``, ``rejected``,
``errored_bound``, ``hitting_horizon``).  The missing pieces are *trace*
visibility — where device time goes inside the stream runner — and
*compile-aware* benchmarking, because the first call to any jitted driver
pays an XLA compile that must never be folded into a throughput number.

Four tools:

* :func:`trace` — context manager around ``jax.profiler.trace``; writes a
  TensorBoard-loadable trace (with device timelines) to ``logdir``.
* :func:`annotate` — named ``TraceAnnotation`` so sampler phases (bound
  build, thinning, recording) show up as spans inside the trace.
* :func:`timed` — compile-cache-aware timing harness: measures the first
  call (compile + run) separately from the steady state, synchronizing via
  ``block_until_ready`` on every output leaf.  ``bench.py`` and the baseline
  sweep report steady-state numbers only; this helper makes that split
  reusable and explicit.
* :func:`enable_persistent_cache` — XLA's persistent compilation cache at
  ``JAX_COMPILATION_CACHE_DIR`` or ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import jax

__all__ = ["trace", "annotate", "timed", "enable_persistent_cache"]


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False):
    """Profile everything inside the ``with`` block to ``logdir``.

    Wraps ``jax.profiler.trace`` (device + host timelines, HLO annotations).
    View with TensorBoard's profile plugin or Perfetto.  Usage::

        with profiling.trace("/tmp/pdmp-trace"):
            pf.sample_skeleton(sampler, 10_000, x0, v0, seed=0)
    """
    jax.profiler.start_trace(logdir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span inside a profiler trace (``jax.profiler.TraceAnnotation``).

    Cheap enough to leave in production paths; a no-op unless a trace is
    active.
    """
    return jax.profiler.TraceAnnotation(name)


def _block(tree):
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return tree


def timed(fn, *args, repeats: int = 3, **kwargs):
    """Time ``fn(*args, **kwargs)`` with the compile cost split out.

    Returns a dict::

        {"first_call_s":  wall of call #1 (compile + transfer + run),
         "steady_state_s": median wall of ``repeats`` subsequent calls,
         "compile_overhead_s": first - steady (>= 0),
         "result": output of the last call}

    Every call is synchronized by blocking on all output leaves, so the
    numbers are honest device walls, not dispatch walls.
    """
    t0 = time.perf_counter()
    out = _block(fn(*args, **kwargs))
    first = time.perf_counter() - t0

    walls = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        walls.append(time.perf_counter() - t0)
    walls.sort()
    steady = walls[len(walls) // 2]
    return {
        "first_call_s": first,
        "steady_state_s": steady,
        "compile_overhead_s": max(0.0, first - steady),
        "result": out,
    }


CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str:
    """Turn on XLA's persistent compilation cache so repeated processes
    skip recompiles; returns the cache directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed.  Otherwise the cache goes to the fixed
    ``<checkout>/.jax_cache`` (the path is part of what a later process
    must find again, so it never moves)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
