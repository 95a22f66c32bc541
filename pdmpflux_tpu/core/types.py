"""Core data structures of the PDMP engine.

Everything is an immutable pytree of arrays (``typing.NamedTuple``) so that it
can flow through ``jax.jit`` / ``jax.vmap`` / ``jax.lax.while_loop`` and be
sharded over a device mesh.  This replaces the reference's mutable structs
(``PDMPState`` / ``PDMPHistory`` / ``BoundBox`` in
``/root/reference/src/Composites.jl:15-260``) with a functional design:

* ``BoundBox``   — the piecewise-constant thinning envelope (Composites.jl:15-20).
* ``PDMPState``  — per-chain evolving state (Composites.jl:59-135).  Unlike the
  reference, the envelope itself is NOT stored in the state: it is a pure
  function of ``(x, v_active, bound_horizon)`` and is recomputed on demand —
  on SIMD hardware all vmap lanes pay for the computation regardless, so
  caching it would only waste memory and break functional purity.  Only the
  two scalars needed to reproduce it deterministically (``bound_h`` and the
  cumulative ``exp_rv``) are carried.
* ``Skeleton``   — struct-of-arrays event storage (Composites.jl:138-164),
  with a leading event axis (and an optional leading chain-batch axis).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

# ---------------------------------------------------------------------------
# Transition-machine modes.  The reference expresses these as positions in
# three nested while-loops (SamplingLoopInplace.jl:27-217); here they are an
# explicit scalar so a single flat transition function can dispatch on them.
# ---------------------------------------------------------------------------
MODE_FRESH = 0      # current (bound_h, exp_rv) form a fresh outer proposal
MODE_REJECTED = 1   # exp_rv is cumulative after >=1 thinning rejection
MODE_ERRONEOUS = 2  # proposal comes from a half-horizon rebuild after ar > 1

# Event kinds recorded in the skeleton.
EV_NONE = 0      # transition produced no event
EV_INIT = 1      # initial state (column 1 of the reference history)
EV_JUMP = 2      # accepted thinning event (velocity jump applied)
EV_STICK = 3     # sticky sampler froze a coordinate at an axis
EV_THAW = 4      # sticky sampler released a frozen coordinate
EV_TERMINAL = 5  # synthesized exact-t=T point (time-horizon sampling)

ERROR_RING_SIZE = 5  # ring buffer of recent erroneous acceptance ratios


class BoundBox(NamedTuple):
    """Piecewise-constant upper bound of the event rate on ``[0, horizon]``.

    Mirrors ``BoundBox`` at ``/root/reference/src/Composites.jl:15-20``:

    * ``grid``:     ``(n_grid,)`` time points, ``grid[0] == 0``.
    * ``box_max``:  ``(n_grid - 1,)`` per-segment envelope values.
    * ``cum_sum``:  ``(n_grid,)`` integrated envelope, ``cum_sum[0] == 0``.
    * ``step_size``: scalar grid spacing (uniform grid).
    """

    grid: Array
    box_max: Array
    cum_sum: Array
    step_size: Array


class PDMPState(NamedTuple):
    """Per-chain evolving state of the PDMP event engine.

    Counterpart of ``PDMPState`` (``/root/reference/src/Composites.jl:59-135``)
    re-expressed for a flat, jit-compiled transition machine.  All leaves are
    arrays; a chain batch adds a leading axis to every leaf (use
    ``jax.vmap``).

    Time accumulation uses Kahan compensation (``t`` + ``t_comp``) so that
    float32 runs keep event-clock accuracy over millions of events.
    """

    x: Array            # (d,) position
    v: Array            # (d,) velocity (full, including frozen coordinates)
    t: Array            # ()  committed event-clock time
    t_comp: Array       # ()  Kahan compensation term for t
    ts: Array           # ()  time already flowed since the last committed event
    horizon: Array      # ()  adaptive thinning horizon (reference: state.horizon)
    bound_h: Array      # ()  horizon the CURRENT proposal's envelope covers
    exp_rv: Array       # ()  cumulative Exp(1) draw of the current proposal
    tt: Array           # ()  time-to-thaw clock (sticky samplers; +inf otherwise)
    mode: Array         # ()  int32, one of MODE_*
    ar: Array           # ()  last computed acceptance ratio (recorded in events)
    is_active: Array    # (d,) bool sticky activity mask (all True if not sticky)
    rejected: Array     # ()  int32, thinning rejections since last event
    errored_bound: Array    # () int32, bound violations since last event
    hitting_horizon: Array  # () int32, horizon hits since last event
    error_value_ar: Array   # (ERROR_RING_SIZE,) ring buffer of erroneous ars
    key: Array          # jax PRNG key


class Event(NamedTuple):
    """Snapshot emitted by one transition; ``kind == EV_NONE`` means no event.

    Field-for-field equivalent of one column written by ``record!``
    (``/root/reference/src/Composites.jl:239-260``) plus an explicit ``kind``
    tag (the reference infers stick/thaw events from ``is_active`` diffs).
    """

    kind: Array             # () int32 EV_*
    x: Array                # (d,)
    v: Array                # (d,)
    t: Array                # ()
    horizon: Array          # ()
    ar: Array               # ()
    is_active: Array        # (d,) bool
    rejected: Array         # () int32
    errored_bound: Array    # () int32
    hitting_horizon: Array  # () int32
    error_value_ar: Array   # (ERROR_RING_SIZE,)


class Skeleton(NamedTuple):
    """Struct-of-arrays event history — ``PDMPHistory`` re-done as a pytree.

    Leading axes: ``(n_events, ...)`` for a single chain or
    ``(n_chains, n_events, ...)`` for a batch.  ``n_valid`` carries the number
    of filled slots per chain (time-horizon sampling does not know the event
    count a priori; the reference grows/trims, ``Composites.jl:172-214`` — we
    preallocate and track fill counts instead, which is the fixed-shape XLA
    equivalent).
    """

    x: Array                # (N, d)
    v: Array                # (N, d)
    t: Array                # (N,)
    horizon: Array          # (N,)
    ar: Array               # (N,)
    is_active: Array        # (N, d) bool
    rejected: Array         # (N,) int32
    errored_bound: Array    # (N,) int32
    hitting_horizon: Array  # (N,) int32
    error_value_ar: Array   # (N, ERROR_RING_SIZE)
    kind: Array             # (N,) int32 EV_*
    n_valid: Array          # ()  int32 (or (B,) for a batch)


def kahan_add(total: Array, comp: Array, increment: Array):
    """One step of Kahan compensated summation: returns new (total, comp)."""
    y = increment - comp
    s = total + y
    comp = (s - total) - y
    return s, comp


def state_dtype(state: PDMPState):
    return state.x.dtype


def event_from_state(state: PDMPState, kind) -> Event:
    """Build an event record snapshotting the (already updated) state."""
    return Event(
        kind=jnp.asarray(kind, jnp.int32),
        x=state.x,
        v=state.v,
        t=state.t,
        horizon=state.horizon,
        ar=state.ar,
        is_active=state.is_active,
        rejected=state.rejected,
        errored_bound=state.errored_bound,
        hitting_horizon=state.hitting_horizon,
        error_value_ar=state.error_value_ar,
    )


def empty_skeleton(n_events: int, dim: int, dtype, batch_shape=()) -> Skeleton:
    """Preallocate an event buffer (the XLA analogue of ``PDMPHistory(d, n)``)."""
    f = lambda *s: jnp.zeros(batch_shape + s, dtype)
    i = lambda *s: jnp.zeros(batch_shape + s, jnp.int32)
    return Skeleton(
        x=f(n_events, dim),
        v=f(n_events, dim),
        t=f(n_events),
        horizon=f(n_events),
        ar=f(n_events),
        is_active=jnp.zeros(batch_shape + (n_events, dim), bool),
        rejected=i(n_events),
        errored_bound=i(n_events),
        hitting_horizon=i(n_events),
        error_value_ar=f(n_events, ERROR_RING_SIZE),
        kind=i(n_events),
        n_valid=jnp.zeros(batch_shape, jnp.int32),
    )
