"""The PDMP event engine: one flat, jit-compiled transition state machine.

The reference drives each event with three nested, unbounded ``while`` loops
(``/root/reference/src/SamplingLoopInplace.jl:27-217`` and the sticky variant
``StickySamplingLoop.jl:13-164``).  That shape is hostile to SPMD hardware:
under ``vmap`` every lane would wait for the slowest lane's event.

Here the entire control flow is flattened into a single pure function

    ``transition(state) -> (state', event)``

that advances a chain by exactly one *transition* — one bound build + one
thinning decision (or a horizon move / stick / thaw).  All branches are
evaluated densely and combined with ``jnp.where`` (on SIMD hardware every
vmap lane pays for every branch regardless, so predication is free), and the
envelope is *recomputed* instead of cached: it is a deterministic pure
function of ``(x, v_active, bound_h)``, so rebuilding it after a rejection
reproduces the reference's cached ``BoundBox`` bit-for-bit within a compiled
program, while keeping the state a small fixed pytree.

Mode bookkeeping replaces loop positions (see ``types.MODE_*``):

* ``FRESH``      — next ``tp > horizon`` triggers ``move_to_horizon!`` with
  adaptive growth ×1.01 (SamplingLoopInplace.jl:87-101);
* ``REJECTED``   — cumulative ``exp_rv``; ``tp > horizon`` triggers
  ``move_to_horizon2!`` (no growth, :205-217);
* ``ERRONEOUS``  — proposal from a half-horizon rebuild after a bound
  violation (:131-151); ``tp > horizon`` resets without flowing (the
  reference exits the inner loop without moving).

Event transitions (accept / stick / thaw) commit time with Kahan
compensation and emit an ``Event`` record; drivers below scatter those into
preallocated ``Skeleton`` buffers at per-chain indices, so no lane ever
waits for another lane's event (the "transition stream" design).

Documented deviations from the reference (law-affecting reference bugs are
fixed, envelope-side quirks are preserved — envelope slack never changes the
sampled law, only efficiency):

* thaw events commit ``t += tt + ts`` rather than dropping the accumulated
  ``ts`` (``StickySamplingLoop.jl:160`` adds only ``tt`` — a time-accounting
  bug);
* the sticky axis-hit time uses the exact ``-x_j / v_j`` rather than
  ``-x_j * v_j`` (StickySamplingLoop.jl:79 assumes unit speeds; identical
  when ``|v_j| == 1``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from . import bounds
from .types import (
    EV_JUMP,
    EV_NONE,
    EV_STICK,
    EV_TERMINAL,
    EV_THAW,
    MODE_ERRONEOUS,
    MODE_FRESH,
    MODE_REJECTED,
    ERROR_RING_SIZE,
    Event,
    PDMPState,
    Skeleton,
    empty_skeleton,
    event_from_state,
    kahan_add,
)

HORIZON_GROW = 1.01   # move_to_horizon!       (SamplingLoopInplace.jl:98)
HORIZON_SHRINK = 1.04 # if_reject!             (SamplingLoopInplace.jl:194)
# erroneous_acceptance_rate! halves             (SamplingLoopInplace.jl:131-151)


def _bcast(pred, like):
    """Broadcast a scalar predicate against an array for jnp.where."""
    return jnp.reshape(pred, pred.shape + (1,) * (like.ndim - pred.ndim))


def tree_select(pred, on_true, on_false):
    """Leafwise ``where`` with a per-chain boolean (used to freeze done chains)."""
    return jax.tree.map(
        lambda a, b: jnp.where(_bcast(pred, a), a, b), on_true, on_false
    )


def make_transition(sampler) -> Callable[[PDMPState], tuple]:
    """Build the single-chain transition function for ``sampler``.

    Batch over chains with ``jax.vmap``; the function is fully pure.
    """
    sticky = sampler.sticky
    adaptive = sampler.adaptive
    flow = sampler.flow
    rate_fn = sampler.rate
    bound_fn = sampler.bound_box
    jump_fn = sampler.velocity_jump

    def draw_tt(key, is_active, dtype):
        """Thaw clock ``tt ~ Exp(1)/sum(kappa[frozen])`` (StickySamplingLoop.jl:38-44)."""
        if not sticky:
            return jnp.asarray(jnp.inf, dtype)
        kappa = jnp.asarray(sampler.kappa, dtype)
        rate_thaw = jnp.sum(jnp.where(is_active, 0.0, kappa))
        e = jax.random.exponential(key, dtype=dtype)
        return jnp.where(rate_thaw > 0, e / jnp.where(rate_thaw > 0, rate_thaw, 1.0), jnp.inf)

    def transition(state: PDMPState):
        dtype = state.x.dtype
        key, k_exp, k_u, k_jump, k_tt, k_thaw = jax.random.split(state.key, 6)

        va = jnp.where(state.is_active, state.v, jnp.zeros_like(state.v))

        # ---- proposal: rebuild envelope + invert at cumulative exp_rv ----
        box = bound_fn(state.x, va, state.bound_h)
        tp, lam_bar = bounds.next_event(box, state.exp_rv)

        fresh = state.mode == MODE_FRESH
        erroneous = state.mode == MODE_ERRONEOUS

        # ---- thinning evaluation at tp (ac_step!, :113-129) --------------
        tp_safe = jnp.where(jnp.isfinite(tp), tp, jnp.zeros((), dtype))
        lam_t = rate_fn(state.x, va, tp_safe)
        # Raw ratio: inf / nan semantics intentionally match the reference
        # (ar > 1 -> erroneous; rand() < nan -> reject).
        ar_new = lam_t / lam_bar

        min_pt = jnp.minimum(tp, state.tt)

        # ---- sticky: axis-crossing check at a fresh proposal -------------
        if sticky:
            event_time = jnp.minimum(min_pt, state.horizon)
            x_probe, _ = flow(state.x, va, event_time)
            any_crossing = jnp.any(state.x * x_probe < 0)
            v_safe = jnp.where(va == 0, jnp.ones_like(va), va)
            tj = jnp.where(
                state.is_active & (state.x * state.v < 0) & (va != 0),
                -state.x / v_safe,
                jnp.inf,
            )
            t_togo = jnp.min(tj)
            i_stick = jnp.argmin(tj)
            crossed = fresh & any_crossing & jnp.isfinite(t_togo)
        else:
            crossed = jnp.zeros((), bool)
            t_togo = jnp.zeros((), dtype)
            i_stick = jnp.zeros((), jnp.int32)

        # ---- branch predicates (mutually exclusive, exhaustive) ----------
        beyond = min_pt > state.horizon
        p_stick = crossed
        p_moveh = (~crossed) & beyond & (~erroneous)
        p_erreset = (~crossed) & beyond & erroneous
        thin = (~crossed) & (~beyond)
        if sticky:
            p_thaw = thin & (state.tt <= tp)
            p_ac = thin & (tp < state.tt)
        else:
            p_thaw = jnp.zeros((), bool)
            p_ac = thin
        p_err = p_ac & (ar_new > 1.0)
        p_proxy = p_ac & ~p_err
        u = jax.random.uniform(k_u, dtype=dtype)
        acc_draw = u < ar_new  # false for nan ar, like Julia rand() < NaN
        p_acc = p_proxy & acc_draw
        p_rej = p_proxy & ~acc_draw

        # ---- one flow evaluation at the branch-selected time -------------
        flow_time = jnp.where(
            p_stick,
            t_togo,
            jnp.where(
                p_moveh,
                state.horizon,
                jnp.where(p_thaw, state.tt, jnp.where(p_acc, tp_safe, 0.0)),
            ),
        )
        x_f, v_f = flow(state.x, va, flow_time)
        does_flow = p_stick | p_moveh | p_thaw | p_acc
        x_new = jnp.where(_bcast(does_flow, x_f), x_f, state.x)
        # With frozen coordinates the flowed velocity is the masked one and
        # must not overwrite the latent full velocity (SamplingLoopInplace.jl:89-94).
        all_active = jnp.all(state.is_active)
        v_flowed = jnp.where(all_active, v_f, state.v)
        v_after = jnp.where(_bcast(does_flow, v_flowed), v_flowed, state.v)

        # ---- velocity jump (if_accept!, :170-186) ------------------------
        v_jumped = jump_fn(x_new, v_after, k_jump, state.is_active)
        v_new = jnp.where(_bcast(p_acc, v_jumped), v_jumped, v_after)

        # ---- sticky activity updates -------------------------------------
        if sticky:
            kappa = jnp.asarray(sampler.kappa, dtype)
            act_stick = state.is_active.at[i_stick].set(False)
            neg_inf = jnp.asarray(-jnp.inf, dtype)
            logits = jnp.where(state.is_active, neg_inf, jnp.log(kappa))
            i_thaw = jax.random.categorical(k_thaw, logits)
            act_thaw = state.is_active.at[i_thaw].set(True)
            is_active_new = jnp.where(
                _bcast(p_stick, act_stick),
                act_stick,
                jnp.where(_bcast(p_thaw, act_thaw), act_thaw, state.is_active),
            )
        else:
            is_active_new = state.is_active

        # ---- time commitment (Kahan-compensated) -------------------------
        inc = (
            jnp.where(p_stick, t_togo, jnp.where(p_thaw, state.tt, tp_safe))
            + state.ts
        )
        t_k, tc_k = kahan_add(state.t, state.t_comp, inc)
        is_event = p_acc | p_stick | p_thaw
        t_new = jnp.where(is_event, t_k, state.t)
        tc_new = jnp.where(is_event, tc_k, state.t_comp)
        ts_new = jnp.where(
            is_event,
            jnp.zeros((), dtype),
            jnp.where(p_moveh, state.ts + state.horizon, state.ts),
        )

        # ---- horizon adaptation ------------------------------------------
        h = state.horizon
        if adaptive:
            h = jnp.where(p_moveh & fresh, h * HORIZON_GROW, h)
            h = jnp.where(p_err, h * 0.5, h)
            h = jnp.where(p_rej, h / HORIZON_SHRINK, h)

        # ---- counters -----------------------------------------------------
        hitting = state.hitting_horizon + p_moveh.astype(jnp.int32)
        rejected = state.rejected + p_rej.astype(jnp.int32)
        errored = state.errored_bound + p_err.astype(jnp.int32)
        ring_idx = jnp.mod(errored, ERROR_RING_SIZE)
        ring_err = state.error_value_ar.at[ring_idx].set(ar_new.astype(dtype))
        ring = jnp.where(_bcast(p_err, ring_err), ring_err, state.error_value_ar)

        # ---- proposal bookkeeping ----------------------------------------
        reset = p_stick | p_moveh | p_erreset | p_thaw | p_acc
        e_draw = jax.random.exponential(k_exp, dtype=dtype)
        exp_new = jnp.where(
            reset | p_err,
            e_draw,
            jnp.where(p_rej, state.exp_rv + e_draw, state.exp_rv),
        )
        mode_new = jnp.where(
            reset,
            MODE_FRESH,
            jnp.where(
                p_err, MODE_ERRONEOUS, jnp.where(p_rej, MODE_REJECTED, state.mode)
            ),
        ).astype(jnp.int32)
        bound_h_new = jnp.where(
            reset, h, jnp.where(p_err, state.horizon * 0.5, state.bound_h)
        )
        tt_fresh = draw_tt(k_tt, is_active_new, dtype)
        tt_new = jnp.where(reset, tt_fresh, state.tt)
        ar_state = jnp.where(p_ac, ar_new.astype(dtype), state.ar)

        new_state = PDMPState(
            x=x_new,
            v=v_new,
            t=t_new,
            t_comp=tc_new,
            ts=ts_new,
            horizon=h,
            bound_h=bound_h_new,
            exp_rv=exp_new,
            tt=tt_new,
            mode=mode_new,
            ar=ar_state,
            is_active=is_active_new,
            rejected=rejected,
            errored_bound=errored,
            hitting_horizon=hitting,
            error_value_ar=ring,
            key=key,
        )

        kind = jnp.where(
            p_acc,
            EV_JUMP,
            jnp.where(p_stick, EV_STICK, jnp.where(p_thaw, EV_THAW, EV_NONE)),
        ).astype(jnp.int32)
        event = event_from_state(new_state, kind)
        # Rows carry the *trajectory* time t + ts: identical to the committed
        # event time at events (ts == 0 after a commit), and the physical
        # time of the advanced position after horizon moves — which makes a
        # dense stream of transition rows a valid (finer-grained) skeleton
        # for interpolation (see the stream runners below).
        event = event._replace(t=new_state.t + new_state.ts)

        # Counters reset after each recorded event (get_event_state!, :28-31).
        zero_i = jnp.zeros((), jnp.int32)
        new_state = new_state._replace(
            rejected=jnp.where(is_event, zero_i, new_state.rejected),
            errored_bound=jnp.where(is_event, zero_i, new_state.errored_bound),
            hitting_horizon=jnp.where(is_event, zero_i, new_state.hitting_horizon),
            error_value_ar=jnp.where(
                _bcast(is_event, ring), jnp.zeros_like(ring), new_state.error_value_ar
            ),
        )
        return new_state, event

    return transition


# ---------------------------------------------------------------------------
# Skeleton buffer scatter
# ---------------------------------------------------------------------------

def _scatter_event(skel: Skeleton, ev: Event, slot, write_mask) -> Skeleton:
    """Write batched event records into per-chain slots.

    ``slot``/``write_mask`` are ``(B,)``; records route to
    ``buf[b, slot[b]]`` with masked-out lanes dropped via an out-of-bounds
    index (XLA scatter ``mode='drop'``) — the fixed-shape replacement of the
    reference's ``record!`` column copy (``Composites.jl:239-260``).
    """
    B = slot.shape[0]
    cap = skel.t.shape[1]
    bidx = jnp.arange(B)
    eidx = jnp.where(write_mask, slot, cap)  # cap is out of bounds -> dropped

    def w(buf, val):
        return buf.at[bidx, eidx].set(val, mode="drop")

    return Skeleton(
        x=w(skel.x, ev.x),
        v=w(skel.v, ev.v),
        t=w(skel.t, ev.t),
        horizon=w(skel.horizon, ev.horizon),
        ar=w(skel.ar, ev.ar),
        is_active=w(skel.is_active, ev.is_active),
        rejected=w(skel.rejected, ev.rejected),
        errored_bound=w(skel.errored_bound, ev.errored_bound),
        hitting_horizon=w(skel.hitting_horizon, ev.hitting_horizon),
        error_value_ar=w(skel.error_value_ar, ev.error_value_ar),
        kind=w(skel.kind, ev.kind),
        n_valid=skel.n_valid + write_mask.astype(jnp.int32),
    )


def record_initial(skel: Skeleton, state: PDMPState, kind) -> Skeleton:
    """Record the batched initial state into slot 0 (reference history col 1)."""
    B = state.t.shape[0]
    ev = jax.vmap(lambda s: event_from_state(s, kind))(state)
    return _scatter_event(skel, ev, jnp.zeros((B,), jnp.int32), jnp.ones((B,), bool))


# ---------------------------------------------------------------------------
# Drivers (scan-chunked transition streams)
#
# Scattering each event into the big (B, N, ...) skeleton buffers from
# inside a `while_loop` body defeats XLA's in-place buffer updates
# (data-dependent scatter indices).  The drivers therefore run transitions
# in `lax.scan` chunks (scan outputs are written in place at the loop
# index), then compact each chunk's events into the skeleton with ONE
# batched scatter per chunk, amortizing the buffer traffic over `chunk`
# transitions.  This scatter recorder is the plain reference the stream
# recorder below is tested against.
# ---------------------------------------------------------------------------

class RunResult(NamedTuple):
    state: PDMPState        # batched final state
    skeleton: Skeleton      # batched event buffers
    transitions: jax.Array  # () int32 total transitions executed

DEFAULT_CHUNK = 64


def _compact_chunk(skel: Skeleton, evs: Event, counts, capacity: int):
    """Append a scan chunk of events (leading axis = transitions) to the
    per-chain skeleton buffers with a single batched scatter.

    ``evs`` leaves have shape ``(C, B, ...)``; event j of chain b goes to
    slot ``counts[b] + rank`` where ``rank`` is its ordinal among the
    chunk's events of that chain.  Non-events and overflow slots route out
    of bounds and are dropped.
    """
    C, B = evs.kind.shape
    is_ev = evs.kind > 0
    ranks = jnp.cumsum(is_ev.astype(jnp.int32), axis=0) - 1  # (C, B)
    slots = counts[None, :] + ranks
    write = is_ev & (slots < capacity)
    slot_safe = jnp.where(write, slots, capacity)  # capacity is OOB -> dropped
    bidx = jnp.broadcast_to(jnp.arange(B)[None, :], (C, B))

    def w(buf, val):
        return buf.at[bidx, slot_safe].set(val, mode="drop")

    new_counts = counts + jnp.sum(write, axis=0, dtype=jnp.int32)
    return Skeleton(
        x=w(skel.x, evs.x),
        v=w(skel.v, evs.v),
        t=w(skel.t, evs.t),
        horizon=w(skel.horizon, evs.horizon),
        ar=w(skel.ar, evs.ar),
        is_active=w(skel.is_active, evs.is_active),
        rejected=w(skel.rejected, evs.rejected),
        errored_bound=w(skel.errored_bound, evs.errored_bound),
        hitting_horizon=w(skel.hitting_horizon, evs.hitting_horizon),
        error_value_ar=w(skel.error_value_ar, evs.error_value_ar),
        kind=w(skel.kind, evs.kind),
        n_valid=new_counts,
    )


def _make_chunk_runner(sampler, capacity: int, max_transitions: int,
                       chunk: int, live_fn):
    """Shared scan-chunked driver.  ``live_fn(state, counts) -> (B,) bool``
    decides which chains still advance; finished chains are frozen via
    ``tree_select`` so the returned state is exactly the state at each
    chain's last recorded event (the reference keeps ``sampler.state`` for
    continuation, ``sample.jl:281``)."""
    vtrans = jax.vmap(make_transition(sampler))
    n_chunks = max(1, -(-max_transitions // chunk))

    def chunk_body(state, counts):
        def body(carry, _):
            state, counts = carry
            live = live_fn(state, counts)
            new_state, ev = vtrans(state)
            new_state = tree_select(live, new_state, state)
            kind = jnp.where(live, ev.kind, jnp.zeros_like(ev.kind))
            counts = counts + (kind > 0).astype(jnp.int32)
            return (new_state, counts), ev._replace(kind=kind)

        (state, counts), evs = jax.lax.scan(
            body, (state, counts), None, length=chunk
        )
        return state, counts, evs

    def run(state: PDMPState, skel: Skeleton) -> RunResult:
        def cond(carry):
            state, skel, it = carry
            return (it < n_chunks) & jnp.any(live_fn(state, skel.n_valid))

        def body(carry):
            state, skel, it = carry
            state, _, evs = chunk_body(state, skel.n_valid)
            # _compact_chunk recomputes the same counts from the write mask.
            skel = _compact_chunk(skel, evs, skel.n_valid, capacity)
            return state, skel, it + 1

        state, skel, it = jax.lax.while_loop(
            cond, body, (state, skel, jnp.zeros((), jnp.int32))
        )
        return RunResult(state, skel, it * chunk)

    return run


class StreamResult(NamedTuple):
    state: PDMPState      # batched final state
    stream: Skeleton      # (B, T_cap, ...) dense transition-row stream;
                          # n_valid = rows written (same for every chain)
    counts: jax.Array     # (B,) events recorded in the stream per chain
    transitions: jax.Array  # () int32 transitions executed


def make_stream_runner(sampler, t_cap: int, chunk: int = DEFAULT_CHUNK,
                       mode: str = "events"):
    """Stream recorder: transitions stream densely into a
    ``(B, t_cap, ...)`` buffer at the chunk offset via contiguous
    ``dynamic_update_slice`` — no scatter anywhere in the loop, so every
    write is a contiguous slab update instead of a data-dependent scatter
    per event.  The emitted rows carry trajectory time ``t + ts`` (see
    ``make_transition``), so the raw stream is itself a valid skeleton —
    monotone in time per chain, with ``kind > 0`` marking true events.
    Consumers interpolate directly on the stream; the event-only view is
    extracted by :func:`compact_stream_rows`.

    Chains that reach ``n_events_target`` are frozen and emit ``kind = 0``
    duplicate rows (harmless for interpolation).
    """
    vtrans = jax.vmap(make_transition(sampler))
    n_chunks = t_cap // chunk
    if t_cap % chunk:
        raise ValueError(f"t_cap={t_cap} must be a multiple of chunk={chunk}")

    def run(state: PDMPState, stream: Skeleton, counts, target) -> StreamResult:
        def live_of(state, counts):
            # "events": run until `target` events per chain;
            # "horizon": run until the event clock passes time `target`.
            if mode == "horizon":
                return state.t < target
            return counts < target

        def cond(carry):
            state, stream, counts, it = carry
            return (it < n_chunks) & jnp.any(live_of(state, counts))

        def body(carry):
            state, stream, counts, it = carry

            def step(c, _):
                state, counts = c
                live = live_of(state, counts)
                ns, ev = vtrans(state)
                ns = tree_select(live, ns, state)
                kind = jnp.where(live, ev.kind, jnp.zeros_like(ev.kind))
                counts = counts + (kind > 0).astype(jnp.int32)
                return (ns, counts), ev._replace(kind=kind)

            (state, counts), evs = jax.lax.scan(
                step, (state, counts), None, length=chunk
            )
            # (C, B, ...) -> (B, C, ...) slabs, written at the chunk offset
            offset = it * chunk

            def write(buf, val):
                val = jnp.moveaxis(val, 0, 1).astype(buf.dtype)
                zero = jnp.zeros_like(offset)
                start = (zero, offset) + (zero,) * (buf.ndim - 2)
                return jax.lax.dynamic_update_slice(buf, val, start)

            stream = Skeleton(
                x=write(stream.x, evs.x),
                v=write(stream.v, evs.v),
                t=write(stream.t, evs.t),
                horizon=write(stream.horizon, evs.horizon),
                ar=write(stream.ar, evs.ar),
                is_active=write(stream.is_active, evs.is_active),
                rejected=write(stream.rejected, evs.rejected),
                errored_bound=write(stream.errored_bound, evs.errored_bound),
                hitting_horizon=write(stream.hitting_horizon, evs.hitting_horizon),
                error_value_ar=write(stream.error_value_ar, evs.error_value_ar),
                kind=write(stream.kind, evs.kind),
                n_valid=stream.n_valid + chunk,
            )
            return state, stream, counts, it + 1

        state, stream, counts, it = jax.lax.while_loop(
            cond, body, (state, stream, counts, jnp.zeros((), jnp.int32))
        )
        return StreamResult(state, stream, counts, it * chunk)

    return run


def empty_stream(t_cap: int, dim: int, dtype, B: int) -> Skeleton:
    skel = empty_skeleton(t_cap, dim, dtype, batch_shape=(B,))
    return skel._replace(n_valid=jnp.zeros((B,), jnp.int32))


GATHER_DIM_THRESHOLD = 1
"""State dimension from which row compaction and merges use the
index-gather formulation instead of log-shift passes.  The gather moves
every row once, where log-shift makes ``ceil(log2 T)`` dense passes; on an
H100 it was 3.1x to 8.1x faster at every dimension measured (d = 2 to
1000, 2,816-row flagship fills), so every dimension gathers.  The
bit-identical log-shift formulations stay as the reference the tests and
``chip_smoke.py`` compare against."""


def compact_stream_rows(stream: Skeleton, n_keep: int) -> Skeleton:
    """Stable-partition each chain's stream so event rows (``kind > 0``)
    come first in time order, keeping the first ``n_keep``; all on device.

    Rows beyond a chain's event count are zeroed padding with ``kind == 0``
    (callers track counts separately).  Because the result is itself a
    valid stream, multi-fill accumulation is just
    ``compact_stream_rows(concat(acc, fill), n_keep)``.

    Two formulations with bit-identical results, dispatched on the state
    dimension (:data:`GATHER_DIM_THRESHOLD`): :func:`_compact_rows_logshift`
    below it, :func:`_compact_rows_gather` at or above it.
    """
    if stream.x.shape[-1] >= GATHER_DIM_THRESHOLD:
        return _compact_rows_gather(stream, n_keep)
    return _compact_rows_logshift(stream, n_keep)


def _compact_rows_logshift(stream: Skeleton, n_keep: int) -> Skeleton:
    """Log-shift formulation of :func:`compact_stream_rows`: each kept row
    must slide down by ``shift = (#non-event rows before it)``;
    ``ceil(log2 T)`` passes move rows whose remaining shift has bit ``p``
    set down by ``2**p`` via a masked shifted-select.  Shifts are
    non-decreasing in row order, so LSB-first moves never collide (classic
    SIMD stream-compaction result).  Every pass is a dense slice + ``where``
    — no scatter, no gather, no sort."""
    kind = stream.kind
    B, T = kind.shape
    keep = kind > 0
    pos = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1  # event ordinal
    total = jnp.where(keep.any(axis=1), pos[:, -1] + 1, 0)
    shift = jnp.where(keep, jnp.arange(T, dtype=jnp.int32)[None, :] - pos, 0)
    fields = {f: getattr(stream, f) for f in Skeleton._fields
              if f != "n_valid"}
    nbits = max(1, int(T - 1).bit_length())

    for p in range(nbits):
        step = 1 << p
        move_src = keep & (((shift >> p) & 1) == 1)  # moves down by step

        def shifted(a, _s=step):
            pad = [(0, 0)] * a.ndim
            pad[1] = (0, _s)
            return jnp.pad(a, pad)[:, _s:T + _s]

        inc = shifted(move_src)  # inc[i]: row at i+step moves into i
        for f, a in fields.items():
            m = inc.reshape(inc.shape + (1,) * (a.ndim - 2))
            fields[f] = jnp.where(m, shifted(a), a)
        keep = inc | (keep & ~move_src)
        shift = jnp.where(inc, shifted(shift) - step,
                          jnp.where(move_src, 0, shift))

    pad_mask = (jnp.arange(n_keep, dtype=jnp.int32)[None, :]
                >= jnp.minimum(total, n_keep)[:, None])
    out = {}
    for f, a in fields.items():
        a = a[:, :n_keep] if n_keep <= T else jnp.pad(
            a, [(0, 0), (0, n_keep - T)] + [(0, 0)] * (a.ndim - 2)
        )
        m = pad_mask.reshape(pad_mask.shape + (1,) * (a.ndim - 2))
        out[f] = jnp.where(m, jnp.zeros((), a.dtype), a)
    return Skeleton(**out, n_valid=stream.n_valid)


_ROW_FIELDS = tuple(f for f in Skeleton._fields if f != "n_valid")


def _compact_rows_gather(stream: Skeleton, n_keep: int,
                         init_ev: Event | None = None) -> Skeleton:
    """Index-gather formulation of :func:`compact_stream_rows`: the
    kept-row permutation is computed on the tiny ``(B, T)`` kind array
    (stable argsort of the keep mask), then each field is moved with ONE
    ``take_along_axis`` of whole rows.

    With ``init_ev``, the initial-state record is fused into the same
    gather pass as column 0 (output width ``n_keep + 1``) — one pass over
    the data instead of compaction followed by a full-width prepend copy.
    """
    kind = stream.kind
    keep = kind > 0
    # Stable partition order: kept rows first, original order preserved.
    order = jnp.argsort(jnp.where(keep, 0, 1).astype(jnp.int8), axis=1,
                        stable=True)
    sel = order[:, :n_keep].astype(jnp.int32)
    if n_keep > kind.shape[1]:
        sel = jnp.pad(sel, [(0, 0), (0, n_keep - kind.shape[1])])
    total = jnp.sum(keep, axis=1, dtype=jnp.int32)
    pad_mask = (jnp.arange(n_keep, dtype=jnp.int32)[None, :]
                >= jnp.minimum(total, n_keep)[:, None])
    if init_ev is not None:
        sel = jnp.pad(sel, [(0, 0), (1, 0)])  # col 0 overwritten by init
        pad_mask = jnp.pad(pad_mask, [(0, 0), (1, 0)])
        col0 = jnp.arange(n_keep + 1, dtype=jnp.int32)[None, :] == 0
    out = {}
    for f in _ROW_FIELDS:
        a = getattr(stream, f)
        idx = sel.reshape(sel.shape + (1,) * (a.ndim - 2))
        g = jnp.take_along_axis(a, jnp.minimum(idx, a.shape[1] - 1), axis=1)
        m = pad_mask.reshape(pad_mask.shape + (1,) * (a.ndim - 2))
        g = jnp.where(m, jnp.zeros((), a.dtype), g)
        if init_ev is not None:
            iv = getattr(init_ev, f)
            iv = iv.reshape((iv.shape[0], 1) + iv.shape[1:]).astype(a.dtype)
            m0 = col0.reshape(col0.shape + (1,) * (a.ndim - 2))
            g = jnp.where(m0, iv, g)
        out[f] = g
    return Skeleton(**out, n_valid=stream.n_valid)


def compact_stream_rows_with_init(stream: Skeleton, n_keep: int,
                                  init_ev: Event) -> Skeleton:
    """Compacted event rows with the initial record at column 0 (output
    width ``n_keep + 1``); large-``d`` shapes fuse the prepend into the
    compaction gather.  ``n_valid`` is NOT set — callers finish
    with ``_replace(n_valid=1 + min(counts, n_keep))``."""
    if stream.x.shape[-1] >= GATHER_DIM_THRESHOLD:
        return _compact_rows_gather(stream, n_keep, init_ev)
    rows = compact_stream_rows(stream, n_keep)
    return prepend_init_rows(rows, init_ev, jnp.zeros_like(rows.n_valid),
                             n_keep)


def merge_rows_at_offsets(acc: Skeleton, rows: Skeleton, offsets,
                          target: int) -> Skeleton:
    """Merge a fill's compacted event rows into the accumulator at per-chain
    offsets: row ``j`` of chain ``b`` lands at column ``offsets[b] + j``.

    Both inputs are dense per-chain event prefixes (``compact_stream_rows``
    output); ``offsets`` is the per-chain event count already in ``acc``.
    This replaces ``compact_stream_rows(concat_streams(acc, fill), target)``
    — which peaks at ~2x the accumulator size and OOMs the dim-1000 sticky
    config — with a **per-chain uniform log-shift**: because every row of a
    chain moves by the same amount, ``ceil(log2 target)`` dense masked
    shifted-selects (one per offset bit, whole-chain predicates) place the
    fill, then a column mask splices accumulator and shifted fill.  No
    concat, no scatter/gather; peak memory is ~(acc + one fill) instead of
    ~(2 acc + fill).
    """
    off = jnp.asarray(offsets, jnp.int32)
    B = off.shape[0]
    k = rows.t.shape[1]
    if acc.x.shape[-1] >= GATHER_DIM_THRESHOLD:
        return _merge_rows_gather(acc, rows, off, target)
    fields_acc = {f: getattr(acc, f) for f in Skeleton._fields
                  if f != "n_valid"}
    fields_rows = {}
    for f, a_acc in fields_acc.items():
        a = getattr(rows, f)
        if k < target:
            a = jnp.pad(a, [(0, 0), (0, target - k)]
                        + [(0, 0)] * (a.ndim - 2))
        else:
            a = a[:, :target]
        fields_rows[f] = a.astype(a_acc.dtype)
    nbits = max(1, int(max(target - 1, 1)).bit_length())
    for p in range(nbits):
        step = 1 << p
        move = ((off >> p) & 1) == 1  # (B,) whole-chain shift predicate
        for f, a in fields_rows.items():
            pad = [(0, 0)] * a.ndim
            pad[1] = (step, 0)
            shifted = jnp.pad(a, pad)[:, :target]
            m = move.reshape((B,) + (1,) * (a.ndim - 1))
            fields_rows[f] = jnp.where(m, shifted, a)
    col = jnp.arange(target, dtype=jnp.int32)[None, :]
    in_acc = col < off[:, None]
    out = {}
    for f, a in fields_acc.items():
        m = in_acc.reshape(in_acc.shape + (1,) * (a.ndim - 2))
        out[f] = jnp.where(m, a, fields_rows[f])
    return Skeleton(**out, n_valid=acc.n_valid)


def _merge_rows_gather(acc: Skeleton, rows: Skeleton, off,
                       target: int) -> Skeleton:
    """Gather formulation of :func:`merge_rows_at_offsets` (large ``d``):
    column ``c >= off[b]`` reads fill row ``c - off[b]`` with one
    ``take_along_axis`` per field — a single pass over the data instead of
    ``ceil(log2 target)`` shifted-select passes."""
    B = off.shape[0]
    k = rows.t.shape[1]
    col = jnp.arange(target, dtype=jnp.int32)[None, :]
    src = col - off[:, None]                      # (B, target) fill row index
    in_fill = (src >= 0) & (src < k)
    src_safe = jnp.clip(src, 0, k - 1)
    in_acc = col < off[:, None]
    out = {}
    for f in Skeleton._fields:
        if f == "n_valid":
            continue
        a = getattr(acc, f)
        r = getattr(rows, f).astype(a.dtype)
        idx = src_safe.reshape(src_safe.shape + (1,) * (a.ndim - 2))
        g = jnp.take_along_axis(r, idx, axis=1)
        m_fill = in_fill.reshape(in_fill.shape + (1,) * (a.ndim - 2))
        m_acc = in_acc.reshape(in_acc.shape + (1,) * (a.ndim - 2))
        out[f] = jnp.where(
            m_acc, a[:, :target] if a.shape[1] > target else a,
            jnp.where(m_fill, g, jnp.zeros((), a.dtype)),
        )
    return Skeleton(**out, n_valid=acc.n_valid)


def merge_stream_at_offsets(acc: Skeleton, stream: Skeleton, offsets,
                            target: int) -> Skeleton:
    """Merge a RAW fill's event rows into the accumulator at per-chain
    offsets in one pass: event ``j`` of chain ``b`` lands at column
    ``offsets[b] + j``.

    At large ``d`` this composes the compaction permutation with the
    offset shift into a single row gather (indices are computed on the
    tiny ``(B, T)`` kind array), halving the data movement of
    ``merge_rows_at_offsets(acc, compact_stream_rows(fill), ...)``; at
    small ``d`` it falls back to exactly that two-step (whose log-shift
    passes are cheap there)."""
    off = jnp.asarray(offsets, jnp.int32)
    if acc.x.shape[-1] < GATHER_DIM_THRESHOLD:
        k = min(stream.kind.shape[1], target)
        return merge_rows_at_offsets(
            acc, compact_stream_rows(stream, k), off, target
        )
    kind = stream.kind
    B, T = kind.shape
    keep = kind > 0
    order = jnp.argsort(jnp.where(keep, 0, 1).astype(jnp.int8), axis=1,
                        stable=True)
    total = jnp.sum(keep, axis=1, dtype=jnp.int32)
    col = jnp.arange(target, dtype=jnp.int32)[None, :]
    src = col - off[:, None]                   # fill-event ordinal at col c
    in_fill = (src >= 0) & (src < total[:, None])
    src_safe = jnp.clip(src, 0, T - 1)
    sel = jnp.take_along_axis(order, src_safe, axis=1).astype(jnp.int32)
    in_acc = col < off[:, None]
    out = {}
    for f in Skeleton._fields:
        if f == "n_valid":
            continue
        a = getattr(acc, f)
        r = getattr(stream, f).astype(a.dtype)
        idx = sel.reshape(sel.shape + (1,) * (a.ndim - 2))
        g = jnp.take_along_axis(r, idx, axis=1)
        m_fill = in_fill.reshape(in_fill.shape + (1,) * (a.ndim - 2))
        m_acc = in_acc.reshape(in_acc.shape + (1,) * (a.ndim - 2))
        out[f] = jnp.where(
            m_acc, a[:, :target] if a.shape[1] > target else a,
            jnp.where(m_fill, g, jnp.zeros((), a.dtype)),
        )
    return Skeleton(**out, n_valid=acc.n_valid)


def concat_streams(a: Skeleton, b: Skeleton) -> Skeleton:
    """Concatenate two streams along the row axis (device-side)."""
    fields = {
        f: jnp.concatenate(
            [getattr(a, f), getattr(b, f).astype(getattr(a, f).dtype)], axis=1
        )
        for f in Skeleton._fields
        if f != "n_valid"
    }
    return Skeleton(**fields, n_valid=a.n_valid)


def compact_stream_device(stream: Skeleton, init_ev: Event, counts,
                          n_keep: int) -> Skeleton:
    """Device-side event compaction: stable-partition each chain's stream so
    event rows (``kind > 0``) come first in time order, keep the first
    ``n_keep``, and prepend the initial-state record.

    Returns a dense ``(B, n_keep + 1, ...)`` Skeleton that never leaves the
    device — the fast path replacing ``compact_stream_host`` (which pulls
    the full raw stream to the host and assembles per chain in Python,
    dominating wall-clock at large B).
    """
    rows = compact_stream_rows(stream, n_keep)
    return prepend_init_rows(rows, init_ev, counts, n_keep)


def prepend_init_rows(rows: Skeleton, init_ev: Event, counts,
                      n_keep: int) -> Skeleton:
    """Prepend the batched initial-state record to compacted event rows and
    set per-chain validity (initial record + events)."""

    def pre(buf, init):
        return jnp.concatenate([init[:, None].astype(buf.dtype), buf], axis=1)

    return Skeleton(
        x=pre(rows.x, init_ev.x),
        v=pre(rows.v, init_ev.v),
        t=pre(rows.t, init_ev.t),
        horizon=pre(rows.horizon, init_ev.horizon),
        ar=pre(rows.ar, init_ev.ar),
        is_active=pre(rows.is_active, init_ev.is_active),
        rejected=pre(rows.rejected, init_ev.rejected),
        errored_bound=pre(rows.errored_bound, init_ev.errored_bound),
        hitting_horizon=pre(rows.hitting_horizon, init_ev.hitting_horizon),
        error_value_ar=pre(rows.error_value_ar, init_ev.error_value_ar),
        kind=pre(rows.kind, init_ev.kind),
        n_valid=1 + jnp.minimum(counts, n_keep).astype(jnp.int32),
    )


def finalize_horizon_rows(flow, rows: Skeleton, init_ev: Event, counts,
                          T, out_width: int | None = None) -> Skeleton:
    """Assemble the time-horizon skeleton entirely on device: prepend the
    initial record, drop overshoot rows (``t > T``), synthesize the exact
    ``t = T`` terminal point with one batched flow, and zero the tail —
    ``sample.jl:384-420`` semantics with no host round-trip (the host-side
    assembler pays a full-skeleton device->host transfer, which dominates
    wall-clock at large ``B``).

    ``rows``: ``(B, W)`` dense per-chain event prefixes; ``counts``: events
    per chain.  Returns a ``(B, W + 2)`` skeleton (one column for the init
    record, one for the terminal point) with per-chain ``n_valid`` — or
    ``(B, out_width)`` when given, fusing the final trim into the same
    program (the caller derives a safe ``out_width >= max(n_valid)`` from
    host-side fill counts, avoiding both a separate trim dispatch and an
    ``n_valid`` fetch round trip).
    """
    skel = prepend_init_rows(rows, init_ev, counts, rows.t.shape[1])
    t = skel.t
    B, W1 = t.shape
    Tv = jnp.asarray(T, t.dtype)
    col = jnp.arange(W1, dtype=jnp.int32)[None, :]
    valid = col < skel.n_valid[:, None]
    keep = valid & (t <= Tv)
    kcount = jnp.sum(keep, axis=1).astype(jnp.int32)  # prefix (t monotone)
    last = kcount - 1  # >= 0: the init record has t = 0 <= T

    def take_last(a):
        idx = last.reshape((B, 1) + (1,) * (a.ndim - 2))
        return jnp.take_along_axis(a, idx, axis=1)[:, 0]

    x_l = take_last(skel.x)
    act_l = take_last(skel.is_active)
    v_l = jnp.where(act_l, take_last(skel.v), 0.0).astype(x_l.dtype)
    t_l = take_last(t)
    h_l = take_last(skel.horizon)
    xT, vT = jax.vmap(flow)(x_l, v_l, (Tv - t_l).astype(x_l.dtype))

    term = dict(
        x=xT, v=vT,
        t=jnp.full((B,), Tv, t.dtype),
        horizon=h_l,
        ar=jnp.zeros((B,), skel.ar.dtype),
        is_active=act_l,
        rejected=jnp.zeros((B,), jnp.int32),
        errored_bound=jnp.zeros((B,), jnp.int32),
        hitting_horizon=jnp.zeros((B,), jnp.int32),
        error_value_ar=jnp.zeros((B, ERROR_RING_SIZE),
                                 skel.error_value_ar.dtype),
        kind=jnp.full((B,), EV_TERMINAL, jnp.int32),
    )
    has_term = bool(float(T) > 0.0)  # static: T is a host scalar
    n_valid = kcount + (1 if has_term else 0)
    Wo = W1 + 1 if out_width is None else int(out_width)
    col2 = jnp.arange(Wo, dtype=jnp.int32)[None, :]
    is_term = (col2 == kcount[:, None]) if has_term else jnp.zeros(
        (B, Wo), bool
    )
    tail = col2 >= n_valid[:, None]
    out = {}
    for f in Skeleton._fields:
        if f == "n_valid":
            continue
        a = getattr(skel, f)
        if Wo > W1:
            a = jnp.pad(a, [(0, 0), (0, Wo - W1)] + [(0, 0)] * (a.ndim - 2))
        elif Wo < W1:
            a = a[:, :Wo]
        tv = term[f]
        tv = tv.reshape((B, 1) + tv.shape[1:]).astype(a.dtype)
        m_t = is_term.reshape(is_term.shape + (1,) * (a.ndim - 2))
        m_z = tail.reshape(tail.shape + (1,) * (a.ndim - 2))
        a = jnp.where(m_t, tv, a)
        out[f] = jnp.where(m_z, jnp.zeros((), a.dtype), a)
    return Skeleton(**out, n_valid=n_valid)


def grow_rows(rows: Skeleton, extra: int) -> Skeleton:
    """Widen per-chain row buffers by ``extra`` zero columns (accumulator
    growth between stream fills — the fixed-shape analogue of the
    reference's history doubling, ``Composites.jl:172-191``)."""
    fields = {}
    for f in Skeleton._fields:
        if f == "n_valid":
            continue
        a = getattr(rows, f)
        fields[f] = jnp.pad(a, [(0, 0), (0, extra)]
                            + [(0, 0)] * (a.ndim - 2))
    return Skeleton(**fields, n_valid=rows.n_valid)


def compact_stream_host(stream: Skeleton, counts, n_keep=None):
    """Extract the event-only skeleton view from a host-fetched stream.

    Returns a list of per-chain dicts of numpy arrays (event rows only, in
    order).  ``counts`` bounds events per chain; rows beyond ``n_valid`` are
    unwritten padding.
    """
    import numpy as np

    # One transfer for the whole pytree — np.asarray per chain per field
    # would re-fetch the buffers thousands of times.
    host = jax.device_get(stream)
    fields = [f for f in Skeleton._fields if f != "n_valid"]
    arrays = {f: np.asarray(getattr(host, f)) for f in fields}
    kind = arrays["kind"]
    n_valid = np.asarray(host.n_valid)
    out = []
    for b in range(kind.shape[0]):
        rows = np.nonzero(kind[b, : n_valid[b]] > 0)[0]
        if n_keep is not None:
            rows = rows[: int(n_keep)]
        out.append({f: arrays[f][b, rows] for f in fields})
    return out


def make_fixed_event_runner(sampler, n_events: int, max_transitions: int,
                            chunk: int = DEFAULT_CHUNK):
    """Runner collecting exactly ``n_events`` skeleton points per chain
    (including the initial state) — the analogue of
    ``sample_skeleton(sampler, n_sk, ...)`` (``sample.jl:253-284``).
    ``max_transitions`` bounds the loop for XLA; overflow is reported via
    ``RunResult.skeleton.n_valid < n_events`` (SURVEY.md §7 hard part 2).
    """
    live = lambda state, counts: counts < n_events
    return _make_chunk_runner(sampler, n_events, max_transitions, chunk, live)


def make_horizon_runner(sampler, capacity: int, max_transitions: int,
                        chunk: int = DEFAULT_CHUNK):
    """Runner for time-horizon sampling: each chain advances until its event
    clock passes ``T`` (the overshoot event is recorded; the exact ``t = T``
    terminal point is synthesized by the driver) — the engine analogue of
    ``sample_skeleton(sampler, T, ...)`` (``sample.jl:323-439``)."""

    def make(T):
        live = lambda state, counts: (state.t < T) & (counts < capacity)
        return _make_chunk_runner(sampler, capacity, max_transitions, chunk, live)

    def run(state: PDMPState, skel: Skeleton, T) -> RunResult:
        return make(T)(state, skel)

    return run
