"""Sharded chain-batch drivers: ``shard_map`` over a ``chains`` mesh axis.

Design (SURVEY.md §5 "Distributed communication backend"):

* chain simulation itself needs **zero communication** — each device runs an
  *independent* jit-compiled transition-stream ``while_loop`` over its local
  chain shard (``shard_map`` keeps the loop condition local, so no per-
  iteration cross-device all-reduce, unlike a GSPMD-partitioned global loop);
* the per-device fill is the SAME scatter-free stream engine as the
  single-device stream recorder, so one sharded device runs at the
  unsharded rate;
* event compaction / offset merges / horizon finalize are per-chain batch
  ops, also run under ``shard_map`` with everything chain-sharded (they stay
  collective-free by construction);
* cross-chain diagnostics (acceptance rates, rejection/error totals) are
  computed by plain jitted reductions over the chain-sharded skeleton — XLA's
  SPMD partitioner inserts the ``psum`` collectives;
* for very large state dimension there is a GSPMD path
  (``sample_skeleton_gspmd``) that additionally shards the ``dim`` axis of
  ``x``/``v`` and lets XLA insert the collectives for the rate dot products.

Both reference entry points scale: ``sample_skeleton_sharded`` accepts an
``int`` (fixed event count, ``sample.jl:253-284``) or a ``float`` (time
horizon with exact ``t = T`` terminal rows, ``sample.jl:323-439``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..core import capability, engine
from ..core.types import EV_INIT, PDMPState, Skeleton, empty_skeleton
from . import mesh as mesh_lib


_CHUNK = 64  # transitions per stream-runner scan chunk


class ShardedRun(NamedTuple):
    state: PDMPState          # (B, ...) chain-sharded final states
    skeleton: Skeleton        # (B, N, ...) chain-sharded event buffers
    transitions: jax.Array    # (n_shards,) per-device transition counts
    stats: dict               # globally reduced diagnostics (host scalars)


def _shmap_chains(fn, mesh, n_args: int):
    """shard_map ``fn`` with every input/output chain-sharded on axis 0
    (``P('chains')`` prefix specs broadcast over each argument's pytree)."""
    spec = P(mesh_lib.CHAIN_AXIS)
    return jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_args, out_specs=spec,
        check_vma=False,
    )


def _make_fill(sampler, t_cap, target, mode, B_local, d, dtype):
    """Per-shard fill body: allocate a fresh local stream and run the stream
    engine until the local chains hit the target (or the stream fills).
    Returns ``(state, stream, counts, transitions(1,))`` — all shard-local.
    """
    xrun = engine.make_stream_runner(sampler, t_cap, chunk=_CHUNK, mode=mode)

    def fill(state, counts, tt):
        stream = engine.empty_stream(t_cap, d, dtype, B_local)
        tgt = tt if mode == "horizon" else target
        res = xrun(state, stream, counts, tgt)
        return (res.state, res.stream, res.counts,
                jnp.reshape(res.transitions, (1,)))

    return fill


def _prep_sharded(sampler, xinit, vinit, mesh, seed, dtype):
    xinit = np.asarray(xinit, float)
    vinit = np.asarray(vinit, float)
    B, d = xinit.shape
    n_shards = mesh.shape[mesh_lib.CHAIN_AXIS]
    if B % n_shards != 0:
        raise ValueError(
            f"chain batch {B} must be divisible by the {n_shards}-device "
            f"'chains' mesh axis"
        )
    state = sampler.init_state_batch(xinit, vinit, seed, dtype)
    state = jax.device_put(state, mesh_lib.state_shardings(mesh))
    counts = jax.device_put(
        jnp.zeros((B,), jnp.int32),
        jax.sharding.NamedSharding(mesh, P(mesh_lib.CHAIN_AXIS)),
    )
    init_ev = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(state)
    return state, counts, init_ev, B, d, n_shards


@jax.jit
def _skel_reduce(s: Skeleton):
    valid = (jnp.arange(s.t.shape[1])[None, :] < s.n_valid[:, None])
    return {
        "events": jnp.sum(s.n_valid),
        "ar_sum": jnp.sum(jnp.where(valid, s.ar, 0.0)),
        "rejected": jnp.sum(jnp.where(valid, s.rejected, 0)),
        "errored_bound": jnp.sum(jnp.where(valid, s.errored_bound, 0)),
        "hitting_horizon": jnp.sum(jnp.where(valid, s.hitting_horizon, 0)),
    }


def _skeleton_stats(skel: Skeleton) -> dict:
    """Globally reduced diagnostics from a chain-sharded skeleton (XLA SPMD
    inserts the cross-device reductions; one fused host fetch).  The reduce
    is a module-level jit: a per-call ``jax.jit(...)`` would recompile on
    every invocation."""
    stats = {k: np.asarray(v)
             for k, v in jax.device_get(_skel_reduce(skel)).items()}
    stats["mean_ar"] = float(
        stats["ar_sum"] / np.maximum(stats["events"], 1)
    )
    return stats


def sample_skeleton_sharded(
    sampler,
    n_or_T,
    xinit,
    vinit,
    *,
    mesh=None,
    seed=None,
    dtype=None,
    max_transitions_per_event: int = 256,
    init_capacity: int = 1024,
    verbose: bool = False,
    checkpoint_path=None,
    checkpoint_every: int = 4,
) -> ShardedRun:
    """Generate skeletons for a chain batch sharded over a device mesh,
    running the full-speed stream engine independently on every device.

    ``n_or_T``: an ``int`` asks for that many skeleton points per chain
    (including the initial record, like the reference's ``n_sk``); a
    ``float`` asks for a time horizon with exact ``t = T`` terminal rows.
    ``xinit``/``vinit`` are ``(B, d)`` with ``B`` divisible by the number of
    devices on the ``chains`` mesh axis.

    ``checkpoint_path`` (event-count mode): atomically save engine state +
    accumulator every ``checkpoint_every`` fills and RESUME bit-exactly
    from an existing file, exactly like the single-device driver
    (``api.sample_skeleton``); the loaded state is resharded onto the mesh
    by the fill's ``shard_map`` in-specs.
    """
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    ck = ((checkpoint_path, max(1, int(checkpoint_every)))
          if checkpoint_path else None)
    if isinstance(n_or_T, (int, np.integer)) and not isinstance(n_or_T, bool):
        return _sharded_events(
            sampler, int(n_or_T), xinit, vinit, mesh, seed, dtype,
            max_transitions_per_event, verbose, ck,
        )
    if ck is not None:
        import warnings

        warnings.warn(
            "checkpoint_path on sample_skeleton_sharded is only supported "
            "in event-count mode; ignoring it for the time-horizon run."
        )
    return _sharded_horizon(
        sampler, float(n_or_T), xinit, vinit, mesh, seed, dtype,
        max_transitions_per_event, init_capacity, verbose,
    )


def _sharded_events(
    sampler, n_events, xinit, vinit, mesh, seed, dtype, max_per_event,
    verbose, ck=None,
) -> ShardedRun:
    if n_events <= 0:
        raise ValueError(f"n_sk must be positive. Current value: {n_events}")
    state, counts, init_ev, B, d, n_shards = _prep_sharded(
        sampler, xinit, vinit, mesh, seed, dtype
    )
    B_local = B // n_shards
    target = n_events - 1
    cdtype = state.x.dtype

    chunk = _CHUNK
    # One fill sized for the whole run when it fits the per-device budget
    # (the budget math of api._sample_skeleton_events_stream with the
    # device-local batch); longer skeletons loop fills in bounded memory.
    from ..api import _device_bytes_budget

    itemsize = jnp.dtype(cdtype).itemsize
    row_bytes = (2 * d + 20) * itemsize + d
    budget_rows = int(
        (_device_bytes_budget() / max(B_local * row_bytes, 1) - (target + 1))
        / 2
    )
    # adaptive transition margin (see api._sample_skeleton_events_stream):
    # completed runs record events-per-transition; later fills shrink from
    # the cold 1.8x margin to ~1.15x what the config actually needs
    ratio = (getattr(sampler, "_fill_ratio", None)
             if capability.resolve().adaptive_fill else None)
    # 1.08x the measured mean transition need: the slowest chain's
    # count concentrates within ~5% of the mean at large B, the
    # 256-row alignment adds slack on top, and a rare straggler
    # falls into the merge path instead of failing — while the
    # compaction pass is linear in the fill width, so every spare
    # 256-row bucket costs ~2% of the flagship's wall time
    margin = 1.8 if not ratio else min(1.8, max(1.08, 1.08 / ratio))
    align = 256 if target >= 256 else chunk  # bound distinct geometries
    align = max(align, chunk)
    t_cap = max(chunk,
                -(-int(max(target, 1) * margin + 64) // align) * align)
    t_cap = min(t_cap, max(chunk, budget_rows // chunk * chunk))

    cache_key = ("sharded_stream_fill", t_cap, target, id(mesh))

    def factory():
        fill = _make_fill(sampler, t_cap, target, "events", B_local, d, cdtype)
        spec = P(mesh_lib.CHAIN_AXIS)
        shm = jax.shard_map(
            fill, mesh=mesh,
            in_specs=(spec, spec, P()),
            out_specs=(spec, spec, spec, spec),
            check_vma=False,
        )
        # No state donation: init_ev aliases the initial state's buffers
        # (event_from_state repacks leaves; vmap of a repack is an identity).
        return jax.jit(shm)

    run_fill = sampler._cached(cache_key, factory)

    compact = sampler._cached(
        ("sharded_compact_init", target, id(mesh)),
        lambda: jax.jit(
            _shmap_chains(
                lambda s, iv: engine.compact_stream_rows_with_init(
                    s, target, iv
                ),
                mesh, 2,
            ),
            donate_argnums=(0,),
        ),
    )
    merge = sampler._cached(
        ("sharded_merge", target + 1, id(mesh)),
        lambda: jax.jit(
            _shmap_chains(
                lambda a, s, off: engine.merge_stream_at_offsets(
                    a, s, off, target + 1
                ),
                mesh, 3,
            ),
            donate_argnums=(0,),
        ),
    )

    tt0 = jnp.zeros((), cdtype)
    acc = None
    transitions = np.zeros(n_shards, np.int64)
    fills_done = 0
    if ck is not None:
        from ..api import _load_stream_checkpoint

        loaded = _load_stream_checkpoint(ck[0], "sharded_events", target)
        if loaded is not None:
            state, acc, counts_np, fills_done = loaded
            counts = jnp.asarray(counts_np, jnp.int32)
            acc = acc._replace(n_valid=counts)
    max_fills = max(1, (int(target) * int(max_per_event)) // t_cap + 1)
    exhausted = True
    for fill in range(fills_done, max_fills):
        prev_counts = counts
        state, stream, counts, tr = run_fill(state, counts, tt0)
        if acc is None:
            acc = compact(stream, init_ev)
        else:
            acc = merge(acc, stream, 1 + prev_counts)
        counts_host, tr_host = jax.device_get((counts, tr))
        transitions += np.asarray(tr_host, np.int64)
        done = np.asarray(counts_host) >= target
        if ck is not None and (fill + 1) % ck[1] == 0 and not done.all():
            from ..api import _save_stream_checkpoint

            _save_stream_checkpoint(
                ck[0], "sharded_events", target, state, acc,
                np.asarray(counts_host), fill + 1,
            )
        from ..api import _fail_after_fills

        _fail_after_fills(fill + 1)
        if verbose:
            c = np.asarray(counts_host)
            print(
                f"[sample_skeleton_sharded] events {int(c.min())}/{target} "
                f"(chains done: {int(done.sum())}/{B})"
            )
        if done.all():
            exhausted = False
            from ..api import _update_fill_ratio

            _update_fill_ratio(sampler, target, transitions.max())
            break
        if int(np.asarray(tr_host).sum()) == 0:
            exhausted = False
            break
    if exhausted:
        import warnings

        warnings.warn(
            f"transition budget exhausted after {max_fills} stream fills; "
            "results contain fewer events than requested."
        )
    skel = acc._replace(
        n_valid=(1 + jnp.minimum(counts, target)).astype(jnp.int32)
    )
    return ShardedRun(state, skel, jnp.asarray(transitions),
                      _skeleton_stats(skel))


def _sharded_horizon(
    sampler, T, xinit, vinit, mesh, seed, dtype, max_per_event,
    init_capacity, verbose,
) -> ShardedRun:
    import math

    if not math.isfinite(T) or T < 0:
        raise ValueError(f"T must be finite and non-negative. Current value: {T}")
    state, counts, init_ev, B, d, n_shards = _prep_sharded(
        sampler, xinit, vinit, mesh, seed, dtype
    )
    B_local = B // n_shards
    cdtype = state.x.dtype

    chunk = _CHUNK
    t_cap = max(chunk, -(-int(init_capacity) // chunk) * chunk)

    cache_key = ("sharded_stream_fill_T", t_cap, id(mesh))

    def factory():
        fill = _make_fill(sampler, t_cap, t_cap, "horizon", B_local, d, cdtype)
        spec = P(mesh_lib.CHAIN_AXIS)
        shm = jax.shard_map(
            fill, mesh=mesh,
            in_specs=(spec, spec, P()),
            out_specs=(spec, spec, spec, spec),
            check_vma=False,
        )
        return jax.jit(shm)

    run_fill = sampler._cached(cache_key, factory)

    def compact_w(k):
        return sampler._cached(
            ("sharded_compact", k, id(mesh)),
            lambda: jax.jit(
                _shmap_chains(
                    lambda s: engine.compact_stream_rows(s, k), mesh, 1
                ),
            ),
        )

    def merge_w(w):
        return sampler._cached(
            ("sharded_merge_raw", w, id(mesh)),
            lambda: jax.jit(
                _shmap_chains(
                    lambda a, s, off: engine.merge_stream_at_offsets(
                        a, s, off, w
                    ),
                    mesh, 3,
                ),
                donate_argnums=(0,),
            ),
        )

    dev_rows = None
    total_dev = jax.device_put(
        jnp.zeros((B,), jnp.int32),
        jax.sharding.NamedSharding(mesh, P(mesh_lib.CHAIN_AXIS)),
    )
    total_counts = np.zeros(B, np.int64)
    transitions = np.zeros(n_shards, np.int64)
    tt = jnp.asarray(T, cdtype)

    if T > 0.0:
        while True:
            counts0 = jax.device_put(
                jnp.zeros((B,), jnp.int32),
                jax.sharding.NamedSharding(mesh, P(mesh_lib.CHAIN_AXIS)),
            )
            state, stream, counts_f, tr = run_fill(state, counts0, tt)
            counts_host, t_host, tr_host = jax.device_get(
                (counts_f, state.t, tr)
            )
            counts_fill = np.asarray(counts_host, np.int64)
            if dev_rows is None:
                dev_rows = compact_w(t_cap)(stream)
            else:
                w_need = int((total_counts + counts_fill).max())
                w_have = dev_rows.t.shape[1]
                if w_need > w_have:
                    dev_rows = engine.grow_rows(
                        dev_rows, max(t_cap, w_need - w_have)
                    )
                    w_have = dev_rows.t.shape[1]
                dev_rows = merge_w(w_have)(dev_rows, stream, total_dev)
            total_dev = total_dev + counts_f
            total_counts += counts_fill
            transitions += np.asarray(tr_host, np.int64)
            t_now = np.asarray(t_host)
            done = t_now >= T
            if verbose:
                print(
                    f"[sample_skeleton_sharded] t={t_now.min():.4g}/{T} "
                    f"(chains done: {int(done.sum())}/{B})"
                )
            if bool(done.all()):
                break
            if int(np.asarray(tr_host).sum()) == 0:
                raise RuntimeError("time-horizon sampling made no progress")

    if dev_rows is None:  # T == 0: the skeleton is just the initial record
        rows = empty_skeleton(1, d, cdtype, batch_shape=(B,))
        skel = engine.prepend_init_rows(
            rows, init_ev, jnp.zeros((B,), jnp.int32), 1
        )
        return ShardedRun(state, skel, jnp.asarray(transitions),
                          _skeleton_stats(skel))

    W = dev_rows.t.shape[1]
    out_w = min(
        W + 2, -(-(2 + max(1, int(total_counts.max()))) // 256) * 256
    )
    finalize = sampler._cached(
        ("sharded_finalize", W, out_w, float(T), id(mesh)),
        lambda: jax.jit(
            _shmap_chains(
                lambda rows, init, cnt: engine.finalize_horizon_rows(
                    sampler.flow, rows, init, cnt, T, out_width=out_w
                ),
                mesh, 3,
            ),
            donate_argnums=(0,),
        ),
    )
    skel = finalize(dev_rows, init_ev, total_dev)
    return ShardedRun(state, skel, jnp.asarray(transitions),
                      _skeleton_stats(skel))


def sample_skeleton_gspmd(
    sampler,
    n_events: int,
    xinit,
    vinit,
    *,
    mesh=None,
    seed=None,
    dtype=None,
    max_transitions_per_event: int = 256,
):
    """GSPMD path: chains *and* state dimension sharded; XLA's partitioner
    inserts the collectives for dot products over the sharded ``dim`` axis.
    Use for very large ``dim`` (tensor-parallel analogue; SURVEY.md §2
    parallelism table).  Runs the scatter engine: a dim-sharded program has
    per-transition cross-device reductions anyway, so the stream engine's
    scatter-free advantage is not the bottleneck here."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    xinit = np.asarray(xinit, float)
    vinit = np.asarray(vinit, float)
    B, d = xinit.shape

    state = sampler.init_state_batch(xinit, vinit, seed, dtype)
    skel = empty_skeleton(n_events, d, state.x.dtype, batch_shape=(B,))
    skel = engine.record_initial(skel, state, EV_INIT)

    st_sh = mesh_lib.state_shardings(mesh, shard_dim=True)
    sk_sh = mesh_lib.skeleton_shardings(mesh, shard_dim=True)
    state = jax.device_put(state, st_sh)
    skel = jax.device_put(skel, sk_sh)

    max_tr = int(n_events) * int(max_transitions_per_event)
    cache_key = ("gspmd_fixed", n_events, max_tr, id(mesh))

    def factory():
        run = engine.make_fixed_event_runner(sampler, n_events, max_tr)
        return jax.jit(
            run, donate_argnums=(0, 1), out_shardings=engine.RunResult(
                st_sh, sk_sh, jax.sharding.NamedSharding(mesh, P())
            ),
        )

    run = sampler._cached(cache_key, factory)
    return run(state, skel)


def sample_from_skeleton_batch(sampler, n_per_chain: int, skeleton: Skeleton,
                               *, discard_vt: bool = True):
    """Batched skeleton -> samples: ``n_per_chain`` equal-time samples per
    chain from a padded chain-batch skeleton; returns ``(B, n, d)``
    positions, or ``(B, n, 2d + 1)`` with velocities and times appended when
    ``discard_vt=False`` (the batch analogue of ``sample_from_skeleton``'s
    output contract, ``sample.jl:475-513``).

    The vectorized counterpart of ``sample_from_skeleton`` for chain batches
    (leading axes stay sharded if the skeleton is)."""
    t = jnp.asarray(skeleton.t)
    X = jnp.asarray(skeleton.x)
    V = jnp.asarray(skeleton.v)
    A = jnp.asarray(skeleton.is_active)
    n_valid = jnp.asarray(skeleton.n_valid)
    B, N = t.shape

    def per_chain(tb, xb, vb, ab, nb):
        t_end = tb[jnp.maximum(nb - 1, 0)]
        # padding slots hold zeros; push them past any query time so the
        # binary search only sees the valid monotone prefix
        tb_eff = jnp.where(jnp.arange(N) < nb, tb, jnp.inf)
        tm = jnp.arange(1, n_per_chain + 1, dtype=tb.dtype) * (
            t_end / n_per_chain
        )
        idx = jnp.clip(jnp.searchsorted(tb_eff, tm, side="right") - 1, 0, nb - 1)

        def one(i, tmj):
            v_used = jnp.where(ab[i], vb[i], 0.0)
            return sampler.flow(xb[i], v_used, tmj - tb[i])

        xs, vs = jax.vmap(one)(idx, tm)
        if discard_vt:
            return xs
        return jnp.concatenate([xs, vs, tm[:, None]], axis=1)

    return jax.vmap(per_chain)(t, X, V, A, n_valid)


def pooled_moments(skeleton: Skeleton, sampler, n_per_chain: int, mesh=None):
    """Cross-chain pooled posterior moments from batched skeletons.

    Interpolates ``n_per_chain`` equal-time samples per chain (vectorized
    ``sample_from_skeleton``) and reduces first/second moments over all
    chains — the collective-aggregated diagnostic the reference cannot do
    (it has no chain batching at all).
    """
    t = jnp.asarray(skeleton.t)
    X = jnp.asarray(skeleton.x)
    V = jnp.asarray(skeleton.v)
    A = jnp.asarray(skeleton.is_active)
    n_valid = jnp.asarray(skeleton.n_valid)
    B, N = t.shape

    def per_chain(tb, xb, vb, ab, nb):
        t_end = tb[jnp.maximum(nb - 1, 0)]
        tb_eff = jnp.where(jnp.arange(N) < nb, tb, jnp.inf)
        tm = jnp.arange(1, n_per_chain + 1, dtype=tb.dtype) * (t_end / n_per_chain)
        idx = jnp.clip(jnp.searchsorted(tb_eff, tm, side="right") - 1, 0, nb - 1)

        def one(i, tmj):
            v_used = jnp.where(ab[i], vb[i], 0.0)
            xn, _ = sampler.flow(xb[i], v_used, tmj - tb[i])
            return xn

        xs = jax.vmap(one)(idx, tm)
        return jnp.sum(xs, axis=0), jnp.sum(xs * xs, axis=0)

    s1, s2 = jax.vmap(per_chain)(t, X, V, A, n_valid)
    n_tot = B * n_per_chain
    mean = jnp.sum(s1, axis=0) / n_tot
    var = jnp.sum(s2, axis=0) / n_tot - mean**2
    return mean, var
