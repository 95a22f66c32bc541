"""Streaming (bounded-memory) statistics over unbounded PDMP runs.

The materialized pipeline (``sample_skeleton`` -> ``sample_from_skeleton``
-> ``diagnostics.ess_summary``) holds the whole skeleton on device, so the
longest convergence-gated run is one HBM's worth of events.  This module
removes that ceiling: each stream fill is *folded* into O(B * d) running
accumulators on device and then discarded, so run length is unbounded while
ESS, split-R-hat, and posterior moments remain computable at the end.

The design fuses the reference's own online-diagnostic pattern — its online
realized volatility accumulates a statistic *during* time-horizon sampling
instead of from a materialized history (``/root/reference/src/sample.jl:
75-236``) — with the equal-time interpolation of ``sample_from_skeleton``
(``sample.jl:475-513``):

* a fixed equal-time grid ``t_j = (j + 1) T / n_samples`` is chosen up
  front (time-horizon mode, so the grid is known before sampling starts);
* after each fill, the grid points that the fill's trajectory newly covers
  are interpolated ON DEVICE directly from the raw transition stream (the
  stream rows carry trajectory time and are a valid skeleton — see
  ``core/engine.py`` ``make_stream_runner``), flowed from the covering row
  exactly as ``sample_from_skeleton`` would;
* the interpolated samples update running **split-half moment** accumulators
  (count / sum / sum-of-squares per chain half, for split-R-hat and
  posterior moments) and **batch-mean** accumulators (per-window sums, for
  the batch-means ESS estimator), then are dropped.

Estimators (finalized in float64 on the host):

* split-R-hat: Gelman-Rubin potential scale reduction over the 2B
  half-chains, computed from the half sufficient statistics — identical in
  definition to ``diagnostics.split_rhat`` on materialized samples.
* ESS per chain/coordinate via **batch means**: with ``M`` equal
  post-burn-in windows of length ``L`` samples, the asymptotic variance is
  ``sigma2 = L * Var(window means)`` and ``ESS = n * s^2 / sigma2``
  (Geyer's autocorrelation-sum estimator needs the full series; batch means
  is its standard O(M)-memory streaming replacement and agrees to the
  window-count noise floor).  Aggregation matches ``diagnostics.
  ess_summary``: per-coordinate sums over chains, worst coordinate
  reported, gated on split-R-hat.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .core import engine
from .core.types import PDMPState


class StreamingStats(NamedTuple):
    """O(B * d) on-device accumulators (see module docstring)."""

    n_half: jax.Array      # (B, 2)    samples folded per chain half
    sum_half: jax.Array    # (B, 2, d) sum of (x - x_ref) per half
    sumsq_half: jax.Array  # (B, 2, d) sum of (x - x_ref)^2 per half
    bsum: jax.Array        # (B, M, d) sum of (x - x_ref) per ESS window
    bcount: jax.Array      # (B, M)    samples folded per ESS window


def empty_stats(B: int, d: int, n_batches: int, dtype=jnp.float32):
    return StreamingStats(
        n_half=jnp.zeros((B, 2), jnp.int32),
        sum_half=jnp.zeros((B, 2, d), dtype),
        sumsq_half=jnp.zeros((B, 2, d), dtype),
        bsum=jnp.zeros((B, n_batches, d), dtype),
        bcount=jnp.zeros((B, n_batches), jnp.int32),
    )


class StreamingRun(NamedTuple):
    stats: StreamingStats  # final accumulators (device)
    state: PDMPState       # final engine state (continuation, sample.jl:281)
    events: int            # total events committed across all chains
    fills: int             # stream fills executed
    n_samples: int         # grid size the stats were folded over
    n_burnin: int          # leading grid points excluded from the stats
    x_ref: np.ndarray = np.float32(0.0)  # (d,) centering offset the fold
    #                                      subtracted (mean initial position)


def make_fold_chunk(sampler, W: int, G: int, n_samples: int, n_batches: int,
                    n_burnin: int, dt_grid: float, x_ref):
    """Build the jitted fold of one grid chunk into the accumulators.

    Signature: ``fold(stats, stream, anchor, rows_written, j_start, j_hi)
    -> stats`` where ``stream`` is the RAW fill (its rows are a valid
    skeleton, see ``core/engine.py``), ``anchor = (t, x, v, is_active)`` is
    the carried trajectory point covering grid times before the fill's
    first row, ``rows_written`` the written row count (traced scalar; the
    runner's while_loop makes it fill-dependent), and ``j_start/j_hi (B,)``
    the PER-CHAIN half-open grid window this fill newly covers.  Only
    indices in ``[max(j_start, n_burnin), j_hi)`` contribute; the caller
    guarantees ``j_hi <= j_start + G`` (per-chain windows keep the gather
    volume at the points actually produced — a global window must span the
    cross-chain spread too, which forced a second ~25 ms gather pass per
    fill at dim 1000).
    """
    flow = sampler.flow
    n_post = max(n_samples - n_burnin, 1)
    x_ref = jnp.asarray(x_ref)

    def fold(stats: StreamingStats, stream, anchor, rows_written,
             j_start, j_hi):
        at, ax, av, aa = anchor
        dtype = stream.t.dtype
        col = jnp.arange(W, dtype=jnp.int32)[None, :]
        tm = jnp.where(col < rows_written, stream.t,
                       jnp.asarray(jnp.inf, dtype))                # (B, W)

        j = j_start[:, None] + jnp.arange(G, dtype=jnp.int32)[None, :]
        tg = (j + 1).astype(dtype) * jnp.asarray(dt_grid, dtype)   # (B, G)
        live = (j < j_hi[:, None]) & (j >= n_burnin)               # (B, G)

        idx = jax.vmap(
            lambda trow, tgrow: jnp.searchsorted(
                trow, tgrow, side="right") - 1
        )(tm, tg)                                                  # (B, G)
        # idx == -1: the grid time precedes every fill row — covered by the
        # carried anchor instead of a stream row.
        use_anchor = idx < 0
        idxc = jnp.clip(idx, 0, W - 1)

        def take(a, a_anchor):
            ix = idxc.reshape(idxc.shape + (1,) * (a.ndim - 2))
            g = jnp.take_along_axis(a, ix, axis=1)
            m = use_anchor.reshape(use_anchor.shape
                                   + (1,) * (a.ndim - 2))
            return jnp.where(m, a_anchor[:, None], g)

        x_i = take(stream.x, ax)                                   # (B, G, d)
        v_i = take(stream.v, av)
        a_i = take(stream.is_active, aa)
        t_i = jnp.where(use_anchor, at[:, None],
                        jnp.take_along_axis(tm, idxc, axis=1))     # (B, G)
        # clamp: float32 grid/row-time rounding can leave tg a ulp past the
        # covering row's time; masked-out lanes flow by 0 (RHMC's Verlet
        # while_loop must not see garbage times)
        tau = jnp.where(live, jnp.maximum(tg - t_i, 0.0),
                        jnp.zeros((), dtype))
        v_used = jnp.where(a_i, v_i, jnp.zeros_like(v_i))
        xs, _ = jax.vmap(jax.vmap(flow))(x_i, v_used, tau)         # (B, G, d)
        xs = xs - x_ref

        w = live.astype(xs.dtype)                                  # (B, G)
        xm = xs * w[:, :, None]
        x2m = (xs * xs) * w[:, :, None]

        # post-burn-in ordinal of each grid index (clipped; masked-out
        # indices contribute zero weight regardless)
        jp = jnp.clip(j - n_burnin, 0, n_post - 1)                 # (B, G)
        half = jnp.clip(jp * 2 // n_post, 0, 1)
        win = jnp.clip(jp * n_batches // n_post, 0, n_batches - 1)
        oh_h = (half[:, :, None]
                == jnp.arange(2)[None, None, :]).astype(xs.dtype)  # (B,G,2)
        oh_w = (win[:, :, None]
                == jnp.arange(n_batches)[None, None, :]).astype(xs.dtype)

        # HIGHEST: a GPU may otherwise run these f32 contractions on TF32
        # tensor cores (~3 decimal digits), far below the moment accuracy
        # the law checks need.
        def fold_sum(spec, a, b):
            return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST)

        return StreamingStats(
            n_half=stats.n_half
            + fold_sum("bg,bgh->bh", w, oh_h).astype(jnp.int32),
            sum_half=stats.sum_half + fold_sum("bgd,bgh->bhd", xm, oh_h),
            sumsq_half=stats.sumsq_half
            + fold_sum("bgd,bgh->bhd", x2m, oh_h),
            bsum=stats.bsum + fold_sum("bgd,bgm->bmd", xm, oh_w),
            bcount=stats.bcount
            + fold_sum("bg,bgm->bm", w, oh_w).astype(jnp.int32),
        )

    return fold


def _anchor_from_state(state: PDMPState):
    """Interpolation anchor = the state's trajectory point: position ``x``
    at trajectory time ``t + ts`` (``ts`` accounts flow already performed
    past the last committed event — horizon moves), velocity/activity as
    stored.  Valid by the stream-row contract (``core/engine.py``)."""
    return (state.t + state.ts, state.x, state.v, state.is_active)


def _save_streaming_checkpoint(path, state, stats, meta):
    """Atomic checkpoint of a streaming run: engine state + accumulators +
    a manifest (which carries the per-chain grid cursor).  The
    interpolation anchor needs no saving — it is the state's own
    trajectory point, which is what makes a fill boundary a consistent
    cut."""
    from .parallel.checkpoint import _flatten

    arrays = _flatten("state", jax.device_get(state))
    arrays.update(_flatten("stats", jax.device_get(stats)))
    import json

    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _load_streaming_checkpoint(path, expect: dict):
    """Load + validate a streaming checkpoint; returns
    ``(state, stats, meta)`` or None (no file).  A file from a different
    run configuration raises instead of silently sampling the wrong
    thing."""
    if not os.path.exists(path):
        return None
    import json

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        for k, v in expect.items():
            if meta.get(k) != v:
                raise ValueError(
                    f"checkpoint at {path} was written for {k}="
                    f"{meta.get(k)!r}, not this run's {k}={v!r}; delete it "
                    "to start fresh."
                )
        sf = {f: jnp.asarray(z[f"state.{f}"]) for f in PDMPState._fields}
        sf["key"] = jax.random.wrap_key_data(jnp.asarray(z["state.key"]))
        state = PDMPState(**sf)
        stats = StreamingStats(
            *[jnp.asarray(z[f"stats.{f}"]) for f in StreamingStats._fields]
        )
    return state, stats, meta


def sample_streaming_stats(
    sampler,
    T: float,
    xinit,
    vinit,
    *,
    n_samples: int = 4096,
    n_batches: int = 64,
    burnin_frac: float = 0.25,
    seed=None,
    dtype=None,
    t_cap: int | None = None,
    grid_chunk: int = 512,
    verbose: bool = False,
    checkpoint_path=None,
    checkpoint_every: int = 64,
    mesh=None,
    stop_when_converged: bool = False,
    check_every: int = 32,
    min_ess: float = 0.0,
) -> StreamingRun:
    """Run time-horizon sampling to ``t = T`` while folding equal-time
    samples into O(B * d) streaming accumulators; the skeleton is never
    materialized, so run length is bounded by wall-clock, not HBM.

    ``n_samples`` equal-time grid points span ``(0, T]``; the leading
    ``burnin_frac`` fraction is excluded from the statistics (matching the
    benchmark sweep's burn-in discard).  Finalize with
    :func:`streaming_summary`.

    ``checkpoint_path``: atomically save state + accumulators (+ the grid
    cursor) about every ``checkpoint_every`` fills and RESUME bit-exactly
    from an existing file.  Each save fetches the accumulators
    (~``B * n_batches * d`` floats) to the host.

    ``mesh``: run the fill+fold program independently per device under
    ``shard_map`` over the ``chains`` mesh axis (chains, accumulators, and
    grid cursors are all chain-sharded; only the tiny event/flag scalars
    are ``psum``/``pmax``-reduced per dispatch, so aggregate events/s is
    linear in devices by construction, exactly like
    ``sample_skeleton_sharded``).  Per-chain statistics match the
    unsharded run up to summation order (fill boundaries differ).

    ``stop_when_converged``: treat ``T`` as a BUDGET rather than a target —
    every ``check_every`` dispatch groups, finalize the partial
    accumulators and stop as soon as split-R-hat gates (and the
    worst-coordinate pooled ESS reaches ``min_ess``, when given).  The
    batch-means estimator masks the not-yet-filled trailing windows, so
    early summaries stay unbiased; the reference has no analogue (its runs
    are fixed-length only).  Each check fetches the accumulators
    (~``B * n_batches * d`` floats) to the host.
    """
    from .api import (
        _device_bytes_budget,
        _fail_after_fills,
        _prep_init,
    )
    from .core import capability

    if not (isinstance(T, (int, float)) and math.isfinite(T) and T > 0):
        raise ValueError(f"T must be finite and positive. Current value: {T}")
    T = float(T)
    if n_samples < n_batches * 2:
        raise ValueError(
            f"n_samples={n_samples} must be at least 2 * n_batches="
            f"{2 * n_batches} for the batch-means ESS estimator"
        )
    x, v, _squeeze = _prep_init(sampler, xinit, vinit)
    B, d = x.shape
    n_shards = 1
    if mesh is not None:
        from .parallel import mesh as mesh_lib

        n_shards = mesh.shape[mesh_lib.CHAIN_AXIS]
        if B % n_shards != 0:
            raise ValueError(
                f"chain batch {B} must be divisible by the {n_shards}-"
                f"device 'chains' mesh axis"
            )
    B_local = B // n_shards
    n_burnin = int(burnin_frac * n_samples)
    dt_grid = T / n_samples
    x_ref = np.asarray(x.mean(axis=0), np.float32)

    # Fill geometry: bounded by the device budget.  Peak live buffers
    # inside the fused program: the fill's stream (updated in place) +
    # fold gather temporaries + XLA slack — ~3 stream-sized allocations.
    # Bigger fills amortize each fill's fixed launch overhead; 8192 rows
    # caps the compile size.
    itemsize = jnp.asarray(np.float64(0.0), dtype).dtype.itemsize
    row_bytes = (2 * d + 20) * itemsize + d
    if t_cap is None:
        # per-DEVICE budget: each shard holds only its local stream
        budget_rows = int(
            _device_bytes_budget() / max(B_local * row_bytes, 1) / 3)
        t_cap = max(256, min(8192, budget_rows // 256 * 256))
    G = int(grid_chunk)

    Tv = jnp.asarray(T, jnp.float32)
    path = capability.resolve()

    def build_program():
        """ONE jitted program per dispatch: ``K`` stream fills, each with
        device-side grid bookkeeping and the per-chain fold, with every
        carried buffer donated, so the host waits on the device once per
        ``K`` fills instead of several times per fill.  The anchor needs no
        carry: inside the program it IS the input state's trajectory point;
        the grid cursor ``j_done`` rides as a device array.
        """
        core = engine.make_stream_runner(
            sampler, t_cap, chunk=64, mode="horizon"
        )
        fold_fn = make_fold_chunk(
            sampler, t_cap, G, n_samples, n_batches, n_burnin, dt_grid,
            x_ref,
        )

        def program(carry, _=None):
            state, stats, j_done, ev_total, flags = carry
            anchor = _anchor_from_state(state)
            # batch from the traced state (the device-LOCAL batch under
            # shard_map), not the closure
            stream = engine.empty_stream(
                t_cap, d, state.x.dtype, state.x.shape[0])
            j0 = jnp.min(j_done)
            # Cap this fill's clock target so every chain's grid advance
            # stays inside its own fold window [j_done_c, j_done_c + G): a
            # chain halts once its committed clock passes the scalar cap
            # (j0 + G - slack grid points), so j_hi_c <= j0 + G - slack <=
            # j_done_c + G by construction; the slack absorbs the
            # sub-one-transition overshoot of the halt check.  When the
            # grid is sparse relative to a fill (the production case) the
            # cap never binds and fills run full-size.
            cap_pts = (j0 + G - max(1, G // 4)).astype(jnp.float32)
            tt_eff = jnp.minimum(Tv, cap_pts * jnp.asarray(
                dt_grid, jnp.float32))
            res = core(state, stream,
                       jnp.zeros((state.x.shape[0],), jnp.int32), tt_eff)
            ns = res.state
            traj = ns.t + ns.ts
            done = ns.t >= Tv.astype(ns.t.dtype)
            j_hi = jnp.minimum(
                jnp.floor(traj / jnp.asarray(dt_grid, traj.dtype)).astype(
                    jnp.int32),
                n_samples,
            )
            j_hi = jnp.where(done, n_samples, j_hi)
            j_hi = jnp.maximum(j_hi, j_done)
            stats = fold_fn(stats, res.stream, anchor, res.transitions,
                            j_done, j_hi)
            covered = j_done + G
            overflow = jnp.any(j_hi > covered)
            j_new = jnp.minimum(j_hi, covered)
            all_done = jnp.all(done)
            advanced = jnp.any(j_new > j_done)
            stalled = (res.transitions == 0) & ~all_done & ~advanced
            flags = flags | jnp.stack(
                [overflow, stalled]).astype(jnp.int32)
            ev_total = ev_total + jnp.sum(res.counts).astype(ev_total.dtype)
            return (ns, stats, j_new, ev_total, flags), None

        def meta(*carry):
            # K fills per dispatch: the host pays its dispatch and metadata
            # fetch once per K fills
            out, _ = jax.lax.scan(program, carry, None, length=K)
            return out

        if mesh is None:
            return jax.jit(meta, donate_argnums=(0, 1, 2, 3, 4))

        from jax.sharding import PartitionSpec as P

        from .parallel import mesh as mesh_lib

        axis = mesh_lib.CHAIN_AXIS
        chain = P(axis)

        def meta_sharded(*carry):
            ns, stats, j_new, ev, flags = meta(*carry)
            # the only cross-device values are the tiny progress scalars
            ev = jax.lax.psum(ev, axis)
            flags = jax.lax.pmax(flags, axis)
            return ns, stats, j_new, ev, flags

        sm = jax.shard_map(
            meta_sharded, mesh=mesh,
            in_specs=(chain, chain, chain, P(), P()),
            out_specs=(chain, chain, chain, P(), P()),
            check_vma=False,
        )
        return jax.jit(sm, donate_argnums=(0, 1, 2, 3, 4))

    state = sampler.init_state_batch(x, v, seed, dtype)
    stats = empty_stats(B, d, n_batches, state.x.dtype)
    j_done = jnp.zeros((B,), jnp.int32)
    events = 0
    fills = 0
    ck_meta = {"T": float(T), "n_samples": int(n_samples),
               "n_batches": int(n_batches), "n_burnin": int(n_burnin)}
    if checkpoint_path:
        loaded = _load_streaming_checkpoint(checkpoint_path, ck_meta)
        if loaded is not None:
            state, stats, meta = loaded
            events, fills = int(meta["events"]), int(meta["fills"])
            j_done = jnp.asarray(np.asarray(meta["cursor"]), jnp.int32)

    K = path.fills_per_dispatch
    if checkpoint_path:
        K = min(K, max(1, int(checkpoint_every)))

    run_program = sampler._cached(
        ("stream_fold_program", t_cap, G, n_samples, n_batches, n_burnin,
         float(T), K, id(mesh) if mesh else None),
        build_program,
    )

    ev0 = jnp.zeros((), jnp.int32)
    flags = jnp.zeros((2,), jnp.int32)
    carry = (state, stats, j_done, ev0, flags)
    groups = 0
    save_every_groups = max(1, -(-int(checkpoint_every) // K))
    while True:
        carry = run_program(*carry)
        fills += K
        _fail_after_fills(fills)
        groups += 1
        state_c, stats_c, j_done_c, ev_c, flags_c = carry
        t_h, j_h, ev_h, fl_h = jax.device_get(
            (state_c.t, j_done_c, ev_c, flags_c)
        )
        events += int(ev_h)
        carry = (state_c, stats_c, j_done_c, jnp.zeros((), jnp.int32),
                 jnp.zeros((2,), jnp.int32))
        if int(np.asarray(fl_h)[0]):
            raise RuntimeError(
                "streaming grid coverage overflow: a fill advanced a "
                f"chain's sample grid by more than grid_chunk={G} points "
                "past the fill's clock cap (an engine invariant — please "
                "report); rerun with a larger grid_chunk as a workaround"
            )
        done = np.asarray(t_h) >= T
        all_done = bool(done.all())
        grid_done = int(np.asarray(j_h).min()) >= n_samples
        if verbose:
            print(
                f"[streaming] fill {fills}: t={np.asarray(t_h).min():.4g}"
                f"/{T} grid {int(np.asarray(j_h).min())}/{n_samples} "
                f"(chains done: {int(done.sum())}/{B})"
            )
        if (checkpoint_path and groups % save_every_groups == 0
                and not (all_done and grid_done)):
            _save_streaming_checkpoint(
                checkpoint_path, state_c, stats_c,
                dict(ck_meta, events=events, fills=fills,
                     cursor=np.asarray(j_h).tolist()),
            )
        if all_done and grid_done:
            break
        if (stop_when_converged and groups % max(1, int(check_every)) == 0
                and int(np.asarray(j_h).min()) > n_burnin):
            from .diagnostics import RHAT_THRESHOLD

            if float(min_ess) > 0:
                # full check needs the (B, M, d) window sums too
                partial = StreamingRun(stats_c, state_c, events, fills,
                                       n_samples, n_burnin, x_ref)
                summ = streaming_summary(partial)
                gated = (summ["converged"] and summ[
                    "ess_total_worst_coord"] >= float(min_ess))
                rhat_max = summ["rhat_max"]
            else:
                # R-hat-only check: fetch just the half sufficient
                # statistics (~3 MB at dim 1000 vs ~65 MB for the window
                # sums)
                nh, sh, qh = jax.device_get(
                    (stats_c.n_half, stats_c.sum_half, stats_c.sumsq_half)
                )
                rhat_max = float(_rhat_from_half_stats(nh, sh, qh).max())
                gated = rhat_max < RHAT_THRESHOLD
            if gated:
                if verbose:
                    print(
                        f"[streaming] early stop at fill {fills}: "
                        f"rhat_max={rhat_max:.4f}"
                    )
                break
        if int(np.asarray(fl_h)[1]):
            raise RuntimeError("streaming sampling made no progress")
    state, stats = carry[0], carry[1]
    sampler.state = state
    return StreamingRun(stats, state, events, fills, n_samples, n_burnin,
                        x_ref)


def _rhat_from_half_stats(n_h, sum_h, sq_h):
    """Split-R-hat over the 2B half-chains from (count, sum, sum-of-
    squares) sufficient statistics (float64; the diagnostics.split_rhat
    formula with equal half lengths by grid design)."""
    n_h = np.asarray(n_h, np.float64)
    sum_h = np.asarray(sum_h, np.float64)
    sq_h = np.asarray(sq_h, np.float64)
    B = n_h.shape[0]
    d = sum_h.shape[-1]
    n_safe = np.maximum(n_h, 1.0)[:, :, None]
    mu_h = sum_h / n_safe
    var_h = np.maximum(
        (sq_h - sum_h * mu_h) / np.maximum(n_h[:, :, None] - 1.0, 1.0), 0.0
    )
    n_half = float(np.maximum(n_h.mean(), 2.0))
    seq_mu = mu_h.reshape(2 * B, d)
    W = var_h.reshape(2 * B, d).mean(axis=0)
    B_var = n_half * seq_mu.var(axis=0, ddof=1)
    var_plus = (n_half - 1.0) / n_half * W + B_var / n_half
    return np.sqrt(np.where(W > 0, var_plus / np.where(W > 0, W, 1.0), 1.0))


def streaming_summary(run: StreamingRun, x_ref=None,
                      rhat_threshold: float | None = None) -> dict:
    """Finalize a :class:`StreamingRun` into moments, split-R-hat, and the
    batch-means ESS aggregate (float64, host).  Mirrors the fields of
    ``diagnostics.ess_summary`` plus per-chain moments.

    ``x_ref`` defaults to the centering offset recorded on the run (the
    mean initial position the fold subtracted for float32 accumulation
    accuracy), so means come back in the original coordinates without the
    caller having to thread it through."""
    from .diagnostics import RHAT_THRESHOLD

    if rhat_threshold is None:
        rhat_threshold = RHAT_THRESHOLD
    if x_ref is None:
        x_ref = run.x_ref
    s = jax.device_get(run.stats)
    n_h = np.asarray(s.n_half, np.float64)          # (B, 2)
    sum_h = np.asarray(s.sum_half, np.float64)      # (B, 2, d)
    sq_h = np.asarray(s.sumsq_half, np.float64)
    bsum = np.asarray(s.bsum, np.float64)           # (B, M, d)
    bcount = np.asarray(s.bcount, np.float64)
    B, M, d = bsum.shape

    n_safe = np.maximum(n_h, 1.0)[:, :, None]
    mu_h = sum_h / n_safe                           # (B, 2, d) centered means
    var_h = np.maximum(
        (sq_h - sum_h * mu_h) / np.maximum(n_h[:, :, None] - 1.0, 1.0), 0.0
    )
    n_tot = n_h.sum(axis=1)                         # (B,)
    mean_c = sum_h.sum(axis=1) / np.maximum(n_tot, 1.0)[:, None]  # centered
    var_c = np.maximum(
        (sq_h.sum(axis=1) - n_tot[:, None] * mean_c ** 2)
        / np.maximum(n_tot - 1.0, 1.0)[:, None],
        0.0,
    )

    rhat = _rhat_from_half_stats(s.n_half, s.sum_half, s.sumsq_half)

    # batch-means ESS per chain/coordinate.  Only windows that are (near)
    # fully populated enter the between-window variance: an early-stopped
    # run (stop_when_converged) leaves trailing windows empty or partial,
    # and their zero/noisy means would corrupt var_bm.
    full = bcount >= np.maximum(
        0.75 * bcount.max(axis=1, keepdims=True), 1.0)  # (B, M)
    m_eff = np.maximum(full.sum(axis=1), 2.0)           # (B,)
    bc = np.maximum(bcount, 1.0)[:, :, None]
    bmu = np.where(full[:, :, None], bsum / bc, 0.0)    # (B, M, d)
    bmean = bmu.sum(axis=1) / m_eff[:, None]            # (B, d)
    var_bm = (np.where(full[:, :, None],
                       (bmu - bmean[:, None, :]) ** 2, 0.0).sum(axis=1)
              / np.maximum(m_eff - 1.0, 1.0)[:, None])  # (B, d)
    L = (np.where(full, bcount, 0.0).sum(axis=1)
         / m_eff)[:, None]                              # mean window length
    L = np.maximum(L, 1.0)
    n_used = (m_eff * L[:, 0])[:, None]                 # samples in the est.
    ess = np.where(
        var_bm > 0,
        np.maximum(n_used, 1.0) * var_c / (L * np.where(
            var_bm > 0, var_bm, 1.0)),
        np.maximum(n_used, 1.0),
    )                                               # (B, d)
    per_coord = ess.sum(axis=0)

    mean = mean_c + np.asarray(x_ref)
    return {
        "mean": mean,                               # (B, d)
        "var": var_c,                               # (B, d)
        "pooled_mean": mean.mean(axis=0),
        "pooled_var": (var_c + (mean - mean.mean(axis=0)) ** 2).mean(axis=0),
        "ess": ess,                                 # (B, d)
        "ess_per_coord": per_coord,
        "ess_total_worst_coord": float(per_coord.min()),
        "rhat": rhat,
        "rhat_max": float(rhat.max()),
        "converged": bool(rhat.max() < rhat_threshold),
        "n_samples_used": float(n_tot.sum()),
    }
