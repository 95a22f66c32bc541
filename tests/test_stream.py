"""Stream-recording runner tests (the GPU default path, CPU-validated).

The dense transition-row stream must be a valid skeleton: monotone
trajectory times per chain, correct interpolation moments, and an exact
event-only view under host compaction (see ``core/engine.py`` rationale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pdmpflux_tpu as pf
from pdmpflux_tpu.core import engine
from pdmpflux_tpu.core.types import EV_INIT, empty_skeleton
from pdmpflux_tpu.parallel.sharded import pooled_moments

DIM, B, TARGET, T_CAP = 4, 128, 300, 1024


def _prep(sampler, seed=0):
    st = sampler.init_state_batch(
        np.zeros((B, DIM)), np.ones((B, DIM)), seed, dtype=jnp.float32
    )
    stream = engine.empty_stream(T_CAP, DIM, jnp.float32, B)
    counts = jnp.zeros((B,), jnp.int32)
    return st, stream, counts


def test_xla_stream_monotone_and_complete():
    sampler = pf.ZigZag(DIM, lambda x: x)
    run = jax.jit(engine.make_stream_runner(sampler, T_CAP, chunk=32),
                  static_argnums=(3,))
    res = run(*_prep(sampler), TARGET)
    counts = np.asarray(res.counts)
    assert (counts == TARGET).all()
    rows = int(np.asarray(res.stream.n_valid)[0])
    t = np.asarray(res.stream.t)[:, :rows]
    assert np.all(np.diff(t, axis=1) >= 0)
    mean, var = pooled_moments(res.stream, sampler, 300)
    assert np.all(np.abs(np.asarray(var) - 1.0) < 0.3)


def test_stream_matches_compact_runner_exactly():
    """Same seeds => the stream's event rows equal the scatter-compacted
    skeleton events (identical transition sequence, different recording)."""
    sampler = pf.ZigZag(DIM, lambda x: x)
    run_s = jax.jit(engine.make_stream_runner(sampler, T_CAP, chunk=32),
                    static_argnums=(3,))
    res_s = run_s(*_prep(sampler, seed=3), TARGET)
    ev = engine.compact_stream_host(res_s.stream, res_s.counts)

    st = sampler.init_state_batch(
        np.zeros((B, DIM)), np.ones((B, DIM)), 3, dtype=jnp.float32
    )
    skel = empty_skeleton(TARGET + 1, DIM, jnp.float32, batch_shape=(B,))
    skel = engine.record_initial(skel, st, EV_INIT)
    run_c = jax.jit(
        engine.make_fixed_event_runner(sampler, TARGET + 1, T_CAP * 4)
    )
    res_c = run_c(st, skel)

    for b in (0, 7, B - 1):
        np.testing.assert_allclose(
            ev[b]["t"][:TARGET],
            np.asarray(res_c.skeleton.t)[b, 1 : TARGET + 1],
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            ev[b]["x"][:TARGET],
            np.asarray(res_c.skeleton.x)[b, 1 : TARGET + 1],
            rtol=1e-5, atol=1e-6,
        )


def test_stream_overflow_reports_partial():
    sampler = pf.ZigZag(DIM, lambda x: x)
    tiny_cap = 64
    run = jax.jit(engine.make_stream_runner(sampler, tiny_cap, chunk=32),
                  static_argnums=(3,))
    st = sampler.init_state_batch(
        np.zeros((B, DIM)), np.ones((B, DIM)), 0, dtype=jnp.float32
    )
    stream = engine.empty_stream(tiny_cap, DIM, jnp.float32, B)
    res = run(st, stream, jnp.zeros((B,), jnp.int32), 10_000)
    assert int(res.transitions) == tiny_cap
    assert (np.asarray(res.counts) < 10_000).all()


def test_stream_host_accumulation_matches_device(monkeypatch):
    """The host-accumulated stream loop (large-payload fallback used when the
    device-side accumulator would exceed HBM, e.g. dim-1000 sticky runs) is
    bit-exact with the device-side accumulation path."""
    import dataclasses

    from pdmpflux_tpu import api
    from pdmpflux_tpu.core import capability

    dim, Bc, n_sk = 6, 16, 50

    def run(host):
        path = dataclasses.replace(capability.CPU_PATH, recorder="stream",
                                   host_acc=host)
        monkeypatch.setattr(capability, "resolve", lambda: path)
        zz = pf.ZigZagAD(dim, lambda x: jnp.sum(x * x) / 2)
        return api._sample_skeleton_events_stream(
            zz, n_sk, np.zeros((Bc, dim)), np.ones((Bc, dim)),
            0, jnp.float32, 200, False,
        )

    s_host = run(True)
    s_dev = run(False)
    assert (np.asarray(s_host.n_valid) == np.asarray(s_dev.n_valid)).all()
    assert (np.asarray(s_host.kind) == np.asarray(s_dev.kind)).all()
    np.testing.assert_allclose(np.asarray(s_host.x), np.asarray(s_dev.x))
    np.testing.assert_allclose(np.asarray(s_host.t), np.asarray(s_dev.t))
    np.testing.assert_allclose(np.asarray(s_host.ar), np.asarray(s_dev.ar))


def _use_path(monkeypatch, **fields):
    import dataclasses

    from pdmpflux_tpu.core import capability

    path = dataclasses.replace(capability.CPU_PATH, **fields)
    monkeypatch.setattr(capability, "resolve", lambda: path)


def test_one_shot_fused_path_matches_general(monkeypatch):
    """The fused one-shot fast path (init + fill + compaction as ONE
    dispatched program; on by default on a GPU) is bit-exact with the
    general loop, including the straggler handoff when the fill is too
    small for the whole run."""
    dim, Bc, n_sk = 4, 8, 200
    x0, v0 = np.zeros((Bc, dim)), np.ones((Bc, dim))
    U = lambda x: jnp.sum(x * x) / 2

    _use_path(monkeypatch, recorder="stream")
    ref = pf.sample_skeleton(pf.ZigZagAD(dim, U), n_sk, x0, v0, seed=3)

    _use_path(monkeypatch, recorder="stream", one_shot=True)
    one = pf.sample_skeleton(pf.ZigZagAD(dim, U), n_sk, x0, v0, seed=3)
    np.testing.assert_array_equal(np.asarray(ref.n_valid),
                                  np.asarray(one.n_valid))
    np.testing.assert_array_equal(np.asarray(ref.t), np.asarray(one.t))
    np.testing.assert_array_equal(np.asarray(ref.x), np.asarray(one.x))
    np.testing.assert_array_equal(np.asarray(ref.kind), np.asarray(one.kind))

    # straggler handoff: shrink the budget so t_cap < the transitions the
    # run needs (but est_peak still admits device accumulation) — the
    # one-shot's partial accumulator continues through the merge loop
    monkeypatch.setenv("PDMPFLUX_DEVICE_BYTES", "1200000")
    multi = pf.sample_skeleton(pf.ZigZagAD(dim, U), n_sk, x0, v0, seed=3)
    np.testing.assert_array_equal(np.asarray(ref.t), np.asarray(multi.t))
    np.testing.assert_array_equal(np.asarray(ref.kind),
                                  np.asarray(multi.kind))


def test_one_shot_horizon_matches_general(monkeypatch):
    """Horizon-mode one-shot (init + fill + compaction fused; finalize as a
    second fused dispatch) is bit-exact with the general loop, including
    the straggler handoff into the merge loop."""
    dim, Bc, T = 3, 4, 10.0
    x0, v0 = np.zeros((Bc, dim)), np.ones((Bc, dim))
    U = lambda x: jnp.sum(x * x) / 2

    _use_path(monkeypatch, recorder="stream")
    ref = pf.sample_skeleton(pf.ZigZagAD(dim, U), T, x0, v0, seed=0,
                             init_capacity=512)

    _use_path(monkeypatch, recorder="stream", one_shot=True)
    one = pf.sample_skeleton(pf.ZigZagAD(dim, U), T, x0, v0, seed=0,
                             init_capacity=512)
    strag = pf.sample_skeleton(pf.ZigZagAD(dim, U), T, x0, v0, seed=0,
                               init_capacity=64)
    nv = np.asarray(ref.n_valid)
    for skel in (one, strag):
        np.testing.assert_array_equal(nv, np.asarray(skel.n_valid))
        t_r, t_s = np.asarray(ref.t), np.asarray(skel.t)
        x_r, x_s = np.asarray(ref.x), np.asarray(skel.x)
        for b in range(Bc):
            np.testing.assert_allclose(t_s[b, : nv[b]], t_r[b, : nv[b]],
                                       rtol=1e-12)
            np.testing.assert_allclose(x_s[b, : nv[b]], x_r[b, : nv[b]],
                                       rtol=1e-12)
            assert abs(t_s[b, nv[b] - 1] - T) < 1e-9


def _random_stream(key, B, T, d, p_event=0.7):
    ks = jax.random.split(key, 8)
    return engine.Skeleton(
        x=jax.random.normal(ks[0], (B, T, d)),
        v=jax.random.normal(ks[1], (B, T, d)),
        t=jnp.cumsum(jax.random.uniform(ks[2], (B, T)), axis=1),
        horizon=jax.random.uniform(ks[3], (B, T)),
        ar=jax.random.uniform(ks[4], (B, T)),
        is_active=jax.random.uniform(ks[5], (B, T, d)) < 0.9,
        rejected=jnp.zeros((B, T), jnp.int32),
        errored_bound=jnp.zeros((B, T), jnp.int32),
        hitting_horizon=jnp.zeros((B, T), jnp.int32),
        error_value_ar=jax.random.normal(ks[6], (B, T, 5)),
        kind=(jax.random.uniform(ks[7], (B, T)) < p_event).astype(jnp.int32) * 2,
        n_valid=jnp.full((B,), T, jnp.int32),
    )


def test_compact_gather_matches_logshift():
    """The index-gather compaction (large-d dispatch) is bit-identical to
    the log-shift formulation on every field."""
    stream = _random_stream(jax.random.key(0), B=4, T=96, d=128)
    for n_keep in (16, 96, 128):
        a = engine._compact_rows_gather(stream, n_keep)
        # force the log-shift branch by viewing the same data as small-d
        kind = stream.kind
        keep = kind > 0
        import pdmpflux_tpu.core.engine as eng

        orig = eng.GATHER_DIM_THRESHOLD
        try:
            eng.GATHER_DIM_THRESHOLD = 1 << 30
            b = eng.compact_stream_rows(stream, n_keep)
        finally:
            eng.GATHER_DIM_THRESHOLD = orig
        for f in engine.Skeleton._fields:
            if f == "n_valid":
                continue
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
            )


def test_merge_gather_matches_logshift():
    """The index-gather merge (large-d dispatch) is bit-identical to the
    per-chain log-shift merge."""
    import pdmpflux_tpu.core.engine as eng

    d = 128
    target = 64
    key = jax.random.key(1)
    acc_raw = _random_stream(key, B=5, T=target, d=d, p_event=1.0)
    # accumulator: dense prefixes of varying length
    offs = np.array([0, 3, 17, 40, 64], np.int32)
    col = np.arange(target)[None, :]
    mask = jnp.asarray(col < offs[:, None])

    def clip(sk):
        out = {}
        for f in engine.Skeleton._fields:
            if f == "n_valid":
                continue
            a = getattr(sk, f)
            m = mask.reshape(mask.shape + (1,) * (a.ndim - 2))
            out[f] = jnp.where(m, a, jnp.zeros((), a.dtype))
        return engine.Skeleton(**out, n_valid=sk.n_valid)

    acc = clip(acc_raw)
    rows = _random_stream(jax.random.key(2), B=5, T=24, d=d, p_event=1.0)
    a = eng._merge_rows_gather(acc, rows, jnp.asarray(offs), target)
    orig = eng.GATHER_DIM_THRESHOLD
    try:
        eng.GATHER_DIM_THRESHOLD = 1 << 30
        b = eng.merge_rows_at_offsets(acc, rows, jnp.asarray(offs), target)
    finally:
        eng.GATHER_DIM_THRESHOLD = orig
    for f in engine.Skeleton._fields:
        if f == "n_valid":
            continue
        ax, bx = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        # beyond offset+fill rows both must be zero padding; compare fully
        np.testing.assert_array_equal(ax, bx, err_msg=f)


def test_merge_stream_matches_two_step():
    """The fused raw-stream merge (compaction permutation composed with the
    offset shift, large-d gather) is bit-identical to compact-then-merge."""
    import pdmpflux_tpu.core.engine as eng

    d = 128
    target = 96
    acc_raw = _random_stream(jax.random.key(3), B=4, T=target, d=d, p_event=1.0)
    offs = np.array([0, 5, 30, 60], np.int32)
    col = np.arange(target)[None, :]
    mask = jnp.asarray(col < offs[:, None])

    def clip(sk):
        out = {}
        for f in engine.Skeleton._fields:
            if f == "n_valid":
                continue
            a = getattr(sk, f)
            m = mask.reshape(mask.shape + (1,) * (a.ndim - 2))
            out[f] = jnp.where(m, a, jnp.zeros((), a.dtype))
        return engine.Skeleton(**out, n_valid=sk.n_valid)

    acc = clip(acc_raw)
    fill = _random_stream(jax.random.key(4), B=4, T=48, d=d, p_event=0.6)
    fused = eng.merge_stream_at_offsets(acc, fill, jnp.asarray(offs), target)
    two_step = eng.merge_rows_at_offsets(
        acc, eng.compact_stream_rows(fill, 48), jnp.asarray(offs), target
    )
    for f in engine.Skeleton._fields:
        if f == "n_valid":
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(fused, f)), np.asarray(getattr(two_step, f)),
            err_msg=f,
        )


def test_forced_stream_horizon_api(stream_path):
    """The stream-recorder horizon driver (stream fills + device compaction
    + exact-T terminal) satisfies the same contracts as the scatter path
    when forced to run on CPU."""
    dim, T = 3, 20.0
    sampler = pf.ZigZagAD(dim, pf.utils.potentials.gauss)
    skel = pf.sample_skeleton(sampler, T, np.zeros(dim), np.ones(dim), seed=3,
                              init_capacity=64)
    t = np.asarray(skel.t)
    assert float(t[-1]) == T
    assert int(np.asarray(skel.kind)[-1]) == pf.EV_TERMINAL
    assert np.all(np.diff(t) >= 0)
    assert np.all(t <= T)
    # batched
    skel2 = pf.sample_skeleton(
        sampler, T, np.zeros((3, dim)), np.ones((3, dim)), seed=4,
        init_capacity=64,
    )
    nv = np.asarray(skel2.n_valid)
    for b in range(3):
        tb = np.asarray(skel2.t)[b, : nv[b]]
        assert float(tb[-1]) == T
        assert np.all(np.diff(tb) >= 0)
    # sticky horizon through the same forced path
    ssampler = pf.StickyZigZagAD(dim, pf.utils.potentials.gauss,
                                 np.full(dim, 8.0))
    skel3 = pf.sample_skeleton(
        ssampler, 15.0, np.full(dim, 0.2), np.ones(dim), seed=5,
        init_capacity=64,
    )
    t3 = np.asarray(skel3.t)
    assert float(t3[-1]) == 15.0
    kinds = set(np.asarray(skel3.kind).tolist())
    assert pf.EV_STICK in kinds or pf.EV_THAW in kinds


def test_forced_stream_events_matches_default(stream_path):
    """Event-count sampling through the forced stream path agrees with the
    default scan-compact path in law (same moments band)."""
    dim = 2
    s1 = pf.ZigZagAD(dim, pf.utils.potentials.gauss)
    skel = pf.sample_skeleton(s1, 500, np.zeros((4, dim)), np.ones((4, dim)),
                              seed=0)
    assert np.asarray(skel.n_valid).min() == 500
    from pdmpflux_tpu.parallel.sharded import pooled_moments

    mean, var = pooled_moments(skel, s1, 512)
    assert np.abs(np.asarray(mean)).max() < 0.3
    assert np.abs(np.asarray(var) - 1.0).max() < 0.4
