"""Streaming-statistics correctness: the online accumulators must reproduce
what the materialized pipeline computes from the same trajectory.

The reference's own online-vs-offline agreement test for its fused
diagnostic (``/root/reference/test/test_diagnostics.jl:131-143``) is the
model: run the SAME seed through (a) ``sample_streaming_stats`` (fills
folded and discarded) and (b) ``sample_skeleton(T)`` + equal-time
interpolation of the materialized skeleton, and require the statistics to
agree to float tolerance.  Both paths run the XLA stream engine
(the ``stream_path`` fixture), whose trajectory is independent of the fill
geometry, so (a) and (b) see identical skeletons.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import pdmpflux_tpu as pf
from pdmpflux_tpu.api import _interp_times
from pdmpflux_tpu import streaming


def _reference_stats(sampler, skel_batch, T, n_samples, n_batches,
                     burnin_frac):
    """Materialized-path reference: per-chain equal-time samples at the
    streaming grid, reduced with float64 numpy."""
    B = np.asarray(skel_batch.t).shape[0]
    n_burnin = int(burnin_frac * n_samples)
    n_post = n_samples - n_burnin
    tm = (np.arange(n_samples) + 1) * (T / n_samples)
    xs = []
    for b in range(B):
        chain = type(skel_batch)(*[
            np.asarray(a)[b] for a in skel_batch
        ])
        n0 = int(np.asarray(chain.n_valid))
        chain = type(chain)(*[
            (np.asarray(a)[:n0] if np.ndim(a) >= 1 else a) for a in chain
        ])
        x_b = np.asarray(_interp_times(
            sampler, chain, jnp.asarray(tm, np.asarray(chain.t).dtype),
            discard_vt=True,
        ))
        xs.append(x_b)
    xs = np.stack(xs)[:, n_burnin:, :].astype(np.float64)  # (B, n_post, d)

    half = np.arange(n_post) * 2 // n_post
    win = np.arange(n_post) * n_batches // n_post
    ref = {
        "mean": xs.mean(axis=1),
        "var": xs.var(axis=1, ddof=1),
        "n_half": np.stack([(half == h).sum() * np.ones(B) for h in (0, 1)],
                           axis=1),
        "half_mean": np.stack(
            [xs[:, half == h].mean(axis=1) for h in (0, 1)], axis=1),
        "bsum": np.stack(
            [xs[:, win == m].sum(axis=1) for m in range(n_batches)], axis=1),
        "bcount": np.stack(
            [(win == m).sum() * np.ones(B) for m in range(n_batches)],
            axis=1),
        "samples": xs,
    }
    return ref


@pytest.mark.parametrize("make", [
    lambda: pf.ZigZagAD(3, lambda x: jnp.sum(x * x) / 2),
    lambda: pf.StickyZigZagAD(3, lambda x: jnp.sum(x * x) / 2,
                              np.full(3, 5.0)),
])
@pytest.mark.usefixtures("stream_path")
def test_streaming_matches_materialized(make):
    T, n_samples, n_batches, burnin = 160.0, 512, 8, 0.25
    B, d = 4, 3
    x0 = np.full((B, d), 0.4)
    v0 = np.ones((B, d))

    run = streaming.sample_streaming_stats(
        make(), T, x0, v0, n_samples=n_samples, n_batches=n_batches,
        burnin_frac=burnin, seed=7, t_cap=64, grid_chunk=128,
    )
    assert run.fills >= 2  # small t_cap must force the multi-fill path

    sampler2 = make()
    skel = pf.sample_skeleton(sampler2, T, x0, v0, seed=7)
    ref = _reference_stats(sampler2, skel, T, n_samples, n_batches, burnin)

    summ = streaming.streaming_summary(run, x_ref=x0.mean(axis=0))
    np.testing.assert_allclose(summ["mean"], ref["mean"], atol=1e-6)
    np.testing.assert_allclose(summ["var"], ref["var"], rtol=1e-6, atol=1e-9)

    s = np.asarray(run.stats.bcount)
    np.testing.assert_array_equal(s, ref["bcount"])
    np.testing.assert_array_equal(np.asarray(run.stats.n_half),
                                  ref["n_half"])
    x_ref = x0.mean(axis=0)
    bsum_ref = ref["bsum"] - ref["bcount"][:, :, None] * x_ref[None, None, :]
    np.testing.assert_allclose(np.asarray(run.stats.bsum, np.float64),
                               bsum_ref, rtol=1e-5, atol=1e-5)

    # split-R-hat from sufficient statistics == diagnostics.split_rhat on
    # the identical materialized sample set
    from pdmpflux_tpu.diagnostics import split_rhat

    rhat_ref = split_rhat(ref["samples"])
    np.testing.assert_allclose(summ["rhat"], rhat_ref, rtol=1e-6)


@pytest.mark.usefixtures("stream_path")
def test_streaming_summary_convergence():
    """A long-enough Gaussian run must gate (rhat ~ 1) with sane moments and
    a positive finite batch-means ESS."""
    B, d = 8, 2
    sampler = pf.ZigZagAD(d, lambda x: jnp.sum(x * x) / 2)
    run = streaming.sample_streaming_stats(
        sampler, 400.0, np.zeros((B, d)), np.ones((B, d)),
        n_samples=2048, n_batches=16, seed=3, t_cap=2048, grid_chunk=256,
    )
    summ = streaming.streaming_summary(run)
    assert summ["converged"], summ["rhat_max"]
    assert np.all(np.abs(summ["pooled_mean"]) < 0.3)
    assert np.all((summ["pooled_var"] > 0.5) & (summ["pooled_var"] < 2.0))
    assert 0 < summ["ess_total_worst_coord"] < np.inf
    assert run.events > 0


@pytest.mark.usefixtures("stream_path")
def test_streaming_checkpoint_resume(monkeypatch, tmp_path):
    """Crash mid-run via fault injection, resume from the checkpoint, and
    require accumulators identical to an uninterrupted run (determinism
    comes from the PRNG keys in the saved state; the anchor and grid
    cursor are recomputed from it)."""
    B, d = 4, 3
    kw = dict(n_samples=512, n_batches=8, seed=11, t_cap=64, grid_chunk=128)
    x0, v0 = np.full((B, d), 0.4), np.ones((B, d))

    def make():
        return pf.ZigZagAD(d, lambda x: jnp.sum(x * x) / 2)

    ref = streaming.sample_streaming_stats(make(), 160.0, x0, v0, **kw)
    assert ref.fills >= 3

    ck = str(tmp_path / "stream.ckpt")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        streaming.sample_streaming_stats(
            make(), 160.0, x0, v0, checkpoint_path=ck, checkpoint_every=1,
            **kw)
    assert (tmp_path / "stream.ckpt").exists()
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    run = streaming.sample_streaming_stats(
        make(), 160.0, x0, v0, checkpoint_path=ck, checkpoint_every=1, **kw)
    for f in ref.stats._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(run.stats, f)),
            np.asarray(getattr(ref.stats, f)), err_msg=f)
    assert run.events == ref.events

    # a checkpoint for a different configuration must refuse to load
    with pytest.raises(ValueError, match="delete it"):
        streaming.sample_streaming_stats(
            make(), 160.0, x0, v0, checkpoint_path=ck, n_samples=1024,
            n_batches=8, seed=11, t_cap=64)


@pytest.mark.usefixtures("stream_path")
def test_streaming_sharded_matches_unsharded():
    """The mesh variant runs the fill+fold program per device under
    shard_map; per-chain trajectories are keyed by (seed, chain index), so
    the accumulators must match the unsharded run (up to summation order —
    fill boundaries differ when the clock cap uses the device-local
    minimum cursor)."""
    from pdmpflux_tpu.parallel import mesh as mesh_lib

    B, d = 16, 3
    kw = dict(n_samples=512, n_batches=8, seed=9, t_cap=64, grid_chunk=128)
    x0, v0 = np.full((B, d), 0.4), np.ones((B, d))

    def make():
        return pf.ZigZagAD(d, lambda x: jnp.sum(x * x) / 2)

    ref = streaming.sample_streaming_stats(make(), 120.0, x0, v0, **kw)
    run = streaming.sample_streaming_stats(
        make(), 120.0, x0, v0, mesh=mesh_lib.make_mesh(8, 1), **kw)
    assert run.events == ref.events
    np.testing.assert_array_equal(np.asarray(run.stats.n_half),
                                  np.asarray(ref.stats.n_half))
    np.testing.assert_array_equal(np.asarray(run.stats.bcount),
                                  np.asarray(ref.stats.bcount))
    for f in ("sum_half", "sumsq_half", "bsum"):
        np.testing.assert_allclose(
            np.asarray(getattr(run.stats, f), np.float64),
            np.asarray(getattr(ref.stats, f), np.float64),
            rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.usefixtures("stream_path")
def test_streaming_f32_matches_f64_statistics():
    """The GPU production path runs float32; its streaming statistics must
    agree with a float64 run of the same config to float32-grade accuracy
    (grid times, interpolation, and accumulator sums all live in f32)."""
    B, d = 8, 3
    kw = dict(n_samples=1024, n_batches=8, seed=13, t_cap=128,
              grid_chunk=256)
    x0, v0 = np.full((B, d), 0.4), np.ones((B, d))

    def make():
        return pf.ZigZagAD(d, lambda x: jnp.sum(x * x) / 2)

    r64 = streaming.sample_streaming_stats(make(), 120.0, x0, v0, **kw)
    r32 = streaming.sample_streaming_stats(make(), 120.0, x0, v0,
                                           dtype=jnp.float32, **kw)
    s64 = streaming.streaming_summary(r64, x_ref=x0.mean(axis=0))
    s32 = streaming.streaming_summary(r32, x_ref=x0.mean(axis=0))
    # different-precision trajectories diverge chaotically, so compare the
    # POOLED statistics at Monte-Carlo tolerance, not per-chain values
    np.testing.assert_allclose(s32["pooled_var"], s64["pooled_var"],
                               rtol=0.35)
    assert abs(s32["rhat_max"] - s64["rhat_max"]) < 0.2
    assert np.all(np.abs(s32["pooled_mean"] - s64["pooled_mean"]) < 0.5)


@pytest.mark.usefixtures("stream_path")
def test_streaming_early_stop():
    """With stop_when_converged, T is a budget: an easy Gaussian run must
    gate long before the horizon, the partial-window batch-means estimator
    must stay finite, and the run's fills must be well under what the full
    budget would need."""
    B, d = 8, 2
    sampler = pf.ZigZagAD(d, lambda x: jnp.sum(x * x) / 2)
    run = streaming.sample_streaming_stats(
        sampler, 4000.0, np.zeros((B, d)), np.ones((B, d)), seed=3,
        n_samples=16384, n_batches=32, t_cap=1024, grid_chunk=512,
        stop_when_converged=True, check_every=2, min_ess=200.0,
    )
    summ = streaming.streaming_summary(run)
    assert summ["converged"], summ["rhat_max"]
    assert summ["ess_total_worst_coord"] >= 200.0
    # the full budget needs ~16k events/chain; the gate fires far earlier
    full_fills_est = 4000.0 * 4.2 / 1024  # rate ~4.2 ev/time/chain
    assert run.fills < 0.8 * full_fills_est, (run.fills, full_fills_est)
    assert np.all((summ["pooled_var"] > 0.5) & (summ["pooled_var"] < 2.0))


def test_streaming_rejects_bad_args():
    sampler = pf.ZigZagAD(2, lambda x: jnp.sum(x * x) / 2)
    with pytest.raises(ValueError):
        streaming.sample_streaming_stats(
            sampler, -1.0, np.zeros(2), np.ones(2))
    with pytest.raises(ValueError):
        streaming.sample_streaming_stats(
            sampler, 10.0, np.zeros(2), np.ones(2), n_samples=16,
            n_batches=64)
