"""Tests that need an NVIDIA GPU.  They skip elsewhere; on a card run

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pdmpflux_tpu as pf
from pdmpflux_tpu import streaming
from pdmpflux_tpu.core import capability, engine

pytestmark = pytest.mark.gpu


def test_gpu_takes_stream_path(gpu_device):
    assert capability.resolve() == capability.GPU_PATH
    B, dim = 256, 10
    sampler = pf.ZigZag(dim, lambda x: x)
    skel = pf.sample_skeleton(sampler, 256, np.zeros((B, dim)),
                              np.ones((B, dim)), seed=0, dtype=jnp.float32)
    assert (np.asarray(skel.n_valid) == 256).all()
    assert any(k[0] == "stream_one_shot" for k in sampler._jit_cache)
    assert skel.x.devices() == {gpu_device}


def test_gpu_recorders_agree(gpu_device):
    """The first 64 events of every chain agree across recorders (f32,
    rtol 1e-5: differently fused programs may differ in the last bits)."""
    B, dim, n_sk = 256, 10, 256
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))
    out = {}
    for backend in ("xla", "xla_stream"):
        out[backend] = pf.sample_skeleton(
            pf.ZigZag(dim, lambda x: x), n_sk, x0, v0, seed=1,
            dtype=jnp.float32, backend=backend)
    for f in ("t", "x"):
        a = np.asarray(getattr(out["xla"], f))[:, :65]
        b = np.asarray(getattr(out["xla_stream"], f))[:, :65]
        np.testing.assert_allclose(b, a, rtol=1e-5)


def test_gpu_fold_sums_at_full_precision(gpu_device):
    """The fold's one-hot contractions keep f32 accuracy on the card (TF32
    would leave ~1e-3 relative error)."""
    B, W, G, d, n_samples, n_batches = 64, 256, 256, 10, 1024, 16
    sampler = pf.ZigZag(d, lambda x: x)
    fold = jax.jit(streaming.make_fold_chunk(
        sampler, W, G, n_samples, n_batches, 0, 1.0 / 8,
        np.zeros(d, np.float32)))
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 32, (B, W)), axis=1).astype(np.float32)
    x = (1.0 + rng.uniform(0, 1e-3, (B, W, d))).astype(np.float32)
    stream = engine.empty_stream(W, d, jnp.float32, B)._replace(
        t=jnp.asarray(t), x=jnp.asarray(x),
        v=jnp.zeros((B, W, d), jnp.float32),
        is_active=jnp.ones((B, W, d), bool))
    anchor = (jnp.zeros(B), jnp.asarray(x[:, 0]), jnp.zeros((B, d)),
              jnp.ones((B, d), bool))
    stats = fold(streaming.empty_stats(B, d, n_batches, jnp.float32), stream,
                 anchor, W, jnp.zeros(B, jnp.int32),
                 jnp.full(B, G, jnp.int32))
    n = np.asarray(stats.n_half).sum(axis=1)
    assert (n > 0).all()
    mean = np.asarray(stats.sum_half, np.float64).sum(axis=1) / n[:, None]
    sq = np.asarray(stats.sumsq_half, np.float64).sum(axis=1) / n[:, None]
    # every sample lies in [1, 1.001], so the mean does too and the
    # variance sq - mean^2 is below 1e-6; a TF32 product (10-bit mantissa)
    # rounds each term by up to ~5e-4 and breaks both
    assert np.all((mean >= 1.0 - 1e-6) & (mean <= 1.001 + 1e-6))
    np.testing.assert_allclose(sq, mean ** 2, rtol=2e-6)
