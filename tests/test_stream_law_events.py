"""Stream-path law in event-count mode: every sampler family, run through
the GPU execution record (stream recorder, fused one-shot, adaptive fills)
on CPU, reproduces its analytic stationary moments."""

import jax.numpy as jnp
import numpy as np
import pytest

import pdmpflux_tpu as pf
from families import FAMILIES, TRUTH, inits

B, N_SK = 32, 600


def check_moments(name, sampler, skel, n_per_chain=400):
    """Pooled moments of the post-burn-in (first 10% dropped) equal-time
    samples against the family's analytic truth."""
    smp = np.asarray(pf.parallel.sample_from_skeleton_batch(
        sampler, n_per_chain, skel))[:, n_per_chain // 10:]
    assert np.isfinite(smp).all()
    mean, var = TRUTH[name]
    pooled = smp.reshape(-1, smp.shape[-1])
    assert np.abs(pooled.mean(axis=0) - mean).max() < 0.2, name
    assert np.abs(pooled.var(axis=0) / var - 1.0).max() < 0.25, name


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_event_mode_moments(gpu_path, name):
    sampler = FAMILIES[name]()
    x0, v0 = inits(name, B)
    skel = pf.sample_skeleton(sampler, N_SK, x0, v0, seed=11,
                              dtype=jnp.float32)
    assert (np.asarray(skel.n_valid) == N_SK).all()
    assert any(k[0] == "stream_one_shot" for k in sampler._jit_cache)
    check_moments(name, sampler, skel)
