"""Stream-path law in time-horizon mode: every sampler family, run through
the GPU execution record on CPU, ends each chain exactly at ``T`` with a
terminal row and reproduces its analytic stationary moments."""

import jax.numpy as jnp
import numpy as np
import pytest

import pdmpflux_tpu as pf
from families import FAMILIES, inits
from test_stream_law_events import check_moments

B, T = 32, 256.0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_horizon_mode_moments(gpu_path, name):
    sampler = FAMILIES[name]()
    x0, v0 = inits(name, B)
    skel = pf.sample_skeleton(sampler, T, x0, v0, seed=12,
                              dtype=jnp.float32)
    nv = np.asarray(skel.n_valid)
    last = nv - 1
    t_end = np.asarray(skel.t)[np.arange(B), last]
    assert (t_end == np.float32(T)).all()
    assert (np.asarray(skel.kind)[np.arange(B), last] == pf.EV_TERMINAL).all()
    assert any(k[0] == "horizon_one_shot" for k in sampler._jit_cache)
    check_moments(name, sampler, skel)
