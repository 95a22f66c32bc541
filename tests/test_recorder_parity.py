"""Stream recorder against the scatter recorder (the plain reference), for
every sampler family: the same seeds run the same transitions, so the
event skeletons must be identical — only the recording differs."""

import numpy as np
import pytest

import pdmpflux_tpu as pf
from families import FAMILIES, inits


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_matches_scatter_recorder(name):
    B, n_sk = 8, 120
    x0, v0 = inits(name, B)
    ref = pf.sample_skeleton(FAMILIES[name](), n_sk, x0, v0, seed=4,
                             backend="xla")
    got = pf.sample_skeleton(FAMILIES[name](), n_sk, x0, v0, seed=4,
                             backend="xla_stream")
    np.testing.assert_array_equal(np.asarray(got.n_valid),
                                  np.asarray(ref.n_valid))
    assert (np.asarray(ref.n_valid) == n_sk).all()
    for f in ("kind", "t", "x", "v", "is_active", "ar", "rejected"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
