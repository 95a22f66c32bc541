"""Round-2 parity/quality additions (VERDICT.md items 5, 7, 8):

* funnel target exercised end-to-end (reference ``test_config.jl:38-42``);
* ``plot_traj`` overlay via ``ax=`` (reference ``plot_traj!``, plot.jl:101-130);
* batch-aware ``diagnostic()`` and batched ``sample_skeleton_with_diagnostic``;
* vectorized host-accumulation stream assembly equals device accumulation;
* vectorized ESS / split-R-hat estimators.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import pdmpflux_tpu as pf
from pdmpflux_tpu import api, diagnostics
from pdmpflux_tpu.utils import potentials


def test_funnel_target_end_to_end():
    # Neal-style funnel (x0 > 0 required); start well inside the support.
    dim = 3
    sampler = pf.ZigZagAD(dim, potentials.funnel)
    x0 = np.array([1.0, 0.0, 0.0])
    v0 = np.ones(dim)
    skel = pf.sample_skeleton(sampler, 400, x0, v0, seed=11)
    t = np.asarray(skel.t)
    assert np.all(np.isfinite(np.asarray(skel.x)))
    assert np.all(np.diff(t) >= 0)
    smp = np.asarray(pf.sample_from_skeleton(sampler, 500, skel))
    assert np.all(np.isfinite(smp))
    assert np.all(smp[:, 0] > 0)  # stays in the funnel's support


@pytest.mark.parametrize(
    "name,U,dim",
    [
        ("neal_funnel", potentials.neal_funnel, 3),
        ("ridged_gauss", potentials.ridged_gauss, 2),
        ("banana", potentials.banana, 3),
    ],
)
def test_complex_potential_coverage(name, U, dim):
    # Mirrors the reference's complex-potential trio, test_coverage.jl:81-98:
    # constant-bound ZigZagAD, 100 events, finiteness.
    sampler = pf.ZigZagAD(dim, U, grid_size=0)
    skel = pf.sample_skeleton(sampler, 100, np.zeros(dim), np.ones(dim), seed=42)
    t = np.asarray(skel.t)
    assert t.size > 0 and np.all(np.isfinite(t))
    assert np.all(np.isfinite(np.asarray(skel.x)))


def test_plot_traj_overlay_ax():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    sampler = pf.ZigZagAD(2, potentials.gauss)
    skel = pf.sample_skeleton(sampler, 50, np.zeros(2), np.ones(2), seed=0)
    fig, ax = plt.subplots()
    n0 = len(ax.lines)
    out = pf.plot_traj(skel, ax=ax)
    assert out is fig
    assert len(ax.lines) == n0 + 1
    pf.plot_traj(skel, ax=ax, color="red")
    assert len(ax.lines) == n0 + 2
    plt.close(fig)
    # 3-D overlay requires a 3-D axes
    sampler3 = pf.ZigZagAD(3, potentials.gauss)
    skel3 = pf.sample_skeleton(sampler3, 30, np.zeros(3), np.ones(3), seed=0)
    fig2, ax2 = plt.subplots()
    with pytest.raises(ValueError):
        pf.plot_traj(skel3, ax=ax2)
    plt.close(fig2)


def test_diagnostic_batched_skeleton():
    sampler = pf.ZigZagAD(2, potentials.gauss)
    skel = pf.sample_skeleton(
        sampler, 100, np.zeros((3, 2)), np.ones((3, 2)), seed=1
    )
    fig = pf.diagnostic(skel)
    assert fig is not None
    import matplotlib.pyplot as plt

    plt.close(fig)


def test_with_diagnostic_batched_chains():
    dim = 2
    sampler = pf.ZigZagAD(dim, potentials.gauss)
    U = potentials.gauss
    skel, rvs = pf.sample_skeleton_with_diagnostic(
        sampler, 8.0, np.zeros((3, dim)), np.ones((3, dim)), U, B=16, seed=5
    )
    assert np.shape(rvs) == (3,)
    assert np.all(np.isfinite(rvs)) and np.all(np.asarray(rvs) >= 0)
    # each chain's RV matches the offline estimate on its own prefix
    n_valid = np.asarray(skel.n_valid)
    import jax

    chain0 = jax.tree.map(
        lambda a: a[0, : n_valid[0]] if np.ndim(a) > 1 else a[0], skel
    )
    rv0 = diagnostics.RV_diagnostic(chain0, U, B=16)
    assert abs(rv0 - rvs[0]) < 1e-6


@pytest.mark.extended
def test_host_acc_stream_equals_device_acc(monkeypatch):
    """The vectorized host-accumulation assembly must produce exactly the
    same skeleton as the on-device accumulation path."""
    dim = 3
    n_sk = 200

    import dataclasses

    from pdmpflux_tpu.core import capability

    def run(host_acc):
        path = dataclasses.replace(capability.CPU_PATH, recorder="stream",
                                   host_acc=host_acc)
        monkeypatch.setattr(capability, "resolve", lambda: path)
        sampler = pf.ZigZagAD(dim, potentials.gauss)
        return api._sample_skeleton_events_stream(
            sampler, n_sk, np.zeros((3, dim)), np.ones((3, dim)),
            seed=9, dtype=None, max_per_event=256, squeeze=False,
        )

    a = run(False)
    b = run(True)
    assert np.array_equal(np.asarray(a.n_valid), np.asarray(b.n_valid))
    for f in ("x", "v", "t", "ar", "kind", "rejected", "is_active"):
        fa, fb = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        for c in range(3):
            n = int(np.asarray(a.n_valid)[c])
            assert np.array_equal(fa[c, :n], fb[c, :n]), f


def test_ess_nd_matches_scalar_ess():
    rng = np.random.default_rng(0)
    # AR(1) series with known autocorrelation
    B, N, d = 4, 512, 3
    x = np.zeros((B, N, d))
    eps = rng.normal(size=(B, N, d))
    for i in range(1, N):
        x[:, i] = 0.7 * x[:, i - 1] + eps[:, i]
    vec = diagnostics.ess_nd(x)
    assert vec.shape == (B, d)
    for b in range(B):
        for j in range(d):
            assert abs(vec[b, j] - diagnostics.ess(x[b, :, j])) < 1e-6
    # 2-D and 1-D shapes
    v2 = diagnostics.ess_nd(x[0])
    assert v2.shape == (d,)
    assert abs(float(diagnostics.ess_nd(x[0, :, 0])) - diagnostics.ess(x[0, :, 0])) < 1e-6


def test_split_rhat_and_summary():
    rng = np.random.default_rng(1)
    good = rng.normal(size=(4, 1024, 2))
    s = diagnostics.ess_summary(good)
    assert s["converged"]
    assert s["rhat_max"] < 1.01
    assert s["ess_total_worst_coord"] > 1000
    # shifted chain -> rhat blows up, gate trips
    bad = good.copy()
    bad[0] += 5.0
    s2 = diagnostics.ess_summary(bad)
    assert not s2["converged"]
    assert s2["rhat_max"] > 1.5


def test_profiling_timed_and_annotate():
    # SURVEY §5 profiling hooks: compile-aware timing + trace annotation.
    from pdmpflux_tpu.utils import profiling

    import jax

    @jax.jit
    def f(x):
        return (x * x).sum()

    r = profiling.timed(f, jnp.arange(8.0), repeats=3)
    assert r["first_call_s"] >= r["steady_state_s"] >= 0
    assert r["compile_overhead_s"] >= 0
    assert float(r["result"]) == float((np.arange(8.0) ** 2).sum())
    with profiling.annotate("unit-test-span"):
        pass


def test_profiling_trace_writes(tmp_path):
    from pdmpflux_tpu.utils import profiling

    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        jnp.ones(4).sum().block_until_ready()
    assert any(logdir.rglob("*"))  # trace artifacts were written


def test_device_bytes_budget_env_override(monkeypatch):
    monkeypatch.setenv("PDMPFLUX_DEVICE_BYTES", str(123 << 20))
    assert api._device_bytes_budget() == 123 << 20
    monkeypatch.delenv("PDMPFLUX_DEVICE_BYTES")
    assert api._device_bytes_budget() > (1 << 30)  # sane floor on any backend


def test_fill_ratio_hysteresis():
    """Seed-to-seed jitter in the measured transition count must not move
    the recorded ratio (geometry ping-pong recompiles a fresh fill
    executable every run); a real change must."""

    class S:
        pass

    s = S()
    api._update_fill_ratio(s, 2047, 2656)
    r1 = s._fill_ratio
    api._update_fill_ratio(s, 2047, 2624)  # ~1.2% jitter -> keep
    assert s._fill_ratio == r1
    api._update_fill_ratio(s, 2047, 4000)  # real shift -> update
    assert s._fill_ratio != r1
