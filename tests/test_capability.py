"""Execution-path resolver, backend selection, device budget, compile cache
and f32 contraction precision — the device-facing choices the GPU path
depends on, checked on CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pdmpflux_tpu as pf
from pdmpflux_tpu import api, streaming
from pdmpflux_tpu.core import capability, engine
from pdmpflux_tpu.utils import profiling


class _FakeDevice:
    def __init__(self, platform, stats=None, kind="NVIDIA H100 80GB HBM3"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def clean_path_env(monkeypatch):
    for flag in ("PDMPFLUX_FORCE_STREAM", "PDMPFLUX_TEST_ONE_SHOT",
                 "PDMPFLUX_STREAM_HOST_ACC"):
        monkeypatch.delenv(flag, raising=False)


@pytest.mark.usefixtures("clean_path_env")
def test_resolver_gpu_record(monkeypatch):
    monkeypatch.setattr(capability.jax, "devices",
                        lambda: [_FakeDevice("gpu")])
    path = capability.resolve.__wrapped__()
    assert path == capability.GPU_PATH
    assert path.recorder == "stream"
    assert path.one_shot and path.adaptive_fill and not path.host_acc
    assert path.fills_per_dispatch == 8


@pytest.mark.usefixtures("clean_path_env")
def test_resolver_cpu_record():
    path = capability.path_for("cpu")
    assert path == capability.CPU_PATH
    assert path.recorder == "scatter"
    assert not path.one_shot and not path.adaptive_fill
    # the real default device of the test process is the CPU
    assert capability.resolve.__wrapped__() == capability.CPU_PATH


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_resolver_rejects_unknown_platform(platform):
    with pytest.raises(RuntimeError, match="no execution path"):
        capability.path_for(platform)


@pytest.mark.usefixtures("clean_path_env")
def test_resolver_env_flags(monkeypatch):
    monkeypatch.setenv("PDMPFLUX_FORCE_STREAM", "1")
    monkeypatch.setenv("PDMPFLUX_TEST_ONE_SHOT", "1")
    monkeypatch.setenv("PDMPFLUX_STREAM_HOST_ACC", "1")
    path = capability.path_for("cpu")
    assert (path.recorder, path.one_shot, path.host_acc) == (
        "stream", True, True)
    assert path.fills_per_dispatch == capability.CPU_PATH.fills_per_dispatch


def test_resolver_record_is_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        capability.GPU_PATH.recorder = "scatter"


@pytest.mark.parametrize("n_or_T", [50, 5.0])
def test_backend_pallas_raises(n_or_T):
    sampler = pf.ZigZag(3, lambda x: x)
    with pytest.raises(ValueError, match="backend='pallas' was removed"):
        pf.sample_skeleton(sampler, n_or_T, np.zeros(3), np.ones(3), seed=0,
                           backend="pallas")


def test_backend_unknown_raises():
    sampler = pf.ZigZag(3, lambda x: x)
    with pytest.raises(ValueError, match="unknown backend"):
        pf.sample_skeleton(sampler, 20, np.zeros(3), np.ones(3), seed=0,
                           backend="triton")


def test_backend_selects_recorder(gpu_path):
    """With the GPU record, ``auto`` takes the stream recorder and the
    fused one-shot; ``xla`` pins the scatter recorder."""
    B, dim = 8, 3
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))
    auto = pf.ZigZag(dim, lambda x: x)
    pf.sample_skeleton(auto, 40, x0, v0, seed=0, dtype=jnp.float32)
    assert any(k[0] == "stream_one_shot" for k in auto._jit_cache)
    plain = pf.ZigZag(dim, lambda x: x)
    pf.sample_skeleton(plain, 40, x0, v0, seed=0, dtype=jnp.float32,
                       backend="xla")
    assert [k[0] for k in plain._jit_cache] == ["fixed"]


def test_device_bytes_budget_gpu_bytes_limit(monkeypatch):
    monkeypatch.delenv("PDMPFLUX_DEVICE_BYTES", raising=False)
    dev = _FakeDevice("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 0})
    monkeypatch.setattr(api.jax, "devices", lambda: [dev])
    assert api._device_bytes_budget() == int((60 << 30) * 0.6)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_device_bytes_budget_gpu_without_limit_raises(monkeypatch, stats):
    monkeypatch.delenv("PDMPFLUX_DEVICE_BYTES", raising=False)
    monkeypatch.setattr(api.jax, "devices",
                        lambda: [_FakeDevice("gpu", stats)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        api._device_bytes_budget()


def test_persistent_cache_uses_env_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads env


def test_persistent_cache_defaults_to_checkout(monkeypatch):
    import pathlib

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = profiling.enable_persistent_cache()
        checkout = pathlib.Path(__file__).resolve().parents[1]
        assert path == str(checkout / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for val in eqn.params.values():
            for sub in val if isinstance(val, (tuple, list)) else (val,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dot_generals(inner)


def _assert_highest(closed_jaxpr):
    dots = list(_dot_generals(closed_jaxpr.jaxpr))
    assert dots, "expected at least one dot_general"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    for eqn in dots:
        assert eqn.params["precision"] == highest, eqn


@pytest.mark.parametrize("make", [
    lambda d: pf.BPS(d, lambda x: x),
    lambda d: pf.Boomerang(d, lambda x: x),
    lambda d: pf.ForwardECMC(d, lambda x: x),
], ids=["bps", "boomerang", "ecmc"])
def test_rate_dots_request_highest_precision(make):
    """Every dot_general of the vmapped transition (rate, envelope jvp and
    velocity jump) asks for HIGHEST, so a GPU keeps them off TF32."""
    d, B = 4, 3
    sampler = make(d)
    state = sampler.init_state_batch(np.zeros((B, d)), np.ones((B, d)), 0,
                                     jnp.float32)
    _assert_highest(jax.make_jaxpr(
        jax.vmap(engine.make_transition(sampler)))(state))


def test_fold_contractions_request_highest_precision():
    B, W, G, d, n_samples, n_batches = 2, 8, 4, 3, 16, 4
    sampler = pf.ZigZag(d, lambda x: x)
    fold = streaming.make_fold_chunk(sampler, W, G, n_samples, n_batches, 4,
                                     0.5, np.zeros(d, np.float32))
    stats = streaming.empty_stats(B, d, n_batches, jnp.float32)
    stream = engine.empty_stream(W, d, jnp.float32, B)
    anchor = (jnp.zeros(B), jnp.zeros((B, d)), jnp.ones((B, d)),
              jnp.ones((B, d), bool))
    j = jnp.zeros(B, jnp.int32)
    _assert_highest(jax.make_jaxpr(fold)(stats, stream, anchor, W, j, j + G))
