"""Test configuration: CPU backend with 8 virtual devices + float64.

Mirrors the reference's quick/extended tiers (``test/runtests.jl:8-19``) via
pytest markers, and adds what the reference lacks: multi-device sharding
tests on a fake CPU mesh (``--xla_force_host_platform_device_count``, the
standard JAX trick — see SURVEY.md §4).

The suite runs on CPU unless ``JAX_PLATFORMS`` names another platform: the
``gpu``-marked tests run on a card with ``JAX_PLATFORMS=cuda python -m
pytest tests -m gpu`` and skip elsewhere (decided in the ``gpu_device``
fixture, never at import).
"""

import dataclasses
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from pdmpflux_tpu.core import capability  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "extended: long-running statistical tests")


@pytest.fixture
def stream_path(monkeypatch):
    """Route ``backend="auto"`` through the stream recorder on CPU (the CPU
    record with the GPU's recorder; fills keep the CPU's fixed geometry)."""
    path = dataclasses.replace(capability.CPU_PATH, recorder="stream")
    monkeypatch.setattr(capability, "resolve", lambda: path)
    return path


@pytest.fixture
def gpu_path(monkeypatch):
    """Run the exact GPU execution record (stream recorder, fused one-shot,
    adaptive fills) on the CPU backend."""
    monkeypatch.setattr(capability, "resolve", lambda: capability.GPU_PATH)
    return capability.GPU_PATH


@pytest.fixture
def gpu_device():
    """The default device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device is {dev.platform})")
    return dev
