"""``chip_smoke.py``: it refuses to run without a GPU, and its phase
functions pass at tiny sizes on CPU through the GPU execution record (the
``--four`` phase on four of the virtual CPU devices)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CARD = "cpu test run"


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_main_returns_nonzero_on_cpu(capsys):
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_phase_device_rejects_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="not a GPU"):
        chip_smoke.phase_device(CARD)


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert chip_smoke.card_info().startswith("nvidia-smi unavailable")


def test_moment_z_detects_bias():
    rng = np.random.default_rng(0)
    smp = rng.normal(size=(64, 200, 3))
    z_m, z_q = chip_smoke.moment_z(smp, 0.0, 1.0)
    assert z_m < chip_smoke.N_SE and z_q < chip_smoke.N_SE
    z_m, _ = chip_smoke.moment_z(smp + 0.1, 0.0, 1.0)
    assert z_m > chip_smoke.N_SE
    _, z_q = chip_smoke.moment_z(smp * 1.1, 0.0, 1.0)
    assert z_q > chip_smoke.N_SE


@pytest.mark.usefixtures("gpu_path")
def test_phase_flagship_tiny():
    out = chip_smoke.phase_flagship(CARD, B=16, n_sk=200)
    assert out["events_per_s"] > 0


@pytest.mark.usefixtures("gpu_path")
def test_phase_horizon_tiny():
    assert chip_smoke.phase_horizon(CARD, B=16, T=48.0)["events_per_s"] > 0


@pytest.mark.usefixtures("gpu_path")
def test_phase_families_tiny():
    out = chip_smoke.phase_families(CARD, scale=16)
    assert len(out) == 6


@pytest.mark.usefixtures("gpu_path")
def test_phase_large_state_tiny():
    chip_smoke.phase_large_state(CARD, B=4, n_sk=64, dim=24, T_stream=2.0)


@pytest.mark.usefixtures("gpu_path")
def test_phase_reference_tiny():
    out = chip_smoke.phase_reference(CARD, B=16, n_sk=120, B_large=4,
                                     dim_large=24)
    assert set(out) == {"flagship", "sticky_d24"}


@pytest.mark.usefixtures("gpu_path")
def test_phase_four_on_virtual_devices():
    assert chip_smoke.phase_four(CARD, B_per=16, n_sk=100)["speedup"] > 0
