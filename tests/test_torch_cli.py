"""The port's command line and import hygiene, in fresh processes."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args, code=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, *(("-c", code) if code else ("-m", "idg_tpu_torch", *args))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_check_mode_on_cpu_passes(workload):
    """Correctness mode at the reference's correctness defaults, through the
    plain PyTorch versions."""
    out = _run("run", "--workload", workload, "--mode", "check", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert ">>> Result PASSED" in out.stdout


def test_list_names_the_kernels():
    out = _run("list")
    assert out.returncode == 0, out.stderr
    assert "cuda_v6" in out.stdout and "cuda_v7" in out.stdout


def test_cuda_device_without_card_fails_clearly():
    """No path falls back to the CPU when the card is missing."""
    probe = _run(code="import torch; print(torch.cuda.is_available())")
    if probe.stdout.strip() != "False":
        pytest.skip("a CUDA device is visible here")
    out = _run("run", "--workload", "gridder", "--mode", "check", "--device", "cuda")
    assert out.returncode != 0
    assert "no CUDA device is visible" in out.stderr
    assert ">>> Result" not in out.stdout


def test_port_imports_no_jax():
    code = ("import sys, idg_tpu_torch, idg_tpu_torch.cli, idg_tpu_torch.bench, "
            "idg_tpu_torch.ops.api, idg_tpu_torch.ops.registry, idg_tpu_torch.ops.grid, "
            "idg_tpu_torch.ops.cuda; "
            "idg_tpu_torch.ops.registry.list_kernels(); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'idg_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = _run(code=code)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_pipeline_without_card_fails_clearly(direction):
    """The pipeline times the card: without one it exits 2 before any work."""
    probe = _run(code="import torch; print(torch.cuda.is_available())")
    if probe.stdout.strip() != "False":
        pytest.skip("a CUDA device is visible here")
    out = _run("pipeline", "--direction", direction, "--device", "cuda")
    assert out.returncode == 2
    assert "no CUDA device is visible" in out.stderr
    assert "stage split" not in out.stdout


def test_pipeline_rejects_the_cpu():
    out = _run("pipeline", "--direction", "grid", "--device", "cpu")
    assert out.returncode != 0
    assert "needs --device cuda" in out.stderr
    assert "stage split" not in out.stdout
