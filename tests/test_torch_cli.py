"""The port's command line and import hygiene, in fresh processes."""

import os
import pathlib
import subprocess
import sys
import warnings

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
    listed = {tuple(line.split()[:2]) for line in out.stdout.splitlines()}
    separable = ("cuda_v3", "cuda_v4", "cuda_v5")
    for workload, versions in (("gridder", ("cuda_v1", "cuda_v2", *separable, "cuda_v6",
                                            "cuda_v7")),
                               ("degridder", ("cuda_v1", "cuda_v2", *separable, "cuda_v6",
                                              "cuda_v7", "cuda_v8"))):
        assert {(workload, v) for v in versions} <= listed


def test_info_names_the_versions():
    out = _run("info")
    assert out.returncode == 0, out.stderr
    lines = {line.split("==")[0].strip(): line.split("==")[1] for line in out.stdout.splitlines()
             if " versions" in line}
    for workload in ("gridder", "degridder"):
        assert {"cuda_v3", "cuda_v4", "cuda_v5"} <= set(lines[f"{workload} versions"].replace(
            ",", " ").split())


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
            "idg_tpu_torch.ops.cuda, idg_tpu_torch.ops.torch_ladder, idg_tpu_torch.utils.timing; "
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


@pytest.mark.parametrize("direction", ["to-grid", "to-subgrids"])
def test_grid_without_card_fails_clearly(direction):
    """The grid command times the card: without one it exits 2 before any work."""
    probe = _run(code="import torch; print(torch.cuda.is_available())")
    if probe.stdout.strip() != "False":
        pytest.skip("a CUDA device is visible here")
    out = _run("grid", "--direction", direction, "--method", "pallas", "--device", "cuda")
    assert out.returncode == 2
    assert "no CUDA device is visible" in out.stderr
    assert "grid-add plan" not in out.stdout


@pytest.mark.parametrize("command", [("vadd",), ("vadd", "--cuda"),
                                     ("sweep", "--mode", "check", "--device", "cuda")])
def test_vadd_and_sweep_without_card_fail_clearly(command):
    """`vadd` times the card and a sweep on the card is no version's failure:
    both exit 2 before any work."""
    probe = _run(code="import torch; print(torch.cuda.is_available())")
    if probe.stdout.strip() != "False":
        pytest.skip("a CUDA device is visible here")
    out = _run(*command)
    assert out.returncode == 2
    assert "no CUDA device is visible" in out.stderr
    assert "===" not in out.stdout and "vadd" not in out.stdout


@pytest.mark.parametrize("workload,version,w_obs,suffix,name,fell_back", [
    ("gridder", "cuda_v1", False, "", "gridder_cuda_v1", False),
    ("gridder", "cuda_v7", False, "_x", "gridder_cuda_v7_x", False),
    ("gridder", "cuda_v7", True, "_x", "gridder_cuda_v4_fb_x_wobs", True),
    ("degridder", "cuda_v8", True, "", "degridder_cuda_v4_fb_wobs", True),
    ("gridder", "cuda_v5", False, "", "gridder_cuda_v5", False),
    ("degridder", "cuda_v5", True, "", "degridder_cuda_v5_wobs", False),
    ("degridder", "cuda_v2", True, "", "degridder_cuda_v2_wobs", False),
])
def test_perf_name_is_the_resolved_version(workload, version, w_obs, suffix, name, fell_back):
    """Perf mode resolves once, on the host, before staging, and names the
    CSV after the kernel it times: a fallback carries `_fb`, then the suffix
    and `_wobs` (idg_tpu/cli.py:171-173)."""
    from idg_tpu_torch import cli
    from idg_tpu_torch.config import IDGParams

    params = IDGParams(grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
                       nr_timesteps_subgrid=16, nr_channels=8)
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        got_params, obs, sub, rversion, rank, got = cli._perf_problem(
            workload, version, params=params, name_suffix=suffix, w_obs=w_obs)
    assert got == name
    assert (rversion != version) == fell_back
    assert any("w-free" in str(w.message) for w in record) == fell_back
    assert (rank is not None and rank > 1) == fell_back
    assert (got_params.w_step != 0.0) == w_obs
    assert (sub is not None) == (workload == "degridder")


def test_grid_rejects_the_cpu_and_unknown_methods():
    out = _run("grid", "--device", "cpu")
    assert out.returncode != 0
    assert "needs --device cuda" in out.stderr
    out = _run("grid", "--method", "rows")
    assert out.returncode == 2
    assert "invalid choice" in out.stderr
