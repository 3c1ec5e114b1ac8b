"""scripts/validate_cuda.py, the port's validation sweep, on the CPU: with
--device cpu the rungs run their plain PyTorch versions (on the card, the
kernels), and the table it writes has a PASSED row for each rung at w = 0
and w ≠ 0, the grid-stage rows and the fused rows; its grid stage passes at
256² too; a FAILED row stays in the table and makes the exit code 1; and
without a card --device cuda exits 2 before any row."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from idg_tpu_torch.config import IDGParams

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "validate_cuda.py"


def _script():
    spec = importlib.util.spec_from_file_location("validate_cuda", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(*args):
    return subprocess.run([sys.executable, str(SCRIPT), *args], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=300)


def _table_rows(text, columns):
    return [line for line in text.splitlines()
            if line.startswith("| ") and line.count("|") == columns + 1
            and not line.startswith(("| workload", "| comparison", "| composition"))]


def test_cpu_table_is_well_formed(tmp_path):
    out_md = tmp_path / "VALIDATION.md"
    out = _run("--device", "cpu", "--versions", "torch_v2,cuda_v6", "--out", str(out_md))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    text = out_md.read_text()
    assert text.startswith("# Hardware validation of the PyTorch/CUDA port")
    assert f"torch {torch.__version__}" in text
    rungs = _table_rows(text, 5)
    # both workloads' torch_v2 and cuda_v6, at w = 0 and at w != 0
    assert len(rungs) == 8
    assert {tuple(c.strip() for c in r.strip("|").split("|")[:3]) for r in rungs} == {
        (w, v, v) for w in ("gridder", "degridder") for v in ("torch_v2", "cuda_v6")}
    others = _table_rows(text, 3)
    assert len(others) == 5                     # three grid-stage rows, two fused
    assert any("K7" in r for r in others)       # 512², sparse: the merged grid-add
    assert all("| PASSED |" in r for r in rungs + others)
    assert "streamed extraction" in text and "## Mesh path" in text


def test_grid_stage_section_passes_at_256():
    rows = _script().grid_stage_section(
        "cpu", IDGParams(grid_size=256, nr_stations=14),
        IDGParams(grid_size=256, nr_stations=3, nr_timeslots=2))
    assert len(rows) == 3
    assert all("| PASSED |" in r for r in rows), rows


def test_failed_row_stays_and_exits_1(tmp_path, monkeypatch):
    module = _script()
    bad = "| gridder | torch_v2 | torch_v2 | FAILED | 2.000e-05 |"
    monkeypatch.setattr(module, "run_section", lambda *a, **kw: [bad])
    monkeypatch.setattr(module, "grid_stage_section", lambda *a, **kw: [])
    monkeypatch.setattr(module, "fused_section", lambda *a, **kw: [])
    out_md = tmp_path / "V.md"
    assert module.main(["--device", "cpu", "--out", str(out_md)]) == 1
    assert out_md.read_text().count(bad) == 2
    assert module.failed([bad, "| a | PASSED | 0 |", "| b | ERROR | x |"]) == [
        bad, "| b | ERROR | x |"]


def test_without_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    out_md = tmp_path / "V.md"
    out = _run("--device", "cuda", "--out", str(out_md))
    assert out.returncode == 2
    assert "no CUDA device is visible" in out.stderr
    assert not out_md.exists()
