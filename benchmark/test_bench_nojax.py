"""In a fresh interpreter where jax, jaxlib, flax and idg_tpu cannot be
imported (top-level names compared whole: idg_tpu_torch stays
importable), every benchmark module imports and a tiny run completes with
no banned module loaded; the command line refuses to run without a card
or without the program."""

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib.abc, sys
BANNED = {"jax", "jaxlib", "flax", "idg_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
import pathlib
for f in sorted(pathlib.Path(ROOT, "benchmark").glob("*.py")):
    if not f.name.startswith(("test_", "conftest")) and f.stem != "run":
        importlib.import_module("benchmark." + f.stem)
from benchmark import harness
from benchmark.conftest import tiny_cell
res = harness.run("default.grid", 9, 0.05, False, device="cpu",
                  cell=tiny_cell("default.grid"), log=lambda line: None)
assert res["correct"], res
assert harness.banned_modules() == [], harness.banned_modules()
assert "idg_tpu_torch" in sys.modules
print("OK", sorted({m.split(".")[0] for m in sys.modules} & BANNED))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_fresh_interpreter_without_jax():
    out = subprocess.run([sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + PROBE],
                         capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK []"


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "default.grid",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    if out.returncode == 0:   # a host with a card runs the cell instead
        return
    assert out.returncode == 3 and out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "default.grid",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, env=_env(), timeout=300)
    assert out.returncode != 0 and out.stdout == ""
