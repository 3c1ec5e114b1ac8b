"""The port imports neither JAX nor the JAX package: every module of
idg_tpu_torch (parallel/ and native/ included) imports, and the port's
scripts trace_tools_cuda.py and results_table_cuda.py run, in a fresh
interpreter where `jax` and `idg_tpu` cannot be imported."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any `import jax...` now raises ImportError
sys.modules["idg_tpu"] = None
import idg_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(idg_tpu_torch.__path__, "idg_tpu_torch.")
               if not m.name.endswith("__main__"))   # the CLI's entry runs on import
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if sys.modules[m] is not None and m.split(".")[0] in ("jax", "jaxlib", "idg_tpu"))
print(" ".join(names))
print(leaked)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    names, leaked = out.stdout.strip().splitlines()
    assert leaked == "[]"
    names = names.split()
    for module in ("idg_tpu_torch.cli", "idg_tpu_torch.parallel.parity",
                   "idg_tpu_torch.parallel.sharded", "idg_tpu_torch.native",
                   "idg_tpu_torch.ops.cuda.gridder", "idg_tpu_torch.ops.torch_ladder.gridder"):
        assert module in names


SCRIPT_PROBE = r"""
import runpy, sys
sys.modules["jax"] = None        # any `import jax...` now raises ImportError
sys.modules["idg_tpu"] = None
sys.argv = sys.argv[1:]
code = 0
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as exc:
    code = exc.code
leaked = sorted(m for m in sys.modules
                if sys.modules[m] is not None and m.split(".")[0] in ("jax", "jaxlib", "idg_tpu"))
print(code, leaked)
"""


@pytest.mark.parametrize("script", ["trace_tools_cuda.py", "results_table_cuda.py"])
def test_port_scripts_import_no_jax(script, tmp_path):
    """The port's trace reader and CSV renderer run, on real input, where
    `jax` and `idg_tpu` cannot be imported."""
    trace = tmp_path / "1-r0-0-fn.pt.trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void gridder_kernel<32, true>(float const*)",
         "pid": 0, "tid": 7, "ts": 0.0, "dur": 5.0, "args": {"device": 0, "stream": 7}}]}))
    (tmp_path / "NVIDIA-H100-80GB-HBM3-vadd_cuda-cuda.csv").write_text("ms,1.04\n")
    args = {"trace_tools_cuda.py": [str(trace), "--json"],
            "results_table_cuda.py": ["--dir", str(tmp_path)]}[script]
    out = subprocess.run([sys.executable, "-c", SCRIPT_PROBE, str(ROOT / "scripts" / script),
                          *args], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    *shown, last = out.stdout.strip().splitlines()
    assert last == "0 []"
    assert ("gridder_kernel" if script.startswith("trace") else "vadd_cuda") in "".join(shown)
