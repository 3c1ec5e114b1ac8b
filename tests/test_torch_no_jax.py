"""The port imports neither JAX nor the JAX package: every module of
idg_tpu_torch (parallel/ and native/ included) and chip_smoke.py's module
level import in a fresh interpreter where `jax` and `idg_tpu` cannot be
imported."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None        # any `import jax...` now raises ImportError
sys.modules["idg_tpu"] = None
import idg_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(idg_tpu_torch.__path__, "idg_tpu_torch.")
               if not m.name.endswith("__main__"))   # the CLI's entry runs on import
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
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
