"""Build the CUDA kernels of ``idg_tpu_torch/csrc`` and bind them with ctypes.

All ``csrc/*.cu`` files compile with one ``nvcc`` call into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The library lands in ``idg_tpu_torch/_build/<hash>/``, keyed by a
hash of the sources and flags, and is built at first use. Every entry point
launches on the stream it is given and returns ``cudaGetLastError()``.

    CUDA_HOME   toolkit root holding bin/nvcc (default /usr/local/cuda)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "_build"

# sm_90a, not sm_90: the arch-specific target later PRs need for wgmma.
# No --use_fast_math: __sinf/__cosf lose accuracy as |arg| grows, and the
# phase arguments reach ~35 rad.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# pointer args, int args, then the stream, per entry point
SIGNATURES = {
    "idg_gridder_v6": [_P] * 15 + [_I] * 6 + [_P],
    "idg_degridder_v7": [_P] * 15 + [_I] * 6 + [_P],
}

_library = None
build_log = ""         # nvcc's output (ptxas register/spill report)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> pathlib.Path:
    """Compile the sources unless a library for this exact source hash
    exists; return its path. Raises with nvcc's output on failure."""
    global build_log
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libidg_kernels.so"
    if lib.exists():
        log = out_dir / "build.log"
        build_log = log.read_text() if log.exists() else ""
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename, so a concurrent process
    # never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    (out_dir / "build.log").write_text(build_log)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
