"""Build the CUDA kernels of ``idg_tpu_torch/csrc`` and bind them with ctypes.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds).
The library lands in ``idg_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources and flags, and is built at first use. Every entry point
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
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# pointer args, integer args, then the stream, per entry point (the
# occupancy query: N, then the int it writes)
SIGNATURES = {
    "idg_gridder_v6": [_P] * 15 + [_I] * 7 + [_P],
    "idg_gridder_v6_pieces": [_P] * 18 + [_I] * 7 + [_P],
    "idg_degridder_v7": [_P] * 15 + [_I] * 6 + [_P],
    "idg_degridder_v7_fused": [_P] * 18 + [_I] * 6 + [_P],
    "idg_grid_add": [_P] * 4 + [_I] * 4 + [_P],
    "idg_grid_add_occupancy": [_I, _P],
    "idg_grid_extract": [_P] * 4 + [_I] * 3 + [_P],
    "idg_grid_add_pieces": [_P] * 5 + [_I] * 5 + [_P],
    "idg_grid_add_merged": [_P] * 6 + [_I] * 7 + [_P],
    "idg_grid_add_scatter": [_P] * 3 + [_I] * 4 + [_P],
    "idg_grid_add_slots": [_P] * 3 + [_I] * 6 + [_P],
    "idg_gridder_direct": [_P] * 15 + [_I] * 6 + [_P],
    "idg_degridder_direct": [_P] * 15 + [_I] * 6 + [_P],
    "idg_vadd": [_P] * 3 + [_L] + [_P],
    "idg_gridder_separable": [_P] * 15 + [_I] * 7 + [_P],
    "idg_degridder_separable": [_P] * 15 + [_I] * 7 + [_P],
    "idg_degridder_polstack": [_P] * 15 + [_I] * 6 + [_P],
    "idg_phasor_check": [_P, ctypes.c_uint, _L] + [_P] * 4,
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
    nvcc = _nvcc()
    # build in a private directory and rename the library into place, so a
    # concurrent process never loads a half-written one
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(work, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [proc.returncode for proc in procs if proc.returncode != 0]
        if not failed:
            tmp = os.path.join(work, lib.name)
            link = subprocess.run(
                [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs],
                capture_output=True, text=True)
            build_log += link.stdout + link.stderr
            failed = [link.returncode] if link.returncode != 0 else []
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
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
