"""ctypes bindings for the port's native host runtime (idg_native.cpp).

The reference's host layer is C++ (init.cpp generators, OpenMP golden
kernels, comparator); this package builds the port's own copy of that
library and exposes NumPy-typed wrappers: the bulk glibc-rand stream
`NativeRand`, the OpenMP float64 oracles `gridder_reference_native` and
`degridder_reference_native`, and the comparator metric
`check_error_native`. Nothing here touches a device.

The library is built with g++ at first use (`load`) into
``idg_tpu_torch/_build/native-<hash>/``, keyed by a hash of the source and
the flags, as ``ops/cuda/build.py`` builds the CUDA kernels. Where g++ is
missing or the build fails, `available()` is False and callers keep the
pure-Python/NumPy paths (``crand.py``, ``models/reference.py``,
``utils/compare.py``), the fallback the JAX package keeps as well.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().with_name("idg_native.cpp")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[1] / "_build"
# The flags of idg_tpu/native/Makefile but -march=native: the library is
# built on the host that runs it, and a copied build directory must not
# carry one host's instruction set to another.
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-std=c++17", "-Wall", "-shared")

_lib: ctypes.CDLL | None = None


class _Problem(ctypes.Structure):
    _fields_ = [
        ("grid_size", ctypes.c_int32),
        ("subgrid_size", ctypes.c_int32),
        ("nr_timesteps", ctypes.c_int32),
        ("nr_channels", ctypes.c_int32),
        ("nr_correlations", ctypes.c_int32),
        ("image_size", ctypes.c_float),
        ("w_step", ctypes.c_float),
    ]


def build() -> pathlib.Path:
    """Compile the library unless one for this exact source and these flags
    exists; return its path. Raises RuntimeError when g++ is missing or
    fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / f"native-{digest.hexdigest()[:16]}"
    lib = out_dir / "libidg_native.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime is built with g++")
    out_dir.mkdir(parents=True, exist_ok=True)
    # build in a private directory and rename into place, so a concurrent
    # process never loads a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        tmp = os.path.join(work, lib.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.idg_rand_new.restype = ctypes.c_void_p
    lib.idg_rand_new.argtypes = [ctypes.c_uint32]
    lib.idg_rand_free.restype = None
    lib.idg_rand_free.argtypes = [ctypes.c_void_p]
    lib.idg_rand_fill.restype = None
    lib.idg_rand_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.idg_rand_uniform_fill.restype = None
    lib.idg_rand_uniform_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    oracle_args = [
        ctypes.POINTER(_Problem), ctypes.c_int64,
        f32, f32, f32, f32, f32,
        i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_int32, f32,
    ]
    for name in ("idg_gridder_reference", "idg_degridder_reference"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = oracle_args
    lib.idg_check_error.restype = ctypes.c_double
    lib.idg_check_error.argtypes = [f32, f32, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    """True when the library is built or can be built here (g++)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


class NativeRand:
    """glibc-rand stream backed by the native library (the same draw
    sequence as crand.CRand)."""

    def __init__(self, seed: int = 0):
        self._lib = load()
        self._handle = self._lib.idg_rand_new(seed & 0xFFFFFFFF)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.idg_rand_free(self._handle)
            self._handle = None

    def rand_array(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        self._lib.idg_rand_fill(self._handle, n, out)
        return out

    def uniform_array(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        self._lib.idg_rand_uniform_fill(self._handle, n, out)
        return out

    def rand(self) -> int:
        return int(self.rand_array(1)[0])

    def uniform(self) -> float:
        return float(self.uniform_array(1)[0])


def _problem(params) -> _Problem:
    return _Problem(
        params.grid_size, params.subgrid_size, params.nr_timesteps_subgrid,
        params.nr_channels, params.nr_correlations,
        params.image_size, params.w_step,
    )


def _interleave(c) -> np.ndarray:
    """complex64 array -> C-contiguous float32 view with trailing (re, im)."""
    c = np.ascontiguousarray(c, dtype=np.complex64)
    return c.view(np.float32).reshape(*c.shape, 2)


def _oracle_inputs(params, obs):
    """The observation's fields in the library's layouts and types, the
    arguments both oracles share after the problem and S."""
    md = obs.metadata
    return (
        np.ascontiguousarray(np.asarray(obs.uvw, np.float32).reshape(-1, 3)),
        np.ascontiguousarray(np.asarray(obs.wavenumbers, np.float32)),
    ), (
        np.ascontiguousarray(np.asarray(obs.spheroidal, np.float32)),
        np.ascontiguousarray(_interleave(obs.aterms)),
        *[np.ascontiguousarray(np.asarray(a, np.int32))
          for a in (md.time_offset, md.aterm_index, md.station1, md.station2,
                    md.coord_x, md.coord_y, md.coord_z)],
        np.asarray(obs.aterms).shape[1],
    )


def gridder_reference_native(params, obs) -> np.ndarray:
    """OpenMP golden gridder; the contract of models.reference.gridder_reference
    (an observation with host fields in, c128[S, P, N, N] out)."""
    lib = load()
    S = int(np.asarray(obs.metadata.time_offset).shape[0])
    N, P = params.subgrid_size, params.nr_correlations
    head, tail = _oracle_inputs(params, obs)
    vis = np.ascontiguousarray(_interleave(obs.visibilities).reshape(-1, params.nr_channels, P, 2))
    out = np.zeros((S, P, N, N, 2), dtype=np.float32)
    lib.idg_gridder_reference(ctypes.byref(_problem(params)), S, *head, vis, *tail, out)
    return out[..., 0] + 1j * out[..., 1]


def degridder_reference_native(params, obs, subgrids) -> np.ndarray:
    """OpenMP golden degridder; the contract of
    models.reference.degridder_reference (c128[S, T, C, P] out)."""
    lib = load()
    S = int(np.asarray(obs.metadata.time_offset).shape[0])
    T, C, P = params.nr_timesteps_subgrid, params.nr_channels, params.nr_correlations
    head, tail = _oracle_inputs(params, obs)
    sub = np.ascontiguousarray(_interleave(subgrids))
    out = np.zeros((S * T, C, P, 2), dtype=np.float32)
    lib.idg_degridder_reference(ctypes.byref(_problem(params)), S, *head, sub, *tail, out)
    return (out[..., 0] + 1j * out[..., 1]).reshape(S, T, C, P)


def check_error_native(cmp, ref) -> float:
    """The normalized-RMS comparator metric (utils/compare.py:check_error's
    mean_error), computed natively."""
    lib = load()
    a = _interleave(np.asarray(cmp).ravel())
    b = _interleave(np.asarray(ref).ravel())
    return float(lib.idg_check_error(a, b, a.shape[0]))


def crand_uniform_array(seed: int, n: int) -> np.ndarray:
    """One-shot bulk uniform draw of n values from seed."""
    return NativeRand(seed).uniform_array(n)
