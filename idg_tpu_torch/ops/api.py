"""Public kernel-run API: correctness guards, staging and the perf runner.

The counterpart of the part of ``idg_tpu/ops/api.py`` the gridder and
degridder main path uses. Tests, the CLI and the benchmark all go through
here. Observations come in on the host (numpy fields); results leave as
complex64 tensors on the device they ran on.
"""

from __future__ import annotations

import inspect
import math
import warnings

import numpy as np
import torch

from ..config import IDGParams
from ..types import Observation
from .common import MAX_W_RANK, stage, uniform_channel_spacing
from .registry import get_kernel

# Comfortably inside the 1e-5 normalized-RMS comparator gate
# (tests/test_util.hpp:84).
W_TAYLOR_TOL = 3e-6

__all__ = [
    "MAX_W_RANK", "W_TAYLOR_TOL", "DeviceUnavailable", "max_mu_n",
    "required_w_rank", "resolve_device", "run_degridder", "run_gridder",
    "staged_runner",
]


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this host."""


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises DeviceUnavailable for CUDA on a
    host without a visible card (no path continues on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"device {device!r} requested but no CUDA device is visible "
            "(torch.cuda.is_available() is False); use --device cpu for the "
            "plain PyTorch path"
        )
    return dev


def max_mu_n(params: IDGParams, obs: Observation) -> float:
    """Host-side upper bound on |μ·n| = |(w_off − w·k)·n|, the argument of
    the kernels' rank-w Taylor of e^{iμ·n}, from per-subgrid w and k
    extremes (idg_tpu/ops/api.py:61 semantics)."""
    w = np.asarray(obs.uvw, np.float64)[..., 2].reshape(-1)
    k = np.asarray(obs.wavenumbers, np.float64)
    md = obs.metadata
    t = params.nr_timesteps_subgrid
    idx = np.asarray(md.time_offset, np.int64)[:, None] + np.arange(t)
    ws = w[idx]                                        # [S, T]
    w_lo, w_hi = ws.min(axis=1), ws.max(axis=1)        # [S]
    k_lo, k_hi = float(k.min()), float(k.max())
    wk = np.stack([w_lo * k_lo, w_lo * k_hi, w_hi * k_lo, w_hi * k_hi])
    wk_lo, wk_hi = wk.min(axis=0), wk.max(axis=0)      # [S]
    z = np.asarray(md.coord_z, np.float64)
    w_off = 2.0 * np.pi * float(params.w_step) * (z + 0.5)
    mu_abs = float(np.maximum(np.abs(w_off - wk_lo), np.abs(w_off - wk_hi)).max())
    # n_max over the subgrid (math.hpp:19-24 stable form), f64
    half = params.image_size / 2.0
    tmp = 2.0 * half * half  # l² + m² at the subgrid corner
    n_max = tmp / (1.0 + math.sqrt(max(0.0, 1.0 - tmp))) if tmp <= 1.0 else 1.0
    return float(mu_abs * n_max)


def required_w_rank(params: IDGParams, obs: Observation,
                    tol: float = W_TAYLOR_TOL) -> int | None:
    """Smallest Taylor rank r with truncation bound |μ·n|^r / r! < tol, or
    None when no rank ≤ MAX_W_RANK suffices."""
    x = max_mu_n(params, obs)
    for r in range(1, MAX_W_RANK + 1):
        if x ** r / math.factorial(r) < tol:
            return r
    return None


def _resolve(workload: str, version: str, params: IDGParams,
             obs: Observation, w_rank=None):
    """Apply the API-boundary correctness guards; returns (version, w_rank),
    w_rank None meaning the kernel's default rank.

    1. A channel-recurrence kernel assumes uniform wavenumber spacing; with
       no fallback rung ported yet, non-uniform input raises.
    2. The w·n Taylor rank escalates when the observation's w range needs
       it, and raises past MAX_W_RANK: no direct full-phase kernel is
       ported yet, and a kernel that misses the gate must not run.

    An explicit w_rank is an override (benchmark knob), with a warning when
    it is below the required rank.
    """
    entry = get_kernel(workload, version)
    if entry.uniform_channels and not uniform_channel_spacing(obs.wavenumbers):
        raise ValueError(
            f"{workload} {version} assumes uniform channel spacing and the "
            "observation's wavenumbers are non-uniform; no fallback is "
            "registered — pick a non-recurrence version"
        )
    default = inspect.signature(entry.fn).parameters["w_rank"].default
    need = required_w_rank(params, obs)
    if w_rank is not None:
        if need is not None and w_rank < need:
            warnings.warn(
                f"w_rank={w_rank} override is below the required rank {need} "
                f"for this observation's w range (|mu*n| bound exceeds "
                f"{W_TAYLOR_TOL:g}); results may miss the 1e-5 gate",
                stacklevel=3,
            )
        return version, w_rank
    if need is None:
        raise ValueError(
            f"{workload} {version}: the observation's w range puts |mu*n| "
            f"beyond rank-{MAX_W_RANK} Taylor accuracy; a direct full-phase "
            "kernel is needed and none is ported yet"
        )
    if need > default:
        return version, need
    return version, None


def _rank(workload: str, version: str, w_rank):
    fn = get_kernel(workload, version).fn
    return w_rank or inspect.signature(fn).parameters["w_rank"].default


def run_gridder(params: IDGParams, obs: Observation, version: str = "cuda_v6",
                w_rank=None, device="cuda") -> torch.Tensor:
    """Run a gridder kernel on `device`; returns c64[S, P, N, N] there."""
    dev = resolve_device(device)
    version, w_rank = _resolve("gridder", version, params, obs, w_rank)
    stg = stage(params, obs, dev)
    fn = get_kernel("gridder", version).fn
    return fn(params, stg, _rank("gridder", version, w_rank))


def run_degridder(params: IDGParams, obs: Observation, subgrids,
                  version: str = "cuda_v7", w_rank=None, device="cuda") -> torch.Tensor:
    """Run a degridder kernel on `device`; returns c64[S, T, C, P] there."""
    dev = resolve_device(device)
    version, w_rank = _resolve("degridder", version, params, obs, w_rank)
    stg = stage(params, obs, dev, with_vis=False)
    sub = torch.as_tensor(np.ascontiguousarray(subgrids, np.complex64), device=dev)
    fn = get_kernel("degridder", version).fn
    return fn(params, stg, sub, _rank("degridder", version, w_rank))


def staged_runner(workload: str, version: str, params: IDGParams, obs: Observation,
                  subgrids=None, w_rank=None, device="cuda"):
    """For benchmarking: returns (fn, args) with the inputs staged on the
    device once, so `fn(*args)` is one bare kernel launch (the reference
    times launches on pre-staged device buffers the same way,
    app/CUDA/util.cpp:109-126). The API guards apply here too."""
    dev = resolve_device(device)
    version, w_rank = _resolve(workload, version, params, obs, w_rank)
    fn = get_kernel(workload, version).fn
    rank = _rank(workload, version, w_rank)
    if workload == "gridder":
        return fn, (params, stage(params, obs, dev), rank)
    # the degridder has no visibility input: leave the 1.6 GB behind
    stg = stage(params, obs, dev, with_vis=False)
    sub = torch.as_tensor(np.ascontiguousarray(subgrids, np.complex64), device=dev)
    return fn, (params, stg, sub, rank)
