"""Public kernel-run API: correctness guards, staging and the perf runner.

The counterpart of the part of ``idg_tpu/ops/api.py`` the gridder and
degridder main path and the gridded and degrid pipelines use. Tests, the
CLI and the benchmark all go through here. Observations come in on the host (numpy fields); results leave as
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
    "MAX_W_RANK", "W_TAYLOR_TOL", "DeviceUnavailable", "gridded_pipeline_parts",
    "max_mu_n", "required_w_rank", "resolve_device", "run_degridder", "run_gridder",
    "staged_degridder_consumer", "staged_degridder_pieces_chunk_consumers",
    "staged_gridder_pieces_runner", "staged_runner",
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


# The gridder versions with a fused grid-stage epilogue
# (gridder_cuda_v6_pieces), and the degridder versions with a fused prologue
# (`fuse_oyx`).
PIECES_GRIDDERS = ("cuda_v6",)
FUSED_DEGRIDDERS = ("cuda_v7",)


def gridded_pipeline_parts(params: IDGParams, obs_sorted: Observation,
                           version: str = "cuda_v6", w_rank=None, plan=None,
                           device="cuda"):
    """The fused gridded-pipeline recipe, one source for the `pipeline` CLI
    and the bench: the per-subgrid rolls from the block-sorted metadata,
    the pieces runner (gridder with the fused iDFT epilogue) and the range
    grid-add consumer, `subgrids_to_grid_ranges` on the pieces: K4 on the
    tile path, the masked pieces and K6 on sparse plans
    (ops/grid.py:ranges_route). `obs_sorted` must be block-sorted
    (ops/grid.py:sort_observation_blocks).

    Returns (pfn, pargs, gfn, resolved_version, plan): `gfn(pfn(*pargs))` is
    one pass, visibilities to a c64[P, G, G] grid. pfn, pargs and gfn are
    None when the resolved version has no fused form."""
    from .grid import plan_grid_add_ranges, roll_offsets, subgrids_to_grid_ranges

    g, n = params.grid_size, params.subgrid_size
    md = obs_sorted.metadata
    if plan is None:
        plan = plan_grid_add_ranges(md.coord_x, md.coord_y, g, n)
    oyx = roll_offsets(md.coord_x, md.coord_y, g, n)
    pfn, pargs, version = staged_gridder_pieces_runner(
        params, obs_sorted, version, oyx, w_rank=w_rank, device=device)
    if pfn is None:
        return None, None, None, version, plan
    dev = pargs[2].device
    cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device=dev)
              for c in (md.coord_x, md.coord_y))

    def gfn(pieces):
        return subgrids_to_grid_ranges(None, cx, cy, g, plan=plan, tiles=pieces)

    return pfn, pargs, gfn, version, plan


def staged_gridder_pieces_runner(params: IDGParams, obs: Observation, version: str,
                                 oyx, w_rank=None, device="cuda"):
    """staged_runner's gridder path with the grid stage's producer fused
    into the kernel epilogue: `fn(*args)` emits the block-rolled pieces
    c64[S, P, N, N] that the range grid-add reads. `oyx` is the host i32[S, 2]
    per-subgrid roll (ops/grid.py:roll_offsets). Returns (fn, args,
    resolved_version), or (None, None, version) when the resolved version
    has no fused form."""
    from .cuda.gridder import gridder_cuda_v6_pieces

    dev = resolve_device(device)
    version, w_rank = _resolve("gridder", version, params, obs, w_rank)
    if version not in PIECES_GRIDDERS:
        return None, None, version
    oyx_dev = torch.as_tensor(np.asarray(oyx, np.int32), device=dev)
    rank = _rank("gridder", version, w_rank)
    return gridder_cuda_v6_pieces, (params, stage(params, obs, dev), oyx_dev, rank), version


def staged_degridder_consumer(params: IDGParams, obs: Observation,
                              version: str = "cuda_v7", w_rank=None, device="cuda"):
    """For the pipeline: returns (fn, resolved_version), where fn(subgrids)
    degrids c64[S, P, N, N] uv subgrids produced on the device (e.g. by
    the grid extraction). The observation is staged once, vis-free."""
    dev = resolve_device(device)
    version, w_rank = _resolve("degridder", version, params, obs, w_rank)
    kernel = get_kernel("degridder", version).fn
    rank = _rank("degridder", version, w_rank)
    stg = stage(params, obs, dev, with_vis=False)
    return (lambda sub: kernel(params, stg, sub, rank)), version


def staged_degridder_pieces_chunk_consumers(params: IDGParams, obs: Observation,
                                            version: str = "cuda_v7", oyx=None,
                                            w_rank=None, device="cuda"):
    """The fused degrid recipe: returns (consumers, bounds, resolved_version)
    where consumers[i](pieces) degrids the range extraction's block-rolled
    pieces of subgrid rows bounds[i] = (lo, hi), running the forward DFT and
    the roll back inside the degridder kernel (its fused prologue). `oyx` is
    the host i32[S, 2] per-subgrid roll of the block-sorted metadata. There
    is one consumer over (0, S): the JAX package's per-chunk split is a TPU
    compile-size device. Returns (None, None, version) when the resolved
    version has no fused prologue."""
    dev = resolve_device(device)
    version, w_rank = _resolve("degridder", version, params, obs, w_rank)
    if version not in FUSED_DEGRIDDERS:
        return None, None, version
    kernel = get_kernel("degridder", version).fn
    rank = _rank("degridder", version, w_rank)
    stg = stage(params, obs, dev, with_vis=False)
    oyx_dev = torch.as_tensor(np.asarray(oyx, np.int32), device=dev)

    def consumer(pieces):
        return kernel(params, stg, pieces, rank, fuse_oyx=oyx_dev)

    return [consumer], [(0, stg.nr_subgrids)], version
