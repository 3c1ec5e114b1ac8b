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
from functools import lru_cache

import numpy as np
import torch

from ..config import IDGParams
from ..types import Observation
from ..utils import trace
from .common import MAX_W_RANK, max_mu_n, stage, uniform_channel_spacing
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


def required_w_rank(params: IDGParams, obs: Observation,
                    tol: float = W_TAYLOR_TOL) -> int | None:
    """Smallest Taylor rank r with truncation bound |μ·n|^r / r! < tol, or
    None when no rank ≤ MAX_W_RANK suffices."""
    return _rank_for_bound(max_mu_n(params, obs), tol)


def _rank_for_bound(x: float, tol: float = W_TAYLOR_TOL) -> int | None:
    for r in range(1, MAX_W_RANK + 1):
        if x ** r / math.factorial(r) < tol:
            return r
    return None


class Resolved(tuple):
    """What `_resolve` returns: the pair (version, w_rank), and as `mu_n`
    the |μ·n| bound the guard computed for it, inf where it computed none
    (no kernel that takes no rank reads one), for the staging
    (ops/common.py:stage)."""

    def __new__(cls, version: str, w_rank, mu_n: float = math.inf):
        out = super().__new__(cls, (version, w_rank))
        out.mu_n = mu_n
        return out


@lru_cache(maxsize=None)
def _accepts(workload: str, version: str, param: str) -> bool:
    return param in inspect.signature(get_kernel(workload, version).fn).parameters


# the warnings' stacklevel counts the span's frame: they name the caller's caller
@trace.span("idg.stage.resolve")
def _resolve(workload: str, version: str, params: IDGParams,
             obs: Observation, w_rank=None):
    """Apply the API-boundary correctness guards; returns (version, w_rank),
    w_rank None meaning the kernel's default rank (or no rank, for a kernel
    that takes none), as a `Resolved` that also carries the guard's |μ·n|
    bound. The semantics of idg_tpu/ops/api.py:_resolve:

    1. A channel-recurrence kernel assumes uniform wavenumber spacing; on
       non-uniform input it falls back, with a warning, to its registered
       non-recurrence rung.
    2. A kernel that takes a Taylor rank of the w·n term gets the rank the
       observation's w range needs, and raises past MAX_W_RANK, pointing to
       the direct full-phase kernel. A fixed-rank w-free rung falls back to
       its registered rung when its rank is short. A direct kernel is exact
       in w: the required rank is not computed for it at all.

    An explicit w_rank is an override (benchmark knob), with a warning when
    it is below the required rank, or when the kernel takes no rank.

    Where it computes the required rank, it keeps the |μ·n| bound that rank
    came from under `idg.w_mu_n.<workload>` (utils/trace.py:keep_bound).
    """
    entry = get_kernel(workload, version)
    if entry.uniform_channels and not uniform_channel_spacing(obs.wavenumbers):
        if entry.fallback is None:
            raise ValueError(
                f"{workload} {version} assumes uniform channel spacing and the "
                "observation's wavenumbers are non-uniform; no fallback is "
                "registered — pick a non-recurrence version"
            )
        warnings.warn(
            f"{workload} {version} assumes uniform channel spacing; "
            f"wavenumbers are non-uniform — falling back to {entry.fallback}",
            stacklevel=4,
        )
        version = entry.fallback
        entry = get_kernel(workload, version)

    takes_rank = _accepts(workload, version, "w_rank")
    # a host pass over the observation's w values; the direct kernels never read it
    need, bound = None, math.inf
    if takes_rank or entry.fixed_w_rank is not None:
        bound = max_mu_n(params, obs)
        trace.keep_bound(f"idg.w_mu_n.{workload}", bound)
        need = _rank_for_bound(bound)
    if w_rank is not None:
        if takes_rank:
            if need is not None and w_rank < need:
                warnings.warn(
                    f"w_rank={w_rank} override is below the required rank {need} "
                    f"for this observation's w range (|mu*n| bound exceeds "
                    f"{W_TAYLOR_TOL:g}); results may miss the 1e-5 gate",
                    stacklevel=4,
                )
            return Resolved(version, w_rank, bound)
        warnings.warn(
            f"{workload} {version} takes no w_rank"
            + (f" (fixed w-term rank {entry.fixed_w_rank})" if entry.fixed_w_rank else "")
            + f"; the w_rank={w_rank} override is ignored",
            stacklevel=4,
        )
    if takes_rank:
        if need is None:
            raise ValueError(
                f"{workload} {version}: the observation's w range puts |mu*n| "
                f"beyond rank-{MAX_W_RANK} Taylor accuracy; use a direct "
                "full-phase kernel (cuda_v1 / torch_v2)"
            )
        default = inspect.signature(entry.fn).parameters["w_rank"].default
        return Resolved(version, need if need > default else None, bound)
    if entry.fixed_w_rank is not None and (need is None or need > entry.fixed_w_rank):
        if need is None or entry.fallback is None:
            # past MAX_W_RANK no low-rank rung meets the gate, and with no
            # fallback there is nothing to escalate to
            raise ValueError(
                f"{workload} {version} is a rank-{entry.fixed_w_rank} w-free "
                "specialization but the observation's w range needs "
                + (f"Taylor rank {need}; no fallback is registered — " if need is not None
                   else f"more than rank-{MAX_W_RANK} Taylor accuracy; ")
                + "use a direct full-phase kernel (cuda_v1 / torch_v2)"
            )
        warnings.warn(
            f"{workload} {version} is a rank-{entry.fixed_w_rank} w-free "
            f"specialization but the observation needs Taylor rank {need} — "
            f"falling back to {entry.fallback}",
            stacklevel=4,
        )
        return Resolved(entry.fallback,
                        need if _accepts(workload, entry.fallback, "w_rank") else None, bound)
    return Resolved(version, None, bound)


def _rank_args(workload: str, version: str, w_rank) -> tuple:
    """The rank argument of a kernel call: (rank,) for a kernel that takes a
    w_rank (its default when w_rank is None), () for one that takes none
    (the direct and the fixed-rank kernels)."""
    if not _accepts(workload, version, "w_rank"):
        return ()
    fn = get_kernel(workload, version).fn
    return (w_rank or inspect.signature(fn).parameters["w_rank"].default,)


def run_gridder(params: IDGParams, obs: Observation, version: str = "cuda_v6",
                w_rank=None, device="cuda") -> torch.Tensor:
    """Run a gridder kernel on `device`; returns c64[S, P, N, N] there."""
    dev = resolve_device(device)
    version, w_rank = resolved = _resolve("gridder", version, params, obs, w_rank)
    stg = stage(params, obs, dev, mu_n_bound=resolved.mu_n)
    fn = get_kernel("gridder", version).fn
    return fn(params, stg, *_rank_args("gridder", version, w_rank))


def run_degridder(params: IDGParams, obs: Observation, subgrids,
                  version: str = "cuda_v7", w_rank=None, device="cuda") -> torch.Tensor:
    """Run a degridder kernel on `device`; returns c64[S, T, C, P] there."""
    dev = resolve_device(device)
    version, w_rank = resolved = _resolve("degridder", version, params, obs, w_rank)
    stg = stage(params, obs, dev, with_vis=False, mu_n_bound=resolved.mu_n)
    sub = torch.as_tensor(np.ascontiguousarray(subgrids, np.complex64), device=dev)
    fn = get_kernel("degridder", version).fn
    return fn(params, stg, sub, *_rank_args("degridder", version, w_rank))


def staged_runner(workload: str, version: str, params: IDGParams, obs: Observation,
                  subgrids=None, w_rank=None, device="cuda"):
    """For benchmarking: returns (fn, args) with the inputs staged on the
    device once, so `fn(*args)` is one bare kernel launch (the reference
    times launches on pre-staged device buffers the same way,
    app/CUDA/util.cpp:109-126). The API guards apply here too."""
    dev = resolve_device(device)
    version, w_rank = resolved = _resolve(workload, version, params, obs, w_rank)
    fn = get_kernel(workload, version).fn
    rank = _rank_args(workload, version, w_rank)
    if workload == "gridder":
        return fn, (params, stage(params, obs, dev, mu_n_bound=resolved.mu_n), *rank)
    # the degridder has no visibility input: leave the 1.6 GB behind
    stg = stage(params, obs, dev, with_vis=False, mu_n_bound=resolved.mu_n)
    sub = torch.as_tensor(np.ascontiguousarray(subgrids, np.complex64), device=dev)
    return fn, (params, stg, sub, *rank)


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
    grid-add consumer, `subgrids_to_grid_ranges` on the pieces: K4 on
    dense and sparse plans alike (ops/grid.py:ranges_route). `obs_sorted`
    must be block-sorted
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
    version, w_rank = resolved = _resolve("gridder", version, params, obs, w_rank)
    if version not in PIECES_GRIDDERS:
        return None, None, version
    oyx_dev = torch.as_tensor(np.asarray(oyx, np.int32), device=dev)
    rank = _rank_args("gridder", version, w_rank)
    stg = stage(params, obs, dev, mu_n_bound=resolved.mu_n)
    return gridder_cuda_v6_pieces, (params, stg, oyx_dev, *rank), version


def staged_degridder_consumer(params: IDGParams, obs: Observation,
                              version: str = "cuda_v7", w_rank=None, device="cuda"):
    """For the pipeline: returns (fn, resolved_version), where fn(subgrids)
    degrids c64[S, P, N, N] uv subgrids produced on the device (e.g. by
    the grid extraction). The observation is staged once, vis-free."""
    dev = resolve_device(device)
    version, w_rank = resolved = _resolve("degridder", version, params, obs, w_rank)
    kernel = get_kernel("degridder", version).fn
    rank = _rank_args("degridder", version, w_rank)
    stg = stage(params, obs, dev, with_vis=False, mu_n_bound=resolved.mu_n)
    return (lambda sub: kernel(params, stg, sub, *rank)), version


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
    version, w_rank = resolved = _resolve("degridder", version, params, obs, w_rank)
    if version not in FUSED_DEGRIDDERS:
        return None, None, version
    kernel = get_kernel("degridder", version).fn
    rank = _rank_args("degridder", version, w_rank)
    stg = stage(params, obs, dev, with_vis=False, mu_n_bound=resolved.mu_n)
    oyx_dev = torch.as_tensor(np.asarray(oyx, np.int32), device=dev)

    def consumer(pieces):
        return kernel(params, stg, pieces, *rank, fuse_oyx=oyx_dev)

    return [consumer], [(0, stg.nr_subgrids)], version
