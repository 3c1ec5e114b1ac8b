"""Subgrid-batch data parallelism and the grid collectives, per rank: the
counterpart of ``idg_tpu/parallel/sharded.py``.

Design (SURVEY.md §2.7): the subgrid axis is embarrassingly parallel (the
reference maps it to `blockIdx.x`). JAX shards it over a mesh under
`shard_map`; here each rank holds its rows of the padded subgrid axis, runs
the port's own single-device code on them and reduces with collectives:
psum → `all_reduce`, psum_scatter → `reduce_scatter_tensor`, all_gather →
`all_gather_into_tensor`, complex tensors through `view_as_real`. Every
builder returns a callable from the rank's local inputs to its local
outputs, tensors on the rank's device; `gather_rows` builds a global result
for checks.

Inputs. `shard_observation` keeps the rank's rows of the global observation
with the per-visibility arrays on the rank's device and the metadata on the
host, where the grid plans read it. The builders stage those rows on the
device inside the call (JAX's builders stage inside their jit), after
rebasing the time offsets to the rank's rows (`_localize_time_offset`).
`shard_staged_inputs` stages once, outside any timed window, and the
`*_staged` builders launch the kernel alone: `ops/api.py:staged_runner` on
the rank's rows.

Guard contract: the builders apply no API guard (resolution needs the
global observation, which they never see). Callers that take user-chosen
versions (`cli` run/sweep --mesh and scaling) resolve (version, w_rank)
through `ops/api.py:_resolve` on the global observation first and pass the
result down.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import IDGParams
from ..ops.api import PIECES_GRIDDERS, _rank_args
from ..ops.common import Staged, stage
from ..ops.grid import (grid_to_subgrids_ranges, plan_grid_add_ranges, roll_offsets,
                        sort_observation_blocks, subgrids_to_grid, subgrids_to_grid_ranges)
from ..ops.registry import get_kernel
from ..types import Observation
from .distributed import (_local_rows, _real, data_axes, distribute_observation,
                          distribute_subgrids, flat_axis_index, hierarchical_psum)
from .mesh import pad_axis0, pad_to_multiple


def _obs_specs() -> tuple[str, ...]:
    """The per-subgrid fields of an Observation besides the metadata, all of
    whose fields are per-subgrid: they split on axis 0 over the mesh, the
    rest (wavenumbers, spheroidal, aterms) is the same on every rank."""
    return ("uvw", "visibilities")


def _localize_time_offset(obs: Observation, params: IDGParams,
                          mesh: DeviceMesh) -> Observation:
    """Rebase global flat-time offsets to this rank's rows.

    time_offset indexes the flat (subgrid·T) axis of uvw/visibilities
    (types.Metadata); sharding splits that buffer, so the rank's first
    global row comes off. Valid because each subgrid's timesteps lie in its
    own rows (the in-tree layout, init.cpp:134-159)."""
    s_loc = obs.metadata.nr_subgrids
    start = flat_axis_index(mesh) * s_loc * params.nr_timesteps_subgrid
    md = obs.metadata
    md = dataclasses.replace(md, time_offset=np.asarray(md.time_offset) - start)
    return dataclasses.replace(obs, metadata=md)


def _pad_observation(params: IDGParams, metadata, n_dev: int):
    """(metadata padded to a multiple of n_dev rows, padded S). The padded
    rows take canonical time offsets (s·T) and zeros elsewhere. Only the
    metadata, which is small, is padded globally: the per-subgrid arrays
    are sliced per rank and only the tail shard is padded
    (`distributed.distribute_observation`)."""
    s = metadata.nr_subgrids
    s_pad = pad_to_multiple(s, n_dev)
    if s_pad == s:
        return metadata, s_pad
    offsets = np.asarray(metadata.time_offset)
    extra = np.arange(s, s_pad, dtype=offsets.dtype) * params.nr_timesteps_subgrid
    return type(metadata)(**{
        f.name: (np.concatenate([offsets, extra]) if f.name == "time_offset"
                 else pad_axis0(getattr(metadata, f.name), s_pad))
        for f in dataclasses.fields(metadata)
    }), s_pad


def _on_device(obs: Observation, device) -> Observation:
    """The observation's arrays on `device`, its metadata left on the host."""
    return dataclasses.replace(obs, **{
        name: torch.as_tensor(getattr(obs, name), device=device)
        for name in ("uvw", "wavenumbers", "visibilities", "spheroidal", "aterms")
    })


def shard_observation(params: IDGParams, obs: Observation, mesh: DeviceMesh,
                      device="cuda"):
    """This rank's rows of the global observation, padded to the mesh size,
    with its arrays on `device` (metadata on the host): (local, padded S)."""
    local, s_pad = distribute_observation(params, obs, mesh)
    return _on_device(local, device), s_pad


def shard_observation_block_sorted(params: IDGParams, obs: Observation,
                                   mesh: DeviceMesh, device="cuda"):
    """shard_observation with this rank's rows block-sorted by destination
    grid block, and their range plan for the 'ranges' grid stage:
    (local, padded S, ops/grid.py GridAddRangePlan). Each rank sorts its
    own segment (the metadata alone, as the `pipeline` command sorts; the
    time offsets follow their subgrids, so staging takes its gather path)
    and plans it on the host. The JAX package's mesh-global window `w`,
    which let one traced program serve every shard, has no counterpart."""
    local, s_pad = distribute_observation(params, obs, mesh)
    g, n = params.grid_size, params.subgrid_size
    local, _ = sort_observation_blocks(local, g, n)
    plan = plan_grid_add_ranges(local.metadata.coord_x, local.metadata.coord_y, g, n)
    return _on_device(local, device), s_pad, plan


def shard_staged_inputs(params: IDGParams, obs: Observation, mesh: DeviceMesh,
                        workload: str, subgrids=None, device="cuda"):
    """Stage this rank's rows once, on `device`, for the `*_staged`
    builders: (Staged, local subgrids c64[s_loc, P, N, N] or None), the
    input side of ops/api.py:staged_runner on the rank's rows. The
    degridder's staging leaves the visibilities behind."""
    local, s_pad = distribute_observation(params, obs, mesh)
    local = _localize_time_offset(local, params, mesh)
    stg = stage(params, local, device, with_vis=workload == "gridder")
    sub = None
    if subgrids is not None:
        sub = torch.as_tensor(distribute_subgrids(subgrids, mesh, s_pad), device=stg.device)
    return stg, sub


def _kernel_fn(workload: str, version: str, w_rank: int | None):
    """The registered kernel with its rank argument bound: fn(params, stg,
    [subgrids]) (ops/api.py:_rank_args; the kernel's default rank when
    w_rank is None)."""
    fn = get_kernel(workload, version).fn
    rank = _rank_args(workload, version, w_rank)

    def run(params, *args):
        return fn(params, *args, *rank)

    return run


def _stage_local(params: IDGParams, obs: Observation, mesh: DeviceMesh,
                 with_vis: bool = True) -> Staged:
    """Stage the rank's rows on their device, time offsets rebased."""
    return stage(params, _localize_time_offset(obs, params, mesh), obs.uvw.device,
                 with_vis=with_vis)


def sharded_gridder_staged(params: IDGParams, mesh: DeviceMesh, version: str,
                           w_rank: int | None = None):
    """fn(staged rows) -> c64[s_loc, P, N, N] subgrids: one kernel launch on
    the rank's rows, staged outside (`shard_staged_inputs`), so that a
    mesh-N time is comparable to the single-device staged benchmark."""
    kernel = _kernel_fn("gridder", version, w_rank)
    return lambda stg: kernel(params, stg)


def sharded_degridder_staged(params: IDGParams, mesh: DeviceMesh, version: str,
                             w_rank: int | None = None):
    """fn(staged rows, local subgrids) -> c64[s_loc, T, C, P] visibilities,
    one kernel launch (see sharded_gridder_staged)."""
    kernel = _kernel_fn("degridder", version, w_rank)
    return lambda stg, sub: kernel(params, stg, sub)


def sharded_gridder(params: IDGParams, mesh: DeviceMesh, version: str = "torch_v2",
                    w_rank: int | None = None):
    """fn(local observation) -> c64[s_loc, P, N, N] subgrids: the rank's rows
    staged on their device, then the kernel."""
    kernel = _kernel_fn("gridder", version, w_rank)
    return lambda obs: kernel(params, _stage_local(params, obs, mesh))


def sharded_degridder(params: IDGParams, mesh: DeviceMesh, version: str = "torch_v2",
                      w_rank: int | None = None):
    """fn(local observation, local subgrids) -> c64[s_loc, T, C, P]."""
    kernel = _kernel_fn("degridder", version, w_rank)
    return lambda obs, sub: kernel(params, _stage_local(params, obs, mesh, False), sub)


def _inner_group(mesh: DeviceMesh):
    """(the innermost dimension's size, its process group)."""
    return mesh.size(mesh.ndim - 1), mesh.get_group(data_axes(mesh)[-1])


def sharded_gridder_to_grid(params: IDGParams, mesh: DeviceMesh, version: str = "torch_v2",
                            apply_fft: bool = True, grid_sharded: bool = False,
                            w_rank: int | None = None, grid_method: str = "scatter"):
    """fn(local observation[, plan]) -> the c64[P, G, G] grid, or this rank's
    row block c64[P, G / n_inner, G] of it with `grid_sharded`.

    The adjoint pipeline across the mesh: the rank's gridder, its grid stage
    on its own subgrids, then the collective. Replicated, the partial grids
    sum inner dimension first (`hierarchical_psum`); with `grid_sharded`,
    the row blocks reduce-scatter over the innermost dimension (rank i of it
    keeps rows [i·G/n, (i+1)·G/n)), then all-reduce over the outer ones.

    grid_method 'scatter' takes the periodic scatter (ops/grid.py:
    subgrids_to_grid). 'ranges' takes the port's single-device gridded
    recipe on the rank's block-sorted rows (`shard_observation_block_sorted`,
    whose plan is fn's second argument): the gridder with the fused iDFT
    epilogue into the range grid-add K4 where the version has the fused
    form (ops/api.py:gridded_pipeline_parts), else the kernel and then
    ops/grid.py:subgrids_to_grid_ranges. At a world of one it is the
    `pipeline --direction grid` pass, launch for launch, and one all-reduce."""
    g, n = params.grid_size, params.subgrid_size
    n_inner, inner_group = _inner_group(mesh)
    if grid_sharded and g % n_inner:
        raise ValueError(f"reduce_scatter needs the innermost mesh dimension ({n_inner}) "
                         f"to divide the grid rows ({g})")
    if grid_method not in ("scatter", "ranges"):
        raise ValueError(f"grid_method must be 'scatter' or 'ranges', got {grid_method!r}")
    if grid_method == "ranges" and not apply_fft:
        raise ValueError("grid_method='ranges' requires apply_fft=True")
    kernel = _kernel_fn("gridder", version, w_rank)
    fused = grid_method == "ranges" and version in PIECES_GRIDDERS
    if fused:
        from ..ops.cuda.gridder import gridder_cuda_v6_pieces

        rank = _rank_args("gridder", version, w_rank)

    def local_grid(obs, plan):
        stg = _stage_local(params, obs, mesh)
        if grid_method == "scatter":
            return subgrids_to_grid(kernel(params, stg), stg.coord_x, stg.coord_y, g, apply_fft)
        md = obs.metadata
        if fused:
            oyx = torch.as_tensor(roll_offsets(md.coord_x, md.coord_y, g, n), device=stg.device)
            pieces = gridder_cuda_v6_pieces(params, stg, oyx, *rank)
            return subgrids_to_grid_ranges(None, stg.coord_x, stg.coord_y, g, plan=plan,
                                           tiles=pieces)
        return subgrids_to_grid_ranges(kernel(params, stg), stg.coord_x, stg.coord_y, g,
                                       plan=plan)

    def fn(obs, plan=None):
        if grid_method == "ranges" and plan is None:
            raise ValueError("grid_method='ranges' takes the rank's plan from "
                             "shard_observation_block_sorted")
        grid = local_grid(obs, plan)
        if not grid_sharded:
            return hierarchical_psum(grid, mesh)
        p = grid.shape[0]
        rows = g // n_inner
        blocks = grid.reshape(p, n_inner, rows, g).transpose(0, 1).contiguous()
        out = torch.empty((p, rows, g), dtype=grid.dtype, device=grid.device)
        dist.reduce_scatter_tensor(_real(out[None]), _real(blocks), group=inner_group)
        for name in data_axes(mesh)[:-1]:   # the outer (network) reduction of blocks
            dist.all_reduce(_real(out), group=mesh.get_group(name))
        return out

    return fn


def _degrid_local(params: IDGParams, mesh: DeviceMesh, kernel, apply_fft: bool):
    """The rank's degrid recipe on a full grid: the range extraction K5 and
    the (shifted) forward DFT (ops/grid.py:grid_to_subgrids_ranges, the
    plain gather where P·N² % 1024 ≠ 0), then the degridder kernel."""
    def run(obs, grid):
        stg = _stage_local(params, obs, mesh, with_vis=False)
        sub = grid_to_subgrids_ranges(grid, stg.coord_x, stg.coord_y, params.subgrid_size,
                                      apply_fft)
        return kernel(params, stg, sub)

    return run


def sharded_grid_to_degridder(params: IDGParams, mesh: DeviceMesh, version: str = "torch_v2",
                              apply_fft: bool = True, w_rank: int | None = None):
    """fn(local observation, replicated c64[P, G, G] grid) -> the rank's
    c64[s_loc, T, C, P] visibilities. The forward pipeline: each rank
    extracts its own subgrids from the replicated grid (no collective), then
    degrids them; the row-sharded grid's variant is
    sharded_grid_to_degridder_gather."""
    return _degrid_local(params, mesh, _kernel_fn("degridder", version, w_rank), apply_fft)


def sharded_grid_to_degridder_gather(params: IDGParams, mesh: DeviceMesh,
                                     version: str = "torch_v2", apply_fft: bool = True,
                                     w_rank: int | None = None):
    """fn(local observation, this rank's grid row block c64[P, G/n_inner, G])
    -> visibilities, for a grid that stays row-sharded over the innermost
    dimension (the layout of sharded_gridder_to_grid(grid_sharded=True)):
    the row blocks all-gather over that dimension, the exact adjoint of the
    gridder direction's reduce-scatter, then the replicated recipe."""
    degrid = _degrid_local(params, mesh, _kernel_fn("degridder", version, w_rank), apply_fft)
    return lambda obs, block: degrid(obs, gather_grid_rows(block, mesh))


def gather_grid_rows(block: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The full c64[P, G, G] grid from the row blocks c64[P, G/n_inner, G]
    that sharded_gridder_to_grid(grid_sharded=True) leaves on the ranks of
    the innermost dimension: an all-gather over that dimension."""
    n_inner, inner_group = _inner_group(mesh)
    p, rows, g = block.shape
    full = torch.empty((n_inner, p, rows, g), dtype=block.dtype, device=block.device)
    dist.all_gather_into_tensor(_real(full), _real(block.contiguous()[None]),
                                group=inner_group)
    return full.transpose(0, 1).reshape(p, n_inner * rows, g)


def gather_rows(local: torch.Tensor, mesh: DeviceMesh, nr_rows: int) -> torch.Tensor:
    """The global [nr_rows, ...] array from every rank's rows of it, on every
    rank of the mesh (padded tail rows dropped): an all-gather over each
    dimension, inner first, so the rows come in row-major rank order. For
    checks; no builder calls it."""
    x = local.contiguous()
    for name in reversed(data_axes(mesh)):
        group = mesh.get_group(name)
        out = torch.empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(_real(out), _real(x), group=group)
        x = out
    return x[:nr_rows]


def local_rows(mesh: DeviceMesh, nr_rows: int) -> slice:
    """The global rows [lo, min(hi, nr_rows)) this rank holds of an
    nr_rows-row axis padded to the mesh: the slice of a single-device
    result that its local result is held against."""
    lo, hi = _local_rows(mesh, pad_to_multiple(nr_rows, mesh.size()))
    return slice(lo, max(lo, min(hi, nr_rows)))
