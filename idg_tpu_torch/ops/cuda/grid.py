"""Grid-stage kernels: the range grid-add K4 (csrc/grid_add.cu) and the range
extraction K5 (csrc/grid_extract.cu), with their plain PyTorch versions.

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors run the plain version, CUDA tensors launch the kernel (or raise).
There is no fallback between the two.
"""

from __future__ import annotations

import torch

from ..grid import GridAddRangePlan, _gather_tiles, _roll_tiles, _scatter_add_tiles
from . import build
from .gridder import SUBGRID_SIZES, _check_tensor, ptr

NR_POLS = 4  # the kernels' P


def _check_geometry(n: int, p: int, g: int) -> None:
    if n not in SUBGRID_SIZES:
        raise ValueError(f"subgrid_size {n} not supported; the kernels take {SUBGRID_SIZES}")
    if p != NR_POLS:
        raise ValueError(f"the grid kernels take {NR_POLS} correlations, got {p}")
    if g % n:
        raise ValueError(f"grid_size {g} must be a multiple of subgrid_size {n}")


def _home_corners(plan: GridAddRangePlan, oyx: torch.Tensor):
    """(cy, cx) mod G of each sorted subgrid from its home block and roll."""
    home = torch.as_tensor(plan.home_blocks(), device=oyx.device)
    n = plan.subgrid_size
    return (home // plan.nbx) * n + oyx[:, 0], (home % plan.nbx) * n + oyx[:, 1]


def grid_add_plain(pieces: torch.Tensor, oyx: torch.Tensor, plan: GridAddRangePlan,
                   grid_size: int) -> torch.Tensor:
    """K4's function in torch ops: roll each piece back into its subgrid's
    window and scatter-add it at the window's corner, periodic wrap."""
    cy, cx = _home_corners(plan, oyx)
    tiles = _roll_tiles(pieces, -oyx[:, 0], -oyx[:, 1])
    return _scatter_add_tiles(tiles, cy, cx, grid_size)


def grid_add_cuda(pieces: torch.Tensor, oyx: torch.Tensor, plan: GridAddRangePlan,
                  grid_size: int) -> torch.Tensor:
    """Range grid-add of block-rolled pieces c64[S, P, N, N] (subgrids in
    block-sorted order, `plan` from their coords, `oyx` i32[S, 2] their
    rolls) into a fresh c64[P, G, G] grid on the pieces' device.
    `grid_add_cuda.launches` counts kernel launches."""
    s, p, n, _ = pieces.shape
    _check_geometry(n, p, grid_size)
    if (plan.nr_subgrids, plan.subgrid_size, plan.grid_size) != (s, n, grid_size):
        raise ValueError(
            f"plan is for S={plan.nr_subgrids}, N={plan.subgrid_size}, "
            f"G={plan.grid_size}; pieces give S={s}, N={n}, G={grid_size}")
    device = pieces.device
    _check_tensor("pieces", pieces, torch.complex64, (s, p, n, n), device)
    _check_tensor("oyx", oyx, torch.int32, (s, 2), device)
    if device.type == "cpu":
        return grid_add_plain(pieces, oyx, plan, grid_size)
    if device.type != "cuda":
        raise ValueError(f"grid_add_cuda runs on cpu or cuda, not {device}")
    grid = torch.empty((p, grid_size, grid_size), dtype=torch.complex64, device=device)
    tstarts, lens = plan.device_tables(device)
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_grid_add(
            ptr(pieces), ptr(oyx), ptr(tstarts), ptr(lens), ptr(grid),
            plan.nb, plan.nbp, plan.nbx, grid_size, n,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "grid_add_cuda")
    grid_add_cuda.launches += 1
    return grid


grid_add_cuda.launches = 0


def grid_extract_plain(grid: torch.Tensor, coord_x: torch.Tensor, coord_y: torch.Tensor,
                       n: int) -> torch.Tensor:
    """K5's function in torch ops: gather each subgrid's window with
    periodic wrap, then roll it by its offset in its home block."""
    g = grid.shape[-1]
    cy, cx = coord_y.to(torch.int64) % g, coord_x.to(torch.int64) % g
    return _roll_tiles(_gather_tiles(grid, cy, cx, n), cy % n, cx % n)


def grid_extract_cuda(grid: torch.Tensor, coord_x: torch.Tensor, coord_y: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Range extraction from a c64[P, G, G] grid: block-rolled pieces
    c64[S, P, N, N] of the subgrids at i32[S] coords, on the grid's device.
    `grid_extract_cuda.launches` counts kernel launches."""
    p, g, _ = grid.shape
    _check_geometry(n, p, g)
    s = coord_x.shape[0]
    device = grid.device
    _check_tensor("grid", grid, torch.complex64, (p, g, g), device)
    _check_tensor("coord_x", coord_x, torch.int32, (s,), device)
    _check_tensor("coord_y", coord_y, torch.int32, (s,), device)
    if device.type == "cpu":
        return grid_extract_plain(grid, coord_x, coord_y, n)
    if device.type != "cuda":
        raise ValueError(f"grid_extract_cuda runs on cpu or cuda, not {device}")
    out = torch.empty((s, p, n, n), dtype=torch.complex64, device=device)
    if s == 0:
        return out
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_grid_extract(
            ptr(grid), ptr(coord_x), ptr(coord_y), ptr(out), s, g, n,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "grid_extract_cuda")
    grid_extract_cuda.launches += 1
    return out


grid_extract_cuda.launches = 0
