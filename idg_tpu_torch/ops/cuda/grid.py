"""Grid-stage kernels, with their plain PyTorch versions: the range
grid-add K4 (csrc/grid_add.cu), the range extraction K5
(csrc/grid_extract.cu), the piece range grid-add K6
(csrc/grid_add_pieces.cu), the merged range grid-add K7
(csrc/grid_add_merged.cu), and the slot-plan grid-adds, the piece scatter
K11a and the slot gather K11b (csrc/grid_add_slots.cu).

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors run the plain version, CUDA tensors launch the kernel (or raise).
There is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import (GridAddMergedPlan, GridAddPlan, GridAddRangePlan, _blocks_to_grid,
                    _gather_tiles, _roll_tiles, _scatter_add_tiles, _slot_sum)
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


# --------------------------------------------------------------------------
# Piece grid-adds: K6 (per block) and K7 (merged groups)
# --------------------------------------------------------------------------


def _check_pieces(pieces: torch.Tensor, nr_subgrids: int, subgrid_size: int,
                  grid_size: int) -> torch.device:
    """Quadrant pieces c64[4S, P, N, N] of a plan's S subgrids."""
    m, p, n, _ = pieces.shape
    _check_geometry(n, p, grid_size)
    if (m, n) != (4 * nr_subgrids, subgrid_size):
        raise ValueError(f"the plan is for 4·S = {4 * nr_subgrids} pieces of N = "
                         f"{subgrid_size}; got {m} of N = {n}")
    device = pieces.device
    _check_tensor("pieces", pieces, torch.complex64, (m, p, n, n), device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the grid kernels run on cpu or cuda, not {device}")
    return device


def _stripe(plan: GridAddRangePlan, lo: int, hi: int | None, unit: int) -> tuple[int, int]:
    """Validated block range [lo, hi): whole block rows (and so, with
    unit = m, whole merged groups) inside the grid."""
    hi = plan.nb if hi is None else hi
    if not (0 <= lo < hi <= plan.nb) or lo % plan.nbx or hi % plan.nbx or lo % unit:
        raise ValueError(f"block range [{lo}, {hi}) must be whole rows of {plan.nbx} blocks "
                         f"within the plan's {plan.nb}")
    return lo, hi


def _run_sums(pieces: torch.Tensor, starts: np.ndarray, lens: np.ndarray) -> torch.Tensor:
    """c64[ncols, P·N²]: per column c, the sum over quadrants q of piece rows
    [starts[q, c], starts[q, c] + lens[q, c]) (index_add_ of each row into
    the column of the run it falls in)."""
    m = pieces.shape[0]
    d = pieces[0].numel()
    flat = pieces.reshape(m, d)
    ncols = starts.shape[1]
    blocks = torch.zeros((ncols, d), dtype=pieces.dtype, device=pieces.device)
    for q in range(4):
        ln = lens[q].astype(np.int64)
        total = int(ln.sum())
        if not total:
            continue
        first = np.cumsum(ln) - ln
        rows = np.repeat(starts[q].astype(np.int64) - first, ln) + np.arange(total)
        cols = np.repeat(np.arange(ncols), ln)
        torch.view_as_real(blocks).index_add_(
            0, torch.as_tensor(cols, device=pieces.device),
            torch.view_as_real(flat[torch.as_tensor(rows, device=pieces.device)]))
    return blocks


def grid_add_pieces_plain(pieces: torch.Tensor, plan: GridAddRangePlan, lo: int = 0,
                          hi: int | None = None) -> torch.Tensor:
    """K6's function in torch ops: each piece row added into the block of the
    run it falls in, then `_blocks_to_grid` on the block rows [lo, hi)."""
    hi = plan.nb if hi is None else hi
    n, p = plan.subgrid_size, pieces.shape[1]
    blocks = _run_sums(pieces, plan.starts[:, lo:hi], plan.lens[:, lo:hi])
    return _blocks_to_grid(blocks, (hi - lo) // plan.nbx, plan.nbx, n, plan.grid_size, p)


def grid_add_pieces_cuda(pieces: torch.Tensor, plan: GridAddRangePlan, lo: int = 0,
                         hi: int | None = None) -> torch.Tensor:
    """Piece range grid-add of masked quadrant pieces c64[4S, P, N, N]
    (block-sorted subgrids, `plan` from their coords): the blocks [lo, hi),
    whole block rows, into a fresh band c64[P, (hi − lo)/nbx·N, G] on the
    pieces' device; the whole grid c64[P, G, G] by default. The kernel
    visits only the blocks with any run, and the band is zero-filled first
    unless that is all of them.
    `grid_add_pieces_cuda.launches` counts kernel launches."""
    device = _check_pieces(pieces, plan.nr_subgrids, plan.subgrid_size, plan.grid_size)
    lo, hi = _stripe(plan, lo, hi, 1)
    if device.type == "cpu":
        return grid_add_pieces_plain(pieces, plan, lo, hi)
    p, n, g = pieces.shape[1], plan.subgrid_size, plan.grid_size
    starts, lens, occupied = plan.stripe_tables(device, lo, hi)
    alloc = torch.empty if occupied.numel() == hi - lo else torch.zeros
    band = alloc((p, (hi - lo) // plan.nbx * n, g), dtype=torch.complex64, device=device)
    if occupied.numel():
        lib = build.library()
        with torch.cuda.device(device):
            rc = lib.idg_grid_add_pieces(
                ptr(pieces), ptr(starts), ptr(lens), ptr(occupied), ptr(band),
                occupied.numel(), hi - lo, plan.nbx, g, n,
                torch.cuda.current_stream(device).cuda_stream,
            )
        build.check(rc, "grid_add_pieces_cuda")
        grid_add_pieces_cuda.launches += 1
    return band


grid_add_pieces_cuda.launches = 0


def merged_window_runs(plan: GridAddRangePlan, mplan: GridAddMergedPlan, lo: int, hi: int):
    """(starts, lens) i64[4, hi − lo]: each block's runs clipped to its
    group's window [base, base + 2·wm), base = (gbase // wm)·wm, and empty
    in groups with gocc == 0: the rows K7 sums (the TPU kernel's selector,
    idg_tpu/ops/grid.py:827-835)."""
    m, wm = mplan.m, mplan.wm
    r0 = plan.starts[:, lo:hi].astype(np.int64)
    r1 = r0 + plan.lens[:, lo:hi]
    base = np.repeat(mplan.gbase[:, lo // m:hi // m].astype(np.int64) // wm * wm, m, axis=1)
    a = np.maximum(r0, base)
    lens = np.maximum(np.minimum(r1, base + 2 * wm) - a, 0)
    lens[:, np.repeat(mplan.gocc[lo // m:hi // m], m) == 0] = 0
    return a, lens


def grid_add_merged_plain(pieces: torch.Tensor, plan: GridAddRangePlan,
                          mplan: GridAddMergedPlan, lo: int = 0,
                          hi: int | None = None) -> torch.Tensor:
    """K7's function in torch ops: `merged_window_runs`' rows of each block
    summed into it, laid out as the band of blocks [lo, hi), before the
    wrap-miss patch."""
    hi = plan.nb if hi is None else hi
    n, p = plan.subgrid_size, pieces.shape[1]
    blocks = _run_sums(pieces, *merged_window_runs(plan, mplan, lo, hi))
    return _blocks_to_grid(blocks, (hi - lo) // plan.nbx, plan.nbx, n, plan.grid_size, p)


def grid_add_merged_cuda(pieces: torch.Tensor, plan: GridAddRangePlan,
                         mplan: GridAddMergedPlan, lo: int = 0,
                         hi: int | None = None) -> torch.Tensor:
    """Merged range grid-add of masked quadrant pieces c64[4S, P, N, N]: the
    blocks [lo, hi), whole block rows, into a fresh band
    c64[P, (hi − lo)/nbx·N, G], one CUDA block per group of m blocks with
    gocc > 0, each block's runs clipped to the group's window; the band is
    zero-filled first unless every group is visited. The
    wrap-miss rows are not added (``ops/grid.py:_patch_misses`` does).
    `grid_add_merged_cuda.launches` counts kernel launches."""
    device = _check_pieces(pieces, plan.nr_subgrids, plan.subgrid_size, plan.grid_size)
    lo, hi = _stripe(plan, lo, hi, mplan.m)
    if device.type == "cpu":
        return grid_add_merged_plain(pieces, plan, mplan, lo, hi)
    p, n, g = pieces.shape[1], plan.subgrid_size, plan.grid_size
    starts, lens, gbase, groups = mplan.stripe_tables(plan, device, lo, hi)
    # the kernel writes every block of the groups it visits
    alloc = torch.empty if groups.numel() == (hi - lo) // mplan.m else torch.zeros
    band = alloc((p, (hi - lo) // plan.nbx * n, g), dtype=torch.complex64, device=device)
    if groups.numel():
        lib = build.library()
        with torch.cuda.device(device):
            rc = lib.idg_grid_add_merged(
                ptr(pieces), ptr(starts), ptr(lens), ptr(gbase), ptr(groups), ptr(band),
                groups.numel(), hi - lo, mplan.m, mplan.wm, plan.nbx, g, n,
                torch.cuda.current_stream(device).cuda_stream,
            )
        build.check(rc, "grid_add_merged_cuda")
        grid_add_merged_cuda.launches += 1
    return band


grid_add_merged_cuda.launches = 0


# --------------------------------------------------------------------------
# Slot-plan grid-adds: K11a (piece scatter) and K11b (slot gather)
# --------------------------------------------------------------------------


def grid_add_scatter_plain(pieces: torch.Tensor, plan: GridAddPlan) -> torch.Tensor:
    """K11a's function in torch ops: index_add_ of each piece into its
    destination block (`piece_blocks`), then `_blocks_to_grid`."""
    m, p, n, _ = pieces.shape
    blocks = torch.zeros((plan.slots.shape[0], p * n * n), dtype=pieces.dtype,
                         device=pieces.device)
    torch.view_as_real(blocks).index_add_(
        0, torch.as_tensor(plan.piece_blocks.astype(np.int64), device=pieces.device),
        torch.view_as_real(pieces.reshape(m, p * n * n)))
    return _blocks_to_grid(blocks, plan.nby, plan.nbx, n, plan.grid_size, p)


def grid_add_scatter_cuda(pieces: torch.Tensor, plan: GridAddPlan) -> torch.Tensor:
    """Piece scatter of quadrant pieces c64[4S, P, N, N] into a fresh
    c64[P, G, G] grid on the pieces' device: every non-zero pixel is added
    at its destination block (`plan.piece_blocks`) with atomics, so the sum
    order changes from run to run. `grid_add_scatter_cuda.launches` counts
    kernel launches."""
    device = _check_pieces(pieces, plan.nr_subgrids, plan.subgrid_size, plan.grid_size)
    if plan.piece_blocks is None:
        raise ValueError("the piece scatter needs the plan's piece_blocks")
    if device.type == "cpu":
        return grid_add_scatter_plain(pieces, plan)
    p, n, g = pieces.shape[1], plan.subgrid_size, plan.grid_size
    grid = torch.zeros((p, g, g), dtype=torch.complex64, device=device)
    if pieces.shape[0]:
        lib = build.library()
        with torch.cuda.device(device):
            rc = lib.idg_grid_add_scatter(
                ptr(pieces), ptr(plan.device_piece_blocks(device)), ptr(grid),
                pieces.shape[0], plan.nbx, g, n,
                torch.cuda.current_stream(device).cuda_stream,
            )
        build.check(rc, "grid_add_scatter_cuda")
        grid_add_scatter_cuda.launches += 1
    return grid


grid_add_scatter_cuda.launches = 0


def grid_add_slots_plain(pieces: torch.Tensor, plan: GridAddPlan) -> torch.Tensor:
    """K11b's function in torch ops: `subgrids_to_grid_bucketed`'s gather-sum
    of each block's slot rows, chunked over blocks, then `_blocks_to_grid`."""
    p, n = pieces.shape[1], plan.subgrid_size
    blocks = _slot_sum(pieces, plan.device_slots(pieces.device))
    return _blocks_to_grid(blocks, plan.nby, plan.nbx, n, plan.grid_size, p)


def grid_add_slots_cuda(pieces: torch.Tensor, plan: GridAddPlan) -> torch.Tensor:
    """Slot gather of quadrant pieces c64[4S, P, N, N] into a fresh
    c64[P, G, G] grid on the pieces' device: one CUDA block per grid block
    sums its `plan.slots` rows in slot order, skipping the sentinel
    (deterministic). `grid_add_slots_cuda.launches` counts kernel
    launches."""
    device = _check_pieces(pieces, plan.nr_subgrids, plan.subgrid_size, plan.grid_size)
    if device.type == "cpu":
        return grid_add_slots_plain(pieces, plan)
    p, n, g = pieces.shape[1], plan.subgrid_size, plan.grid_size
    grid = torch.empty((p, g, g), dtype=torch.complex64, device=device)
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_grid_add_slots(
            ptr(pieces), ptr(plan.device_slots(device)), ptr(grid),
            plan.nby * plan.nbx, plan.cap, pieces.shape[0], plan.nbx, g, n,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "grid_add_slots_cuda")
    grid_add_slots_cuda.launches += 1
    return grid


grid_add_slots_cuda.launches = 0
