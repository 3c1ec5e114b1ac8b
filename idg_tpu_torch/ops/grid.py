"""Grid stage: subgrid (i)DFT and subgrid <-> grid accumulation/extraction.

The counterpart of the part of ``idg_tpu/ops/grid.py`` the gridded and
degrid pipelines run. Host-side plans are numpy, copied from the JAX
package; device work is torch on complex64 tensors, where the JAX package
carries split (re, im) pairs.

The pipeline (tile path of ``subgrids_to_grid_ranges``):
  gridder epilogue → block-rolled pieces → range grid-add (K4) → [P, G, G]
and its adjoint (``grid_to_subgrids_ranges(pieces=True)``):
  [P, G, G] → range extraction (K5) → pieces → degridder prologue.
A piece is the subgrid's image-domain tile rolled by (oy, ox), the tile's
offset inside its home N×N grid block, so that its pixel (i, j) lies at
(i, j) of one of the four blocks the tile straddles. Subgrids must be sorted
by home block (``sort_observation_blocks``) for the range plans.

``subgrids_to_grid`` / ``grid_to_subgrids`` are the plain periodic
scatter-add and gather with the FFT, the JAX package's XLA fallbacks; with
``_roll_tiles`` they are also the plain versions of K4 and K5
(``ops/cuda/grid.py``).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

# --------------------------------------------------------------------------
# DFT factors and transforms (idg_tpu/ops/grid.py:31-109)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def dft_factors(n: int, inverse: bool) -> np.ndarray:
    """c64[n, n] DFT matrix; the inverse carries 1/n (per axis)."""
    j = np.arange(n)
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * np.outer(j, j) / n)
    if inverse:
        w = w / n
    return w.astype(np.complex64)


@lru_cache(maxsize=None)
def dft_shift_factors(n: int, inverse: bool) -> np.ndarray:
    """DFT matrix with both fftshifts folded in as index permutations:
    Wf[y, k] = Wdft[σ_in(y), σ_out(k)] with σ_in(y) = (y + n//2) % n and
    σ_out(k) = (k − n//2) % n, so fftshift2 → (i)DFT2 → fftshift2 is
    Wfᵀ·X·Wf. Rows are the input index, columns the output index. These
    are the factors K3 (csrc/common.cuh:dft2_tile) applies."""
    w = dft_factors(n, inverse)
    j = np.arange(n)
    return np.ascontiguousarray(w[np.ix_((j + n // 2) % n, (j - n // 2) % n)])


@lru_cache(maxsize=None)
def _factors_on(n: int, inverse: bool, shifted: bool, device: torch.device) -> torch.Tensor:
    w = dft_shift_factors(n, inverse) if shifted else dft_factors(n, inverse)
    return torch.as_tensor(w, device=device)


def dft_shift_factors_on(n: int, inverse: bool, device) -> torch.Tensor:
    """`dft_shift_factors` as a c64 tensor on `device` (cached)."""
    return _factors_on(n, inverse, True, torch.device(device))


def _apply_both_axes(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """wᵀ·x·w over the last two axes (x[..., y, x] · w[x, k] on each)."""
    return torch.matmul(w.transpose(0, 1), torch.matmul(x, w))


def fft2(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """2-D DFT over the last two (square) axes as two matmuls
    (``fft2_pair``)."""
    return _apply_both_axes(x, _factors_on(x.shape[-1], inverse, False, x.device))


def fft2_shift(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """fftshift2 → fft2 → fftshift2 as two matmuls with the shifts folded
    into the factors (``fft2_shift_pair``)."""
    return _apply_both_axes(x, _factors_on(x.shape[-1], inverse, True, x.device))


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """fftshift over the last two axes (``fftshift2_pair``)."""
    n1, n0 = x.shape[-1], x.shape[-2]
    return torch.roll(x, shifts=(n0 // 2, n1 // 2), dims=(-2, -1))


# --------------------------------------------------------------------------
# Per-tile roll (idg_tpu/ops/grid.py:343-416)
# --------------------------------------------------------------------------


def _roll_tiles(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """Per-tile cyclic roll of [S, P, N, N] tiles by (oy[s], ox[s]):
    out[s, p, (y+oy)%N, (x+ox)%N] = x[s, p, y, x]. Exact (an index
    permutation; the JAX package built it as a one-hot matmul for its MXU)."""
    s, p, n, _ = x.shape
    i = torch.arange(n, device=x.device)
    rows = (i[None, :] - oy.to(torch.int64)[:, None]) % n            # [S, N]
    cols = (i[None, :] - ox.to(torch.int64)[:, None]) % n
    x = torch.gather(x, 2, rows[:, None, :, None].expand(s, p, n, n))
    return torch.gather(x, 3, cols[:, None, None, :].expand(s, p, n, n))


def _phase_roll_fourier(sub: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                        sign: float = -1.0, shifted: bool = False) -> torch.Tensor:
    """The per-tile roll by (oy, ox) folded into Fourier space:
    roll(ifft2(T), (oy, ox)) == ifft2(T · e^{-2πi(ky·oy + kx·ox)/n}).
    Angles use exact integer mod n. sign=+1 applies the conjugate phases
    (the roll back after the forward DFT); shifted=True evaluates them at
    the fftshifted index σ(k) = (k + n/2) % n, for a multiply outside the
    fftshift∘fft∘fftshift chain."""
    n = sub.shape[-1]
    k = torch.arange(n, dtype=torch.int64, device=sub.device)
    if shifted:
        k = (k + n // 2) % n
    scale = np.float32(sign * 2.0 * np.pi / n)
    ay = scale * ((k[None, :] * oy.to(torch.int64)[:, None]) % n).to(torch.float32)
    ax = scale * ((k[None, :] * ox.to(torch.int64)[:, None]) % n).to(torch.float32)
    ph = torch.polar(torch.ones_like(ay), ay)[:, :, None] * \
        torch.polar(torch.ones_like(ax), ax)[:, None, :]             # [S, N, N]
    return sub * ph[:, None]


def pieces_from_subgrids(sub: torch.Tensor, oyx: torch.Tensor) -> torch.Tensor:
    """The gridded pipeline's producer: uv subgrids c64[S, P, N, N] →
    block-rolled image-domain pieces, with the roll as Fourier phases and
    the folded-shift inverse DFT as two matmuls (the JAX producer,
    ``fft2_shift_pair(_phase_roll_fourier(sub, oy, ox, shifted=True),
    inverse=True)``). The plain version of the gridder's fused epilogue."""
    x = _phase_roll_fourier(sub, oyx[:, 0], oyx[:, 1], shifted=True)
    return fft2_shift(x, inverse=True)


def _finish_extract(rolled: torch.Tensor, oyx: torch.Tensor) -> torch.Tensor:
    """Block-rolled pieces → uv subgrids: the forward folded-shift DFT, then
    the roll back as conjugate Fourier phases (grid.py:1377-1387). The plain
    version of the degridder's fused prologue."""
    x = fft2_shift(rolled, inverse=False)
    return _phase_roll_fourier(x, oyx[:, 0], oyx[:, 1], sign=+1.0, shifted=True)


# --------------------------------------------------------------------------
# Periodic scatter-add and gather (idg_tpu/ops/grid.py:112-233)
# --------------------------------------------------------------------------


def _tile_index(cy: torch.Tensor, cx: torch.Tensor, n: int, g: int) -> torch.Tensor:
    """Flat [G·G] index of each tile's N×N window at (cy, cx), wrapped
    periodically: i64[S, N, N]."""
    i = torch.arange(n, dtype=torch.int64, device=cy.device)
    rows = (cy.to(torch.int64)[:, None] + i[None, :]) % g
    cols = (cx.to(torch.int64)[:, None] + i[None, :]) % g
    return rows[:, :, None] * g + cols[:, None, :]


def _scatter_add_tiles(tiles: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                       grid_size: int) -> torch.Tensor:
    """Scatter-add [S, P, N, N] tiles at rows cy / cols cx into a fresh
    [P, G, G] grid with periodic wrap (index_add_ on wrapped flat indices,
    one polarization plane at a time to bound the index memory)."""
    s, p, n, _ = tiles.shape
    g = grid_size
    idx = _tile_index(cy, cx, n, g).reshape(-1)
    grid = torch.zeros((p, g * g), dtype=tiles.dtype, device=tiles.device)
    for pol in range(p):
        # on float pairs: index_add_ over complex is not on every backend
        torch.view_as_real(grid[pol]).index_add_(
            0, idx, torch.view_as_real(tiles[:, pol].reshape(-1)))
    return grid.reshape(p, g, g)


def _gather_tiles(grid: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Gather [S, P, N, N] tiles at (cy, cx) from a [P, G, G] grid with
    periodic wrap (the adjoint of `_scatter_add_tiles`)."""
    p, g, _ = grid.shape
    idx = _tile_index(cy, cx, n, g)
    return grid.reshape(p, g * g)[:, idx].permute(1, 0, 2, 3)


def subgrids_to_grid(sub: torch.Tensor, coord_x, coord_y, grid_size: int) -> torch.Tensor:
    """Subgrid iFFT (shifted) + periodic scatter-add into a c64[P, G, G]
    grid. `sub` is c64[S, P, N, N] uv subgrids; coords are each subgrid's
    top-left grid corner. The plain version of the whole gridded grid
    stage."""
    x = fftshift2(fft2(fftshift2(sub), inverse=True))
    cy, cx = (torch.as_tensor(np.asarray(c), device=sub.device) for c in (coord_y, coord_x))
    return _scatter_add_tiles(x, cy, cx, grid_size)


def grid_to_subgrids(grid: torch.Tensor, coord_x, coord_y, subgrid_size: int) -> torch.Tensor:
    """Periodic gather of [S, P, N, N] tiles from a c64[P, G, G] grid, then
    the (shifted) forward FFT to uv subgrids: the adjoint of
    `subgrids_to_grid`, and the plain version of the whole degrid grid
    stage."""
    cy, cx = (torch.as_tensor(np.asarray(c), device=grid.device) for c in (coord_y, coord_x))
    x = _gather_tiles(grid, cy, cx, subgrid_size)
    return fftshift2(fft2(fftshift2(x), inverse=False))


# --------------------------------------------------------------------------
# Block sort and the range plan (idg_tpu/ops/grid.py:463-567)
# --------------------------------------------------------------------------


def block_sort_order(coord_x, coord_y, grid_size: int, subgrid_size: int) -> np.ndarray:
    """Host permutation sorting subgrids by destination grid block
    (row-major). With metadata sorted this way, every block's quadrant-q
    pieces form one contiguous run, which the range kernels need."""
    g, n = grid_size, subgrid_size
    cx = np.asarray(coord_x).astype(np.int64) % g
    cy = np.asarray(coord_y).astype(np.int64) % g
    nbx = g // n
    return np.argsort((cy // n) * nbx + (cx // n), kind="stable")


def sorted_block_coords(coord_x, coord_y, grid_size: int, subgrid_size: int):
    """(order, coord_x[order], coord_y[order]) for block-sorted host coords."""
    order = block_sort_order(coord_x, coord_y, grid_size, subgrid_size)
    return order, np.asarray(coord_x)[order], np.asarray(coord_y)[order]


def sort_observation_blocks(obs, grid_size: int, subgrid_size: int):
    """(observation with block-sorted per-subgrid metadata, order). Sorting
    is free: metadata is host data and the kernels are per-subgrid
    independent. After the sort, time_offset is no longer canonical, so
    staging takes its gather path."""
    md = obs.metadata
    order = block_sort_order(md.coord_x, md.coord_y, grid_size, subgrid_size)
    md_sorted = type(md)(**{
        f.name: np.asarray(getattr(md, f.name))[order]
        for f in dataclasses.fields(md)
    })
    return dataclasses.replace(obs, metadata=md_sorted), order


class GridAddRangePlan:
    """Host routing for the range grid-add: per (quadrant, block) contiguous
    runs of block-sorted subgrids. Requires block-sorted coords.

    starts/lens: i32[4, nbp], piece-array offsets (quadrant section q·S
    folded in) and run lengths; tstarts: the same offsets in tile space
    (what K4 reads); w: the longest run (at least 8); nbp: the block count
    rounded up to a multiple of 8. The tables equal the JAX plan's."""

    def __init__(self, starts, lens, w, nby, nbx, nbp, nr_subgrids,
                 grid_size, subgrid_size, tstarts=None):
        self.starts = starts
        self.tstarts = tstarts
        self.lens = lens
        self.w = w
        self.nby = nby
        self.nbx = nbx
        self.nbp = nbp
        self.nr_subgrids = nr_subgrids
        self.grid_size = grid_size
        self.subgrid_size = subgrid_size
        self._device_tables = {}

    @property
    def nb(self) -> int:
        return self.nby * self.nbx

    def home_blocks(self) -> np.ndarray:
        """i64[S]: each sorted subgrid's home block (quadrant 0's runs)."""
        return np.repeat(np.arange(self.nb), self.lens[0, :self.nb])

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(tstarts, lens) as contiguous i32 tensors on `device`, uploaded
        once per device."""
        device = torch.device(device)
        if device not in self._device_tables:
            self._device_tables[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(t, np.int32), device=device)
                for t in (self.tstarts, self.lens))
        return self._device_tables[device]


_QUADRANTS = ((0, 0), (0, 1), (1, 0), (1, 1))  # the plan's quadrant order


def plan_grid_add_ranges(coord_x, coord_y, grid_size: int,
                         subgrid_size: int) -> GridAddRangePlan:
    """Range plan from block-sorted host coords. For block b = (iy, ix) and
    quadrant q = (qy, qx), the contributing subgrids are those whose home
    block is ((iy−qy) mod nby, (ix−qx) mod nbx): one contiguous run
    [r0, r0+len) of the sorted order, [q·S + r0, …) in piece space."""
    n = subgrid_size
    g = grid_size
    if g % n:
        raise ValueError(f"grid_size {g} must be a multiple of subgrid_size {n}")
    cx = np.asarray(coord_x).astype(np.int64) % g
    cy = np.asarray(coord_y).astype(np.int64) % g
    s = int(cx.shape[0])
    nby = nbx = g // n
    nb = nby * nbx
    home = (cy // n) * nbx + (cx // n)
    if np.any(np.diff(home) < 0):
        raise ValueError(
            "plan_grid_add_ranges requires block-sorted coords "
            "(apply block_sort_order to the metadata first)"
        )
    counts = np.bincount(home, minlength=nb)
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nbp = ((nb + 7) // 8) * 8
    starts = np.zeros((4, nbp), np.int64)
    tstarts = np.zeros((4, nbp), np.int64)
    lens = np.zeros((4, nbp), np.int32)
    iy, ix = np.divmod(np.arange(nb), nbx)
    for q, (qy, qx) in enumerate(_QUADRANTS):
        src = ((iy - qy) % nby) * nbx + ((ix - qx) % nbx)
        starts[q, :nb] = q * s + seg_start[src]
        tstarts[q, :nb] = seg_start[src]
        lens[q, :nb] = counts[src]
    w = max(8, int(counts.max()) if s else 8)
    return GridAddRangePlan(
        starts.astype(np.int32), lens, w, nby, nbx, nbp, s, g, n,
        tstarts=tstarts.astype(np.int32),
    )


def roll_offsets(coord_x, coord_y, grid_size: int, subgrid_size: int) -> np.ndarray:
    """i32[S, 2] per-subgrid roll (coord_y % G % N, coord_x % G % N)."""
    g, n = grid_size, subgrid_size
    return np.stack([
        np.asarray(coord_y).astype(np.int64) % g % n,
        np.asarray(coord_x).astype(np.int64) % g % n,
    ], axis=-1).astype(np.int32)


# --------------------------------------------------------------------------
# Dispatch (idg_tpu/ops/grid.py:1320-1374, 1884-2025)
# --------------------------------------------------------------------------


def subgrids_to_grid_ranges(sub, coord_x, coord_y, grid_size: int,
                            plan: GridAddRangePlan | None = None,
                            tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Grid-add through the range kernel K4 (``ops/cuda/grid.py:
    grid_add_cuda``): c64[P, G, G]. Requires block-sorted coords.

    `tiles` supplies block-rolled pieces already (the gridder's fused
    epilogue, ``gridder_cuda_v6_pieces``) and `sub` is then ignored;
    otherwise the pieces are produced from the uv subgrids `sub` by
    `pieces_from_subgrids`. Every plan takes K4: the JAX package sends
    sparse plans (nbp > 2·S) to its piece kernel K6 for speed only, and
    K4's sum does not depend on occupancy."""
    from .cuda.grid import grid_add_cuda

    n = (tiles if tiles is not None else sub).shape[-1]
    if plan is None:
        plan = plan_grid_add_ranges(coord_x, coord_y, grid_size, n)
    device = (tiles if tiles is not None else sub).device
    oyx = torch.as_tensor(roll_offsets(coord_x, coord_y, grid_size, n), device=device)
    if tiles is None:
        tiles = pieces_from_subgrids(sub, oyx)
    return grid_add_cuda(tiles, oyx, plan, grid_size)


def grid_to_subgrids_ranges(grid: torch.Tensor, coord_x, coord_y, subgrid_size: int,
                            pieces: bool = False) -> torch.Tensor:
    """Extraction through the range kernel K5 (``ops/cuda/grid.py:
    grid_extract_cuda``): c64[S, P, N, N]. With pieces=True, the
    block-rolled image-domain pieces for a consumer that fuses the DFT (the
    degridder's fused prologue); otherwise uv subgrids (`_finish_extract`).
    The kernel needs no plan and no sorted coords; the pipeline sorts them
    for the grid-add's sake."""
    from .cuda.grid import grid_extract_cuda

    g = grid.shape[-1]
    cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device=grid.device)
              for c in (coord_x, coord_y))
    rolled = grid_extract_cuda(grid, cx, cy, subgrid_size)
    if pieces:
        return rolled
    oyx = torch.as_tensor(roll_offsets(coord_x, coord_y, g, subgrid_size), device=grid.device)
    return _finish_extract(rolled, oyx)
