"""Grid stage: subgrid (i)DFT and subgrid <-> grid accumulation/extraction.

The counterpart of ``idg_tpu/ops/grid.py``. Host-side plans are numpy,
copied from the JAX package; device work is torch on complex64 tensors,
where the JAX package carries split (re, im) pairs.

The gridded pipeline (tile path of ``subgrids_to_grid_ranges``):
  gridder epilogue → block-rolled pieces → range grid-add (K4) → [P, G, G]
and its adjoint (``grid_to_subgrids_ranges(pieces=True)``):
  [P, G, G] → range extraction (K5) → pieces → degridder prologue.
A piece is the subgrid's image-domain tile rolled by (oy, ox), the tile's
offset inside its home N×N grid block, so that its pixel (i, j) lies at
(i, j) of one of the four blocks the tile straddles. Subgrids must be sorted
by home block (``sort_observation_blocks``) for the range plans.

Sparse plans (more grid blocks than twice the subgrids) and the no-FFT
path mask each piece into its four quadrant pieces first and add those with
the piece grid-add (K6); grids of several GB stream block-row stripes
through K6 or, merged m blocks per group, K7. The slot plan
(``plan_grid_add``) feeds the piece scatter (K11a) and the slot gather
(K11b) of ``subgrids_to_grid_pallas`` and the plain
``subgrids_to_grid_bucketed``. The kernels and their plain versions are in
``ops/cuda/grid.py``.

``subgrids_to_grid`` / ``grid_to_subgrids`` are the plain periodic
scatter-add and gather with the FFT, the JAX package's XLA fallbacks; with
``_roll_tiles`` they are also the plain versions of K4 and K5.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..config import get_env_var

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


def _image_tiles(sub: torch.Tensor) -> torch.Tensor:
    """uv subgrids → image-domain tiles: fftshift2 → inverse DFT → fftshift2."""
    return fftshift2(fft2(fftshift2(sub), inverse=True))


# --------------------------------------------------------------------------
# Coordinates, per-tile roll and quadrant pieces (idg_tpu/ops/grid.py:322-416)
# --------------------------------------------------------------------------


def _host(c) -> np.ndarray:
    """Host numpy copy of a coordinate array (numpy or a tensor)."""
    return c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _coords_on(c, device) -> torch.Tensor:
    """Coordinates as i64 on `device` (no copy when they are there already)."""
    c = c if isinstance(c, torch.Tensor) else torch.as_tensor(np.asarray(c))
    return c.to(device=device, dtype=torch.int64)


def _rolls(coord_x, coord_y, grid_size: int, n: int, device) -> torch.Tensor:
    """i32[S, 2] per-subgrid roll (cy % G % N, cx % G % N) on `device`,
    computed there from the coordinates (`roll_offsets` on the host)."""
    return torch.stack([_coords_on(c, device) % grid_size % n for c in (coord_y, coord_x)],
                       dim=-1).to(torch.int32)


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


_QUADRANTS = ((0, 0), (0, 1), (1, 0), (1, 1))  # the plans' quadrant order


def _mask_pieces(rolled: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """Mask rolled tiles c64[S, P, N, N] into their 4 quadrant pieces,
    c64[4S, P, N, N] quadrant-major (piece q·S + s): piece q = (qy, qx) keeps
    the rows with (i >= oy) == (qy == 0) and the columns with
    (j >= ox) == (qx == 0), the pixels that land in block (by+qy, bx+qx),
    and is exactly zero elsewhere. The JAX package's window padding rows
    (`pad_rows`) fed Pallas's window DMAs and are left out."""
    s, p, n, _ = rolled.shape
    i = torch.arange(n, device=rolled.device)
    row_hi = i[None, :] >= oy.to(torch.int64)[:, None]                # [S, N]
    col_hi = i[None, :] >= ox.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=rolled.dtype, device=rolled.device)
    out = torch.empty((4, s, p, n, n), dtype=rolled.dtype, device=rolled.device)
    for q, (qy, qx) in enumerate(_QUADRANTS):
        rmask = row_hi if qy == 0 else ~row_hi
        cmask = col_hi if qx == 0 else ~col_hi
        torch.where(rmask[:, None, :, None] & cmask[:, None, None, :], rolled, zero, out=out[q])
    return out.reshape(4 * s, p, n, n)


def _quadrant_pieces(sub: torch.Tensor, coord_y, coord_x, grid_size: int) -> torch.Tensor:
    """Roll + mask each image-domain tile c64[S, P, N, N] into its 4 N×N
    block-aligned pieces c64[4S, P, N, N] (quadrant-major, matching
    `plan_grid_add`'s ids and the range plans' piece space)."""
    n = sub.shape[-1]
    oyx = _rolls(coord_x, coord_y, grid_size, n, sub.device)
    return _mask_pieces(_roll_tiles(sub, oyx[:, 0], oyx[:, 1]), oyx[:, 0], oyx[:, 1])


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


def _finish_extract(rolled: torch.Tensor, oyx: torch.Tensor,
                    apply_fft: bool = True) -> torch.Tensor:
    """Block-rolled pieces → subgrids (grid.py:1377-1387): with apply_fft,
    the forward folded-shift DFT, then the roll back as conjugate Fourier
    phases (the plain version of the degridder's fused prologue); without,
    the roll back by index on the image-domain tiles."""
    if not apply_fft:
        return _roll_tiles(rolled, -oyx[:, 0], -oyx[:, 1])
    x = fft2_shift(rolled, inverse=False)
    return _phase_roll_fourier(x, oyx[:, 0], oyx[:, 1], sign=+1.0, shifted=True)


def _blocks_to_grid(blocks: torch.Tensor, nby: int, nbx: int, n: int, g: int, p: int,
                    grid_in: torch.Tensor | None = None) -> torch.Tensor:
    """Lay summed blocks c64[≥ nby·nbx, P·N·N] (row-major block order) into a
    c64[P, nby·N, g] grid, or a band of nby block rows of one (a
    reshape/permute: the blocks tile it exactly). The plain versions use
    it; the kernels store straight into [P, G, G]."""
    gr = (blocks[:nby * nbx]
          .reshape(nby, nbx, p, n, n)
          .permute(2, 0, 3, 1, 4)
          .reshape(p, nby * n, g))
    return gr if grid_in is None else gr + grid_in


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


def subgrids_to_grid(sub: torch.Tensor, coord_x, coord_y, grid_size: int,
                     apply_fft: bool = True) -> torch.Tensor:
    """Subgrid iFFT (shifted) + periodic scatter-add into a c64[P, G, G]
    grid. `sub` is c64[S, P, N, N] uv subgrids (image-domain tiles with
    apply_fft=False); coords are each subgrid's top-left grid corner. The
    plain version of the whole gridded grid stage."""
    x = _image_tiles(sub) if apply_fft else sub
    cy, cx = (_coords_on(c, sub.device) for c in (coord_y, coord_x))
    return _scatter_add_tiles(x, cy, cx, grid_size)


def subgrids_to_grid_streamed(sub: torch.Tensor, coord_x, coord_y, grid_size: int,
                              apply_fft: bool = True) -> tuple:
    """`subgrids_to_grid` one polarization plane at a time, for grids of
    several GB: returns a tuple of P c64[G, G] planes, not stacked (the
    stack would be one more full-grid copy). The JAX package ran each
    (component, pol) plane in its own jit to scope XLA's buffer liveness;
    eagerly, each plane's index and scatter temporaries are freed before
    the next."""
    x = _image_tiles(sub) if apply_fft else sub
    cy, cx = (_coords_on(c, sub.device) for c in (coord_y, coord_x))
    return tuple(_scatter_add_tiles(x[:, pol:pol + 1], cy, cx, grid_size)[0]
                 for pol in range(x.shape[1]))


def grid_to_subgrids(grid: torch.Tensor, coord_x, coord_y, subgrid_size: int,
                     apply_fft: bool = True) -> torch.Tensor:
    """Periodic gather of [S, P, N, N] tiles from a c64[P, G, G] grid, then
    (with apply_fft) the shifted forward FFT to uv subgrids: the adjoint of
    `subgrids_to_grid`, and the plain version of the whole degrid grid
    stage."""
    cy, cx = (_coords_on(c, grid.device) for c in (coord_y, coord_x))
    x = _gather_tiles(grid, cy, cx, subgrid_size)
    return fftshift2(fft2(fftshift2(x), inverse=False)) if apply_fft else x


# --------------------------------------------------------------------------
# The slot plan and the bucketed grid-add (idg_tpu/ops/grid.py:236-460)
# --------------------------------------------------------------------------


class _PlanCache:
    """Per-plan memo for derived host tables and their device uploads (the
    JAX package memoized its per-stripe uploads on the plan object)."""

    def cached(self, key, make):
        cache = self.__dict__.setdefault("_cache", {})
        if key not in cache:
            cache[key] = make()
        return cache[key]


def _i32_on(table, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(table, np.int32), device=device)


class GridAddPlan(_PlanCache):
    """Host routing for the slot-plan grid-adds (one observation).

    slots[b, j] = flat index of the j-th piece destined for block b, or the
    sentinel 4·S for padding; blocks are the (G/N)² N×N grid tiles,
    row-major, block rows padded to a multiple of 8. piece_blocks: the
    destination block of each quadrant piece (quadrant-major, the forward
    form of the slot table), the piece scatter's routing input."""

    def __init__(self, slots: np.ndarray, nby: int, nbx: int, cap: int,
                 nr_subgrids: int, grid_size: int, subgrid_size: int,
                 piece_blocks: np.ndarray | None = None):
        self.slots = slots
        self.nby = nby
        self.nbx = nbx
        self.cap = cap
        self.nr_subgrids = nr_subgrids
        self.grid_size = grid_size
        self.subgrid_size = subgrid_size
        self.piece_blocks = piece_blocks

    @property
    def slot_inflation(self) -> float:
        """Padded slots per real piece: the gather's waste factor."""
        if self.nr_subgrids == 0:
            return float("nan")
        return self.slots.size / float(4 * self.nr_subgrids)

    def device_slots(self, device) -> torch.Tensor:
        """slots as a contiguous i32 tensor on `device`, uploaded once."""
        device = torch.device(device)
        return self.cached(("slots", device), lambda: _i32_on(self.slots, device))

    def device_piece_blocks(self, device) -> torch.Tensor:
        device = torch.device(device)
        return self.cached(("piece_blocks", device),
                           lambda: _i32_on(self.piece_blocks, device))


def plan_grid_add(coord_x, coord_y, grid_size: int, subgrid_size: int,
                  cap_align: int = 8) -> GridAddPlan:
    """Build the [NB, cap] slot table from host subgrid coordinates."""
    n = subgrid_size
    g = grid_size
    if g % n:
        raise ValueError(f"grid_size {g} must be a multiple of subgrid_size {n}")
    cx = np.asarray(coord_x).astype(np.int64) % g
    cy = np.asarray(coord_y).astype(np.int64) % g
    s = int(cx.shape[0])
    nby = nbx = g // n
    by, bx = cy // n, cx // n
    ids = np.concatenate([
        ((by + qy) % nby) * nbx + ((bx + qx) % nbx)
        for qy in (0, 1) for qx in (0, 1)
    ])  # [4S], quadrant-major, matching _quadrant_pieces
    nb = nby * nbx
    counts = np.bincount(ids, minlength=nb)
    cap = int(counts.max()) if ids.size else 0
    cap = max(cap_align, ((cap + cap_align - 1) // cap_align) * cap_align)
    order = np.argsort(ids, kind="stable")
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(4 * s) - seg_start[ids[order]]
    nbp = ((nb + 7) // 8) * 8
    slots = np.full((nbp, cap), 4 * s, np.int32)
    slots[ids[order], rank] = order.astype(np.int32)
    return GridAddPlan(slots, nby, nbx, cap, s, g, n, piece_blocks=ids.astype(np.int32))


# Bytes of gathered slot rows per step of `_slot_sum`: the JAX package's
# one-shot rows[slots].sum(1) materializes [nbp, cap, P·N²], 4.8 GB at the
# default problem and 69 GB at 16384².
SLOT_SUM_CHUNK_BYTES = 1 << 28


def _slot_sum(pieces: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """c64[nbp, P·N²]: per block, the sum of its slot rows (sentinel 4S is
    an appended zero row), a chunk of blocks at a time."""
    m = pieces.shape[0]
    d = pieces[0].numel()
    rows = torch.cat([pieces.reshape(m, d), pieces.new_zeros((1, d))])
    slots = slots.to(torch.int64)
    nbp, cap = slots.shape
    out = torch.empty((nbp, d), dtype=pieces.dtype, device=pieces.device)
    step = max(1, SLOT_SUM_CHUNK_BYTES // max(1, cap * d * pieces.element_size()))
    for lo in range(0, nbp, step):
        out[lo:lo + step] = rows[slots[lo:lo + step]].sum(dim=1)
    return out


def subgrids_to_grid_bucketed(sub: torch.Tensor, coord_x, coord_y, grid_size: int,
                              apply_fft: bool = True, plan: GridAddPlan | None = None,
                              grid_in: torch.Tensor | None = None) -> torch.Tensor:
    """Grid-add through the host slot plan and a dense gather/reduce in
    torch ops: quadrant pieces, per block the sum of its slot rows, then
    `_blocks_to_grid`. c64[P, G, G]."""
    if plan is None:
        plan = plan_grid_add(_host(coord_x), _host(coord_y), grid_size, sub.shape[2])
    x = _image_tiles(sub) if apply_fft else sub
    pieces = _quadrant_pieces(x, coord_y, coord_x, grid_size)
    blocks = _slot_sum(pieces, plan.device_slots(pieces.device))
    return _blocks_to_grid(blocks, plan.nby, plan.nbx, plan.subgrid_size, plan.grid_size,
                           x.shape[1], grid_in)


# The JAX package's scoped-VMEM budget for the piece scatter's resident
# grid (idg_tpu/ops/grid.py:460), kept so that `subgrids_to_grid_pallas`'s
# mode="auto" picks the same formulation in both packages.
VMEM_GRID_LIMIT = 32 * 1024 * 1024


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


class GridAddRangePlan(_PlanCache):
    """Host routing for the range grid-adds: per (quadrant, block)
    contiguous runs of block-sorted subgrids. Requires block-sorted coords.

    starts/lens: i32[4, nbp], piece-array offsets (quadrant section q·S
    folded in, what K6 and K7 read) and run lengths; tstarts: the same
    offsets in tile space (what K4 reads); w: the longest run (at least 8);
    nbp: the block count rounded up to a multiple of 8. The tables equal
    the JAX plan's."""

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

    @property
    def nb(self) -> int:
        return self.nby * self.nbx

    def home_blocks(self) -> np.ndarray:
        """i64[S]: each sorted subgrid's home block (quadrant 0's runs)."""
        return np.repeat(np.arange(self.nb), self.lens[0, :self.nb])

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(tstarts, lens) as contiguous i32 tensors on `device`, uploaded
        once per device (K4's tables)."""
        device = torch.device(device)
        return self.cached(("tiles", device), lambda: (
            _i32_on(self.tstarts, device), _i32_on(self.lens, device)))

    def stripe_tables(self, device, lo: int, hi: int):
        """K6's tables for blocks [lo, hi), uploaded once per device and
        stripe: (starts, lens) i32[4, hi − lo] in piece space, and the ids
        (relative to lo) of the blocks with any run, i32[n_occupied]."""
        device = torch.device(device)

        def make():
            lens = self.lens[:, lo:hi]
            occupied = np.nonzero(lens.sum(axis=0))[0]
            return (_i32_on(self.starts[:, lo:hi], device), _i32_on(lens, device),
                    _i32_on(occupied, device))

        return self.cached(("stripe", device, lo, hi), make)


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
# The merged plan (idg_tpu/ops/grid.py:699-785)
# --------------------------------------------------------------------------


class GridAddMergedPlan(_PlanCache):
    """Host routing for the m-merged range grid-add K7 (sparse plans).

    Groups of m consecutive-bx blocks share one window per quadrant,
    [base, base + 2·wm) with base = (gbase // wm)·wm: block-sorted order
    makes the union of m adjacent blocks' runs one contiguous span. K7 sums
    each run clipped to that window. The one exception: qx-shifted quadrants
    at a group with ix0 == 0 pull their j = 0 position from the end of the
    grid row (periodic wrap), usually outside the window; those rows are
    host-listed (miss_rows, destination miss_blocks) and added afterwards.

    Fields: m, wm (merged window), gbase i32[4, ng] window anchors,
    gocc i32[ng] per-group occupancy (misses excluded: a group whose only
    pieces are misses writes zeros and the patch adds them), miss_rows /
    miss_blocks i64[k]: piece rows and their destination block ids."""

    def __init__(self, m, wm, gbase, gocc, miss_rows, miss_blocks):
        self.m = m
        self.wm = wm
        self.gbase = gbase
        self.gocc = gocc
        self.miss_rows = miss_rows
        self.miss_blocks = miss_blocks

    def stripe_tables(self, plan: GridAddRangePlan, device, lo: int, hi: int):
        """K7's tables for blocks [lo, hi) (whole groups), uploaded once per
        device and stripe: (starts, lens) i32[4, hi − lo], gbase
        i32[4, (hi − lo)/m], and the ids (relative to lo/m) of the groups
        with gocc > 0, i32[n_occupied]."""
        device = torch.device(device)
        g0, g1 = lo // self.m, hi // self.m

        def make():
            return (_i32_on(plan.starts[:, lo:hi], device), _i32_on(plan.lens[:, lo:hi], device),
                    _i32_on(self.gbase[:, g0:g1], device),
                    _i32_on(np.nonzero(self.gocc[g0:g1])[0], device))

        return self.cached(("stripe", device, lo, hi), make)


def plan_grid_add_merged(plan: GridAddRangePlan, m: int) -> GridAddMergedPlan | None:
    """Merged-group tables from a per-block range plan. Returns None when
    the plan's geometry doesn't support merging (m ∤ nbx, padded block
    tail, or a pathological window: wm > 16·m suggests a dense plan that
    belongs on the per-block kernels)."""
    nbx, nby, nbp = plan.nbx, plan.nby, plan.nbp
    nb = nby * nbx
    if m < 2 or nbx % m or nbp != nb or nb % m:
        return None
    ng = nb // m
    s4 = plan.starts[:, :nb].reshape(4, ng, m).astype(np.int64)
    l4 = plan.lens[:, :nb].reshape(4, ng, m).astype(np.int64)
    # wrap groups: qx == 1 quadrants (ids 1, 3 in _QUADRANTS order) at
    # ix0 == 0, where position j = 0 sources the row-end block
    wrap_g = (np.arange(ng) * m) % nbx == 0
    outlier = np.zeros((4, ng, m), bool)
    outlier[1, wrap_g, 0] = True
    outlier[3, wrap_g, 0] = True
    big = np.int64(1) << 60
    r0 = np.where(outlier, big, s4).min(axis=2)              # [4, ng]
    end = np.where(outlier, -1, s4 + l4).max(axis=2)
    empty = np.where(outlier, 0, l4).sum(axis=2) == 0
    r0 = np.where(empty, 0, r0)
    end = np.where(empty, 0, np.maximum(end, r0))
    span = int((end - r0).max()) if ng else 0
    wm = max(8, -(-span // 8) * 8)
    if wm > 16 * m:
        return None
    gbase = r0.astype(np.int32)
    base = (r0 // wm) * wm
    # misses: outlier rows not covered by [base, base + 2wm)
    miss_rows, miss_blocks = [], []
    for q in (1, 3):
        for g in np.nonzero(wrap_g)[0]:
            o0 = int(s4[q, g, 0])
            oln = int(l4[q, g, 0])
            if not oln:
                continue
            lo_cov, hi_cov = int(base[q, g]), int(base[q, g]) + 2 * wm
            for r in range(o0, o0 + oln):
                if not (lo_cov <= r < hi_cov):
                    miss_rows.append(r)
                    miss_blocks.append(g * m)
    gocc = np.where(outlier, 0, l4).sum(axis=(0, 2)).astype(np.int32)
    return GridAddMergedPlan(
        m, wm, gbase, gocc,
        np.asarray(miss_rows, np.int64), np.asarray(miss_blocks, np.int64),
    )


# --------------------------------------------------------------------------
# Dispatch (idg_tpu/ops/grid.py:1320-1387, 1499-1760, 1884-2161)
# --------------------------------------------------------------------------


def ranges_route(plan: GridAddRangePlan, apply_fft: bool = True, nr_correlations: int = 4) -> str:
    """Which grid-add `subgrids_to_grid_ranges` takes for this plan (the
    JAX dispatch, grid.py:1940-2021): "bucketed" when P·N² is not a
    multiple of 1024, "tile" (K4) with apply_fft on plans of at most 2·S
    blocks, "sparse" (masked pieces + K6) with apply_fft on sparser ones,
    "quadrant" (quadrant pieces + K6) without the FFT."""
    if nr_correlations * plan.subgrid_size ** 2 % 1024:
        return "bucketed"
    if not apply_fft:
        return "quadrant"
    return "tile" if plan.nbp <= 2 * plan.nr_subgrids else "sparse"


ROUTE_KERNELS = {
    "bucketed": "slot-plan gather in torch ops (no kernel)",
    "tile": "range grid-add K4 (grid_add_cuda)",
    "sparse": "masked pieces + piece range grid-add K6 (grid_add_pieces_cuda)",
    "quadrant": "quadrant pieces + piece range grid-add K6 (grid_add_pieces_cuda)",
}


def subgrids_to_grid_ranges(sub, coord_x, coord_y, grid_size: int, apply_fft: bool = True,
                            grid_in: torch.Tensor | None = None,
                            plan: GridAddRangePlan | None = None,
                            tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Grid-add through the range kernels: c64[P, G, G]. Requires
    block-sorted coords. The route is `ranges_route`'s: K4 on the tile
    path, the masked or quadrant pieces and K6 otherwise, the bucketed
    gather when P·N² % 1024 ≠ 0.

    `tiles` supplies block-rolled pieces already (the gridder's fused
    epilogue, ``gridder_cuda_v6_pieces``; it implies apply_fft) and `sub`
    is then ignored; otherwise they are produced from the uv subgrids `sub`
    (image-domain tiles with apply_fft=False). Coordinates may be host
    arrays or tensors; on the tensors' device no copy is made. `grid_in`
    is added to the result."""
    from .cuda.grid import grid_add_cuda, grid_add_pieces_cuda

    if tiles is not None and not apply_fft:
        raise ValueError("tiles implies apply_fft=True (they are already phase-rolled "
                         "iDFT output)")
    x = tiles if tiles is not None else sub
    _, p, n, _ = x.shape
    if plan is None:
        plan = plan_grid_add_ranges(_host(coord_x), _host(coord_y), grid_size, n)
    route = ranges_route(plan, apply_fft, p)
    if route == "bucketed":
        if tiles is not None:
            raise ValueError("tiles requires the range kernels' P·N² % 1024 == 0")
        return subgrids_to_grid_bucketed(sub, coord_x, coord_y, grid_size, apply_fft,
                                         grid_in=grid_in)
    oyx = _rolls(coord_x, coord_y, grid_size, n, x.device)
    if route == "quadrant":
        grid = grid_add_pieces_cuda(_quadrant_pieces(sub, coord_y, coord_x, grid_size), plan)
    else:
        if tiles is None:
            tiles = pieces_from_subgrids(sub, oyx)
        if route == "tile":
            grid = grid_add_cuda(tiles, oyx, plan, grid_size)
        else:
            grid = grid_add_pieces_cuda(_mask_pieces(tiles, oyx[:, 0], oyx[:, 1]), plan)
    return grid if grid_in is None else grid + grid_in


# Blocks per stripe of the streamed grid-adds (idg_tpu/ops/grid.py:587).
# The JAX package striped to bound its SMEM scalar tables; the port keeps
# the stripes as the streamed path's unit of output, so that one band
# (537 MB at 16384²) is live at a time under `consume`.
MAX_RANGE_BLOCKS = 16384

# The merge widths tried for sparse plans, widest first (grid.py:1585-1597).
MERGE_LADDER = (64, 32, 16)


def merged_plan_for(plan: GridAddRangePlan, merge: int | None = None):
    """The GridAddMergedPlan the streamed grid-add takes, or None for the
    per-block K6: merge=None auto-picks (IDG_GRID_MERGE overrides; sparse
    plans, nb ≥ 8·S, try MERGE_LADDER; dense plans none), 0 forces per-block.
    Memoized on the plan."""
    if merge is None:
        env = get_env_var("IDG_GRID_MERGE", -1)
        sparse = plan.nb >= 8 * plan.nr_subgrids
        candidates = [env] if env >= 0 else (list(MERGE_LADDER) if sparse else [])
    else:
        candidates = [merge]
    for m in candidates:
        if not m:
            break
        mplan = plan.cached(("merged", m), lambda m=m: plan_grid_add_merged(plan, m))
        if mplan is not None:
            return mplan
    return None


def wrap_patch_rows(plan: GridAddRangePlan, mplan: GridAddMergedPlan):
    """(rows, blocks) i64[k]: the piece rows the wrap-miss patch adds after
    K7, and their destination blocks: the plan's miss_rows, and the outlier
    rows of wrap groups with gocc == 0 that the window covers. K7 skips such
    a group, so the window does not sum them, and the JAX plan does not list
    them as misses, so its merged path drops them (ROADMAP Queue 3). They
    occur only when q·S plus the run's start is below 2·wm (S of a few
    subgrids). Memoized on the merged plan."""
    def make():
        m, wm = mplan.m, mplan.wm
        ng = plan.nb // m
        wrap = np.nonzero(((np.arange(ng) * m) % plan.nbx == 0) & (mplan.gocc == 0))[0]
        rows, blocks = [mplan.miss_rows], [mplan.miss_blocks]
        for q in (1, 3):
            for g in wrap:
                c = g * m
                r = np.arange(plan.starts[q, c], plan.starts[q, c] + plan.lens[q, c])
                base = int(mplan.gbase[q, g]) // wm * wm
                r = r[(r >= base) & (r < base + 2 * wm)]
                rows.append(r)
                blocks.append(np.full(r.size, c))
        return (np.concatenate(rows).astype(np.int64),
                np.concatenate(blocks).astype(np.int64))

    return mplan.cached("patch_rows", make)


def _miss_patch_index(plan: GridAddRangePlan, mplan: GridAddMergedPlan, lo: int, hi: int,
                      p: int, device):
    """(rows, flat): the stripe's patch rows (`wrap_patch_rows`), i64[k],
    and the flat element index of each of their pixels in the stripe's
    band viewed as [P·rows·N·G] (float pairs), i64[k·P·N²]. Memoized on the
    merged plan."""
    def make():
        rows, blocks = wrap_patch_rows(plan, mplan)
        sel = (blocks >= lo) & (blocks < hi)
        n, nbx = plan.subgrid_size, plan.nbx
        g, band_rows = plan.grid_size, (hi - lo) // nbx * n
        by, bx = np.divmod(blocks[sel] - lo, nbx)
        pix = ((np.arange(p)[:, None, None] * band_rows + np.arange(n)[None, :, None]) * g
               + np.arange(n)[None, None, :])                            # [P, N, N]
        flat = (by * n * g + bx * n)[:, None, None, None] + pix[None]
        return (torch.as_tensor(rows[sel], device=device),
                torch.as_tensor(flat.reshape(-1), device=device))

    return mplan.cached(("patch", torch.device(device), lo, hi, p), make)


def _patch_misses(band: torch.Tensor, pieces: torch.Tensor, plan: GridAddRangePlan,
                  mplan: GridAddMergedPlan, lo: int, hi: int) -> None:
    """Add the stripe's wrap-patch rows into K7's band, in place (index_add_
    on float pairs; the JAX package's scatter-add post-pass)."""
    rows, flat = _miss_patch_index(plan, mplan, lo, hi, pieces.shape[1], band.device)
    if rows.numel():
        torch.view_as_real(band).view(-1, 2).index_add_(
            0, flat, torch.view_as_real(pieces[rows]).reshape(-1, 2))


def subgrids_to_grid_ranges_streamed(sub: torch.Tensor, coord_x, coord_y, grid_size: int,
                                     apply_fft: bool = True,
                                     plan: GridAddRangePlan | None = None,
                                     merge: int | None = None, consume=None):
    """`subgrids_to_grid_ranges` for grids of several GB (e.g. 16384²
    full-pol, 8.6 GB): the masked (or, without the FFT, quadrant) pieces
    are made once, then each stripe of MAX_RANGE_BLOCKS blocks (whole block
    rows) is added into its own c64[P, rows·N, G] band, by K6 per block or,
    when `merged_plan_for(plan, merge)` gives a merged plan, by K7 per group
    of m blocks plus the wrap-miss patch (`wrap_patch_rows`). Requires
    block-sorted coords.

    Returns the tuple of bands in row order, not concatenated (that would
    be one more full-grid copy). With `consume` (band → small tensors),
    each band is reduced as soon as it is made and dropped, and the list of
    reductions is returned: only one band is ever live. The JAX package
    throttled its stripe queue every 4 stripes because PJRT allocates
    outputs at enqueue time; eager torch allocates a band when its stripe
    is issued and frees it when `consume` drops it, so there is no
    throttle."""
    from .cuda.grid import grid_add_merged_cuda, grid_add_pieces_cuda

    _, p, n, _ = sub.shape
    if plan is None:
        plan = plan_grid_add_ranges(_host(coord_x), _host(coord_y), grid_size, n)
    if p * n * n % 1024:
        raise ValueError(f"the streamed range grid-add needs P·N² % 1024 == 0, got {p * n * n}")
    mplan = merged_plan_for(plan, merge)
    if apply_fft:
        oyx = _rolls(coord_x, coord_y, grid_size, n, sub.device)
        pieces = _mask_pieces(pieces_from_subgrids(sub, oyx), oyx[:, 0], oyx[:, 1])
    else:
        pieces = _quadrant_pieces(sub, coord_y, coord_x, grid_size)
    nbx, nb = plan.nbx, plan.nb
    stripe = max(nbx, (MAX_RANGE_BLOCKS // nbx) * nbx)
    out = []
    for lo in range(0, nb, stripe):
        hi = min(lo + stripe, nb)
        if mplan is None:
            band = grid_add_pieces_cuda(pieces, plan, lo, hi)
        else:
            band = grid_add_merged_cuda(pieces, plan, mplan, lo, hi)
            _patch_misses(band, pieces, plan, mplan, lo, hi)
        out.append(band if consume is None else consume(band))
        del band   # before the next stripe allocates its band
    return out if consume is not None else tuple(out)


def slot_kernel_mode(plan: GridAddPlan, nr_correlations: int = 4, mode: str = "auto") -> str:
    """The formulation `subgrids_to_grid_pallas` takes (grid.py:2089-2095):
    "auto" is "vmem" when the JAX package's resident block array,
    nbp·P·N² f32 per component, fits VMEM_GRID_LIMIT, else "gather"; a plan
    without piece_blocks takes "gather"."""
    if mode not in ("auto", "vmem", "gather"):
        raise ValueError(f"mode must be auto, vmem or gather, got {mode!r}")
    if mode == "auto":
        d = nr_correlations * plan.subgrid_size ** 2
        mode = "vmem" if plan.slots.shape[0] * d * 4 <= VMEM_GRID_LIMIT else "gather"
    if mode == "vmem" and plan.piece_blocks is None:
        mode = "gather"
    return mode


def subgrids_to_grid_pallas(sub: torch.Tensor, coord_x, coord_y, grid_size: int,
                            apply_fft: bool = True, grid_in: torch.Tensor | None = None,
                            plan: GridAddPlan | None = None, mode: str = "auto") -> torch.Tensor:
    """Grid-add of quadrant pieces through the slot plan's kernels, picked
    by `slot_kernel_mode`: "vmem", the piece scatter K11a
    (``grid_add_scatter_cuda``), or "gather", the slot gather K11b
    (``grid_add_slots_cuda``). P·N² % 1024 ≠ 0 takes the bucketed gather.
    The JAX package's rows_per_step (its gather's Pallas pipelining depth)
    has no counterpart. c64[P, G, G]."""
    from .cuda.grid import grid_add_scatter_cuda, grid_add_slots_cuda

    if plan is None:
        plan = plan_grid_add(_host(coord_x), _host(coord_y), grid_size, sub.shape[2])
    x = _image_tiles(sub) if apply_fft else sub
    _, p, n, _ = x.shape
    d = p * n * n
    if d % 1024:
        return subgrids_to_grid_bucketed(x, coord_x, coord_y, grid_size, apply_fft=False,
                                         plan=plan, grid_in=grid_in)
    mode = slot_kernel_mode(plan, p, mode)
    pieces = _quadrant_pieces(x, coord_y, coord_x, grid_size)
    if mode == "vmem":
        grid = grid_add_scatter_cuda(pieces, plan)
    else:
        grid = grid_add_slots_cuda(pieces, plan)
    return grid if grid_in is None else grid + grid_in


def grid_to_subgrids_ranges(grid: torch.Tensor, coord_x, coord_y, subgrid_size: int,
                            apply_fft: bool = True, pieces: bool = False) -> torch.Tensor:
    """Extraction through the range kernel K5 (``ops/cuda/grid.py:
    grid_extract_cuda``): c64[S, P, N, N]. With pieces=True, the
    block-rolled image-domain pieces for a consumer that fuses the DFT (the
    degridder's fused prologue); otherwise uv subgrids (image-domain tiles
    with apply_fft=False; `_finish_extract`). P·N² % 1024 ≠ 0 takes the
    plain gather `grid_to_subgrids`, as in the JAX package. The kernel
    needs no plan and no sorted coords; the pipeline sorts them for the
    grid-add's sake."""
    from .cuda.grid import grid_extract_cuda

    p, g, _ = grid.shape
    n = subgrid_size
    if p * n * n % 1024:
        if pieces:
            raise ValueError(f"pieces=True needs the range kernel's P·N² % 1024 == 0, "
                             f"got {p * n * n}")
        return grid_to_subgrids(grid, coord_x, coord_y, n, apply_fft)
    cx, cy = (_coords_on(c, grid.device).to(torch.int32) for c in (coord_x, coord_y))
    rolled = grid_extract_cuda(grid, cx, cy, n)
    if pieces:
        return rolled
    return _finish_extract(rolled, _rolls(cx, cy, g, n, grid.device), apply_fft)
