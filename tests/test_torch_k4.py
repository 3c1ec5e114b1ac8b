"""K4, the range grid-add from tiles (csrc/grid_add.cu), as the kernel
decomposes it, against the JAX package on identical numpy inputs, at small
size on the CPU.

A plain model of the kernel's decomposition: one work item per (grid
block, pol) in block order; the item reads its block's row of the plan's
table (`GridAddRangePlan.block_runs`: four run starts, four lengths),
stages its entries as the kernel does (`kernel_entries`: piece, roll and
quadrant of each), sums the pixel pairs that each entry's quadrant mask
keeps in entry order, and writes its block once (zeros for an empty
block). The table and the staged entries are held against a direct numpy
reckoning of each block's runs; the model exactly against the
straightforward per-block loop (the same summation order), and at the
reference's 1e-5 gate against `grid_add_plain` (index_add_, another order)
and JAX's `subgrids_to_grid_ranges` (its tile kernel in interpret mode on a
tile plan, its masked-piece route on a sparse one), as
tests/test_torch_grid.py runs it. The kernel meets the same order's sums
exactly on the card (tests/test_torch_cuda.py).

Problems: G ≤ 256, N ∈ {16, 32}, a tile plan (nbp ≤ 2·S) and a sparse one,
with rolls oy, ox ∈ {0, odd, N − 1} and subgrids on the last block row and
column, whose pieces wrap around the grid edge into block row / column 0.
"""

import numpy as np
import pytest
import torch

import idg_tpu.ops.grid as jgrid
import idg_tpu_torch.ops.grid as tgrid
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
P = 4
# (plan, N, G, S): 64 blocks ≤ 2·S on the tile plans, 256 or 64 > 2·S on the sparse
CASES = [("tile", 16, 128, 40), ("sparse", 16, 256, 20), ("tile", 32, 256, 40),
         ("sparse", 32, 256, 12)]


def _problem(kind, n, g, s):
    """Block-sorted coords with rolls from {0, 5, N − 1} on both axes, a
    quarter of the subgrids on the last block row or column (they wrap),
    and c64 uv subgrids, all from numpy draws."""
    rng = np.random.default_rng(13)
    nbx = g // n
    bx, by = rng.integers(0, nbx, s), rng.integers(0, nbx, s)
    bx[:s // 8], by[s // 8:s // 4] = nbx - 1, nbx - 1
    rolls = np.array([0, 5, n - 1])
    cx = bx * n + rolls[rng.integers(0, 3, s)]
    cy = by * n + rolls[rng.integers(0, 3, s)]
    order = tgrid.block_sort_order(cx, cy, g, n)
    cx, cy = cx[order].astype(np.int32), cy[order].astype(np.int32)
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    assert (plan.nbp <= 2 * s) == (kind == "tile")
    sub = (rng.normal(size=(s, P, n, n)) + 1j * rng.normal(size=(s, P, n, n))).astype(np.complex64)
    oyx = torch.from_numpy(tgrid.roll_offsets(cx, cy, g, n))
    return cx, cy, plan, torch.from_numpy(sub), oyx


def _masked(piece, oy, ox, q):
    """The pixels of one piece c64[P, N, N] that quadrant q keeps, zeros
    elsewhere (the kernel adds a masked pixel pair's selected half as 0)."""
    qy, qx = tgrid._QUADRANTS[q]
    i = torch.arange(piece.shape[-1])
    keep = (((i >= oy) == (qy == 0))[:, None]) & (((i >= ox) == (qx == 0))[None, :])
    return torch.where(keep, piece, torch.zeros((), dtype=piece.dtype))


def kernel_entries(plan, oyx, b):
    """i64[total, 2]: the entries the kernel stages for block b, in its
    order: (piece t, oy | ox << 8 | q << 16) for the concatenated runs of
    quadrants 0–3, t and q from the entry index e and the block's row of
    `block_runs` as the kernel computes them."""
    s0, s1, s2, s3, l0, l1, l2, l3 = (int(v) for v in plan.block_runs()[b])
    e1 = l0
    e2 = e1 + l1
    e3 = e2 + l2
    total = e3 + l3
    e = np.arange(total)
    q = (e >= e1).astype(np.int64) + (e >= e2) + (e >= e3)
    t = e + np.choose(q, [s0, s1 - e1, s2 - e2, s3 - e3])
    o = oyx.numpy()[t].astype(np.int64)
    return np.stack([t, o[:, 0] | (o[:, 1] << 8) | (q << 16)], axis=-1)


def k4_model(pieces, oyx, plan):
    """K4's decomposition: per (block, pol) item, the staged entries summed
    in order, each entry's row mask on whole rows and its column mask as
    the kernel's pixel-pair selects (pair (2c, 2c + 1) kept half by half);
    each block written once."""
    n, g = plan.subgrid_size, plan.grid_size
    grid = torch.full((P, g, g), float("nan"), dtype=torch.complex64)
    rows = torch.arange(n)
    j0 = 2 * torch.arange(n // 2)
    for b in range(plan.nb):
        acc = torch.zeros((P, n, n // 2, 2), dtype=torch.complex64)
        for t, packed in kernel_entries(plan, oyx, b):
            oy, ox, q = packed & 0xFF, (packed >> 8) & 0xFF, packed >> 16
            top, left = q < 2, (q & 1) == 0
            keep = torch.stack([(j0 >= ox) == left, (j0 + 1 >= ox) == left], dim=-1)
            keep = ((rows >= oy) == top)[:, None, None] & keep[None]       # [N, N/2, 2]
            acc += torch.where(keep, pieces[t].reshape(P, n, n // 2, 2),
                               torch.zeros((), dtype=torch.complex64))
        by, bx = divmod(b, plan.nbx)
        grid[:, by * n:(by + 1) * n, bx * n:(bx + 1) * n] = acc.reshape(P, n, n)
    return grid


def per_block_loop(pieces, oyx, plan):
    """The straightforward order: block by block, quadrant by quadrant,
    the plan's run in order."""
    n, g = plan.subgrid_size, plan.grid_size
    grid = torch.zeros((P, g, g), dtype=torch.complex64)
    for b in range(plan.nb):
        by, bx = divmod(b, plan.nbx)
        for q in range(4):
            t0 = int(plan.tstarts[q, b])
            for t in range(t0, t0 + int(plan.lens[q, b])):
                grid[:, by * n:(by + 1) * n, bx * n:(bx + 1) * n] += \
                    _masked(pieces[t], int(oyx[t, 0]), int(oyx[t, 1]), q)
    return grid


def _gate(got, want):
    res = check_error(got, want, verbose=False)
    assert res.mean_error <= GATE, res


def _pair(x):
    x = x.numpy()
    return np.ascontiguousarray(x.real, np.float32), np.ascontiguousarray(x.imag, np.float32)


@pytest.mark.parametrize("kind,n,g,s", CASES)
def test_block_runs_and_staged_entries_match_numpy_reckoning(kind, n, g, s):
    """The plan's K4 table holds each block's four runs (start: the
    subgrids of earlier home blocks; length: those of the quadrant's source
    block), and the staged entries are those runs in quadrant order,
    reckoned from the home blocks directly; every piece enters each
    quadrant once, and the entries' masks cover every pixel once."""
    cx, cy, plan, _, oyx = _problem(kind, n, g, s)
    home = (cy % g // n) * plan.nbx + cx % g // n
    runs = plan.block_runs()
    assert runs.shape == (plan.nb, 8) and runs.dtype == np.int32
    seen = np.zeros((4, s), np.int64)
    pixels = 0
    for b in range(plan.nb):
        iy, ix = divmod(b, plan.nbx)
        want = []
        for q, (qy, qx) in enumerate(tgrid._QUADRANTS):
            src = ((iy - qy) % plan.nby) * plan.nbx + (ix - qx) % plan.nbx
            assert (runs[b, q], runs[b, 4 + q]) == ((home < src).sum(), (home == src).sum())
            want += [(t, int(cy[t] % n) | int(cx[t] % n) << 8 | q << 16)
                     for t in np.nonzero(home == src)[0]]
        got = kernel_entries(plan, oyx, b)
        assert [tuple(e) for e in got.tolist()] == want
        for t, packed in got:
            oy, ox, q = packed & 0xFF, (packed >> 8) & 0xFF, packed >> 16
            seen[q, t] += 1
            pixels += (oy if q >= 2 else n - oy) * (ox if q & 1 else n - ox)
    assert (seen == 1).all() and pixels == s * n * n
    assert (runs[:, 4:].sum(axis=1) == 0).any() or kind == "tile"


@pytest.mark.parametrize("kind,n,g,s", CASES)
def test_model_matches_plain_and_jax(kind, n, g, s):
    cx, cy, plan, sub, oyx = _problem(kind, n, g, s)
    pieces = tgrid.pieces_from_subgrids(sub, oyx)
    model = k4_model(pieces, oyx, plan)
    assert torch.equal(model, per_block_loop(pieces, oyx, plan))
    empty = np.nonzero(plan.lens[:, :plan.nb].sum(axis=0) == 0)[0]
    assert empty.size or kind == "tile"
    for b in empty:
        by, bx = divmod(int(b), plan.nbx)
        assert not model[:, by * n:(by + 1) * n, bx * n:(bx + 1) * n].any()
    _gate(model, kernels.grid_add_plain(pieces, oyx, plan, g))
    want = jgrid.subgrids_to_grid_ranges(_pair(sub), cx, cy, g, apply_fft=True,
                                         interpret=True)
    _gate(model, np.asarray(want[0]) + 1j * np.asarray(want[1]))
    # the port's dispatch reaches K4 on both plans; on CPU tensors it is the plain version
    assert tgrid.ranges_route(plan) == "tile"
    _gate(tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, plan=plan), model)
