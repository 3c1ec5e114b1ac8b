"""A model of the gridder K1's turned product at N = 32 (csrc/gridder.cu:
mma_rank_turned, fold_rank_turned and the consumers' epilogue store): the
lhs rows (y, re | im) and W's rows (q = p·N + x, re | im), both in
alternating groups of 8, the m64n128k8 accumulators each consumer thread
holds (wgmma.cuh's ownership), and the fold's formulas, against the complex
product the kernel computes, out[y, q] = Σ_v lhs[v, y] · W[v, q]."""

import numpy as np
import pytest

N, P, KT = 32, 4, 32          # subgrid size, pols, visibilities a tile
GROUPS, COLS = 2, 128         # consumer warpgroups, W's columns a warpgroup


def operand_row(a: int, part: int) -> int:
    """The row of (a, re | im) in an operand whose 8-row groups alternate
    between the real and the imaginary parts (the producers' store index)."""
    return (a >> 3) * 16 + (a & 7) + 8 * part


def accumulators(d: np.ndarray, warp: int, lane: int) -> np.ndarray:
    """The registers of one thread of a warpgroup after a wgmma m64nNk8 into
    D: d[4j + 2h + e] = D[16·warp + g + 8h][8j + 2t + e], g = lane / 4,
    t = lane % 4."""
    g, t = lane // 4, lane % 4
    regs = np.empty(d.shape[1] // 2)
    for j in range(d.shape[1] // 8):
        for h in range(2):
            for e in range(2):
                regs[4 * j + 2 * h + e] = d[16 * warp + g + 8 * h, 8 * j + 2 * t + e]
    return regs


def fold(regs: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """fold_rank_turned's sums of one rank: sum[2i + e] = w · (re + i·im)."""
    out = np.empty(16, dtype=complex)
    for i in range(8):
        for e in range(2):
            re = regs[8 * i + e] - regs[8 * i + 6 + e]
            im = regs[8 * i + 4 + e] + regs[8 * i + 2 + e]
            out[2 * i + e] = weights[2 * (i % 4) + e] * (re + 1j * im)
    return out


def operands(lhs: np.ndarray, w: np.ndarray):
    """The real operands of one tile as the producers store them: A [64 ×
    KT] from lhs [KT, N] and B [2NP × KT] from W [KT, NP]."""
    a = np.empty((2 * N, KT))
    b = np.empty((2 * N * P, KT))
    for y in range(N):
        a[operand_row(y, 0)], a[operand_row(y, 1)] = lhs[:, y].real, lhs[:, y].imag
    for q in range(N * P):
        b[operand_row(q, 0)], b[operand_row(q, 1)] = w[:, q].real, w[:, q].imag
    return a, b


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_turned_fold_gives_every_output_once(rank):
    """Each of the 256 consumer threads folds the accumulators of its
    warpgroup's m64n128k8 product (A = the lhs, B = its half of W's rows)
    into 16 outputs, weighted by n[y][x]^rank from the 8 weights it holds;
    together they give every (p, y, x) of the complex product exactly once,
    where the epilogue stores it."""
    rng = np.random.default_rng(20 + rank)
    lhs = rng.normal(size=(KT, N)) + 1j * rng.normal(size=(KT, N))
    w = rng.normal(size=(KT, N * P)) + 1j * rng.normal(size=(KT, N * P))
    n = rng.uniform(0.5, 1.0, size=(N, N))
    want = (lhs.T @ w).reshape(N, P, N) * (n ** rank)[:, None, :]   # [y, p, x]
    a, b = operands(lhs, w)
    got = np.full((N, P, N), np.nan, dtype=complex)
    for wg in range(GROUPS):
        d = a @ b[COLS * wg:COLS * (wg + 1)].T                        # [64 × 128]
        for tid in range(128 * wg, 128 * (wg + 1)):
            warp, lane, t4 = (tid % 128) // 32, tid % 32, tid % 4
            y = (tid & 127) // 32 * 8 + (tid & 31) // 4
            weights = np.array([n[y, 8 * (i // 2) + 2 * t4 + i % 2] for i in range(8)])
            sums = fold(accumulators(d, warp, lane), weights ** rank)
            for i in range(8):
                for e in range(2):
                    p, x = 2 * wg + i // 4, 8 * (i % 4) + 2 * t4 + e
                    assert np.isnan(got[y, p, x])
                    got[y, p, x] = sums[2 * i + e]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_turned_operands_fill_whole_core_matrices():
    """The lhs's 64 rows and each warpgroup's 128 columns of W are whole
    8-row groups, a group's 8 rows one part (re or im) of 8 consecutive
    positions: the layout the producers' 16-byte stores and the unswizzled
    wgmma descriptors share (wgmma.cuh)."""
    for rows in (N, N * P):
        seen = sorted(operand_row(a, part) for a in range(rows) for part in range(2))
        assert seen == list(range(2 * rows))
        for a in range(rows):
            assert operand_row(a, 0) // 8 + 1 == operand_row(a, 1) // 8
            assert operand_row(a, 0) % 8 == a % 8
