"""A model of the degridder K2's turned product at N = 32 and rank ≤ 2
(csrc/degridder.cu, the kTurned instances): the tile's rows (v, re | im) as
the A operand in alternating groups of 8, rank 1's weight folded into its
rows (swapped, ±μ), the lhs's 128 rows (p, y) as the B operand, the
m64n128k8 accumulators each consumer thread holds (wgmma.cuh's ownership),
the swizzled Φy table, stage 2's sums and the quad's reduction, against the
complex product the kernel computes (its header):

    vis[v, p] = Σ_r conj((iμ_v)^r / r!) Σ_y conj(Φy[v, y])
                  Σ_x lhs_r[(p, y), x] · conj(Φx[v, x])
"""

import numpy as np
import pytest

N, P, VT = 32, 4, 32           # subgrid size, pols, visibilities a tile
K = 2 * N                      # contraction: x (re) | x (im)


def operand_row(a: int, part: int) -> int:
    """The row of (a, re | im) in an operand whose 8-row groups alternate
    between the real and the imaginary parts (the producers' store index)."""
    return (a >> 3) * 16 + (a & 7) + 8 * part


def phy_unit(v: int, q: int) -> int:
    """degridder.cu:phy_unit, the 16-byte unit of Φy[v][2q, 2q + 1]."""
    return v * 16 + (q ^ (((v & 1) << 2) | ((v >> 1) & 3)))


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


def a_operands(phx: np.ndarray, mu: np.ndarray):
    """A [64 × K] of one tile as the producers store it, rank 0 and rank 1's
    folded rows: the real row [Φx_re | Φx_im], the imaginary row
    [−Φx_im | Φx_re]; rank 1 μ·[−Φx_im | Φx_re] and −μ·[Φx_re | Φx_im]."""
    a0, a1 = np.empty((2 * VT, K)), np.empty((2 * VT, K))
    for v in range(VT):
        c, s = phx[v].real, phx[v].imag
        a0[operand_row(v, 0)] = np.concatenate([c, s])
        a0[operand_row(v, 1)] = np.concatenate([-s, c])
        a1[operand_row(v, 0)] = mu[v] * np.concatenate([-s, c])
        a1[operand_row(v, 1)] = -mu[v] * np.concatenate([c, s])
    return a0, a1


def phy_table(phy: np.ndarray) -> np.ndarray:
    """The tile's Φy as the producers store it: producer (pv, pc) writes its
    y = 4pc .. 4pc + 3 as two units (re, im, re, im); every unit once."""
    table = np.full((VT * 16, 4), np.nan)
    for pv in range(VT):
        for pc in range(N // 4):
            for half in range(2):
                u = phy_unit(pv, 2 * pc + half)
                assert np.isnan(table[u]).all()
                y = 4 * pc + 2 * half
                table[u] = [phy[pv, y].real, phy[pv, y].imag,
                            phy[pv, y + 1].real, phy[pv, y + 1].imag]
    assert not np.isnan(table).any()
    return table


def stage2(d: np.ndarray, f: np.ndarray) -> list:
    """One thread's Σ over its 8 y of conj(Φy) · D, per pol, with the
    kernel's formulas (f[jj]: Φy at y = 8jj + 2t and + 1)."""
    part = []
    for p in range(P):
        re = im = 0.0
        for jj in range(4):
            dj = d[4 * (4 * p + jj):]
            re += f[jj][0] * dj[0] + f[jj][1] * dj[2] + f[jj][2] * dj[1] + f[jj][3] * dj[3]
            im += f[jj][0] * dj[2] - f[jj][1] * dj[0] + f[jj][2] * dj[3] - f[jj][3] * dj[1]
        part.append(complex(re, im))
    return part


def quad_reduce(parts: list) -> list:
    """The quad's two xor-shuffle steps (lanes t4 ^ 2, then t4 ^ 1), each
    lane's values as the kernel selects them; returns each lane's total."""
    step = []
    for t4 in range(4):
        b2 = t4 & 2
        keep = (parts[t4][2], parts[t4][3]) if b2 else (parts[t4][0], parts[t4][1])
        step.append(keep)
    sent = []
    for t4 in range(4):
        b2 = t4 & 2
        sent.append((parts[t4][0], parts[t4][1]) if b2 else (parts[t4][2], parts[t4][3]))
    k = [(step[t][0] + sent[t ^ 2][0], step[t][1] + sent[t ^ 2][1]) for t in range(4)]
    out = []
    for t4 in range(4):
        b1 = t4 & 1
        s_partner = k[t4 ^ 1][0] if (t4 ^ 1) & 1 else k[t4 ^ 1][1]
        out.append((k[t4][1] if b1 else k[t4][0]) + s_partner)
    return out


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("mu_kind", ["zero", "nonzero"])
@pytest.mark.parametrize("rank", [1, 2])
def test_turned_k2_tile_gives_every_visibility_once(rank, mu_kind, ragged):
    """Each consumer warpgroup's m64n128k8 product of a whole tile (A its
    slot's rows, rank 1 folded in, B the lhs's rows (p, y)), read from the
    accumulators each thread holds, summed over its 8 y against the
    swizzled Φy table and reduced over the quad, stores every live (v, p)
    of the tile once, equal to the complex product; past V (a ragged last
    tile) the rows repeat the last visibility and nothing is stored."""
    rng = np.random.default_rng(22 + 10 * rank + (mu_kind == "zero") + 2 * ragged)
    live = 23 if ragged else VT
    phx, phy = (np.exp(1j * rng.uniform(-np.pi, np.pi, size=(live, N))) for _ in range(2))
    mu = np.zeros(live) if mu_kind == "zero" else rng.uniform(-2e-3, 2e-3, live)
    lhs = [rng.normal(size=(P * N, N)) + 1j * rng.normal(size=(P * N, N)) for _ in range(rank)]
    want = np.zeros((live, P), dtype=complex)
    for r in range(rank):
        weight = np.conj((1j * mu) ** r)   # / r!, 1 for r ≤ 1
        d = (lhs[r] @ np.conj(phx).T).reshape(P, N, live)   # [p, y, v]
        want += weight[:, None] * np.einsum("vy,pyv->vp", np.conj(phy), d)

    # the slot as the producers form it: visibility vc = min(v, V − 1)
    rows = [min(v, live - 1) for v in range(VT)]
    a0, a1 = a_operands(phx[rows], mu[rows])
    table = phy_table(phy[rows])
    b = [np.concatenate([m.real, m.imag], axis=1) for m in lhs]   # [(p, y), K]
    dt = a0 @ b[0].T + (a1 @ b[1].T if rank > 1 else 0.0)        # [64 × 128]

    got = np.full((VT, P), np.nan, dtype=complex)
    for warp in range(4):
        for g in range(8):
            vl = 8 * warp + g
            parts = []
            for t4 in range(4):
                lane = 4 * g + t4
                f = [table[phy_unit(vl, 4 * jj + t4)] for jj in range(4)]
                for jj in range(4):
                    y = 8 * jj + 2 * t4
                    np.testing.assert_array_equal(
                        f[jj], [phy[rows[vl], y].real, phy[rows[vl], y].imag,
                                phy[rows[vl], y + 1].real, phy[rows[vl], y + 1].imag])
                parts.append(stage2(accumulators(dt, warp, lane), f))
            totals = quad_reduce(parts)
            for t4 in range(4):
                if vl < live:   # store_live: lane t4 stores pol t4
                    assert np.isnan(got[vl, t4])
                    got[vl, t4] = totals[t4]
    assert np.isnan(got[live:]).all()
    np.testing.assert_allclose(got[:live], want, rtol=1e-12, atol=1e-12)


def test_turned_k2_swizzle_has_no_bank_conflicts():
    """Φy's swizzle: the producers' 16-byte stores (8 consecutive v, one
    pair index) and stage 2's loads (a quarter warp: v and v + 1 at four
    consecutive pair indices) each reach 8 distinct 16-byte bank groups;
    A's rows (v, re | im) take whole core matrices, 8 consecutive v one
    group's 8 rows."""
    for v0 in range(0, VT, 8):
        for q in range(16):
            assert len({phy_unit(v, q) % 8 for v in range(v0, v0 + 8)}) == 8
    for warp in range(4):
        for phase in range(4):
            for jj in range(4):
                units = {phy_unit(8 * warp + lane // 4, 4 * jj + lane % 4) % 8
                         for lane in range(8 * phase, 8 * phase + 8)}
                assert len(units) == 8
    seen = sorted(operand_row(v, part) for v in range(VT) for part in range(2))
    assert seen == list(range(2 * VT))
    for v in range(VT):
        assert operand_row(v, 0) // 8 + 1 == operand_row(v, 1) // 8
        assert operand_row(v, 0) % 8 == v % 8
