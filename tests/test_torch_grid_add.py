"""The port's grid-add formulations against the JAX package, on identical
numpy inputs, at small size on the CPU: the slot plan and the merged plan
(exact), the quadrant and masked pieces (exact), and every grid-add the
`grid` command reaches: the range dispatch's sparse route (K4, where the
JAX package takes its piece kernel) and no-FFT route (K6),
the merged stripe before its wrap-miss patch (K7), the streamed stripes,
the slot-plan modes vmem (K11a) and gather (K11b), the bucketed gather and
the per-plane scatter, and the `apply_fft` flags of the plain paths.

On CPU tensors the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do. The CUDA kernels meet
these plain versions on the card in tests/test_torch_cuda.py and
chip_smoke.py.

Problems (numpy draws, coordinates block-sorted where a range plan needs
it): "wrap", the wrap-miss data of tests/test_parallel.py:563-577 (G = 512,
N = 16, S = 70, ten subgrids stacked on the last block column, so that
merged groups at the row start have misses); "sparse", G = 256, S = 20
(256 blocks > 2·S); "dense", G = 128, S = 60 (64 blocks ≤ 2·S, the tile
path). Gate: the reference's 1e-5 normalized-RMS comparator
(`check_error`), which holds f32 sums in another order (index_add_,
gather-sums, the TPU kernels' selector dots) comfortably; exact equality
where stated.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import idg_tpu.ops.grid as jgrid
import idg_tpu_torch.ops.cuda.grid as kgrid
import idg_tpu_torch.ops.grid as tgrid
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
P, N = 4, 16


@dataclasses.dataclass(frozen=True)
class Problem:
    g: int
    cx: np.ndarray          # i32[S], block-sorted
    cy: np.ndarray
    sub: np.ndarray         # c64[S, P, N, N]
    grid_in: np.ndarray     # c64[P, G, G]

    @property
    def pair(self):
        return _pair(self.sub)

    @property
    def tsub(self):
        return torch.from_numpy(self.sub)

    def rplan(self):
        return tgrid.plan_grid_add_ranges(self.cx, self.cy, self.g, N)


@functools.lru_cache(maxsize=None)
def _problem(case: str) -> Problem:
    rng = np.random.default_rng(11)
    if case == "wrap":
        g = 512
        cx = np.concatenate([np.full(10, g - N + 5), rng.integers(0, g, 60)])
        cy = np.concatenate([rng.integers(0, g, 10), rng.integers(0, g, 60)])
    else:
        g, s = {"sparse": (256, 20), "dense": (128, 60)}[case]
        cx, cy = rng.integers(0, g, s), rng.integers(0, g, s)
    order = tgrid.block_sort_order(cx, cy, g, N)
    cx, cy = cx[order].astype(np.int32), cy[order].astype(np.int32)
    s = cx.shape[0]

    def c64(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    return Problem(g, cx, cy, c64(s, P, N, N), c64(P, g, g))


def _pair(x):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x.real, np.float32), np.ascontiguousarray(x.imag, np.float32)


def _complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _gate(got, want):
    res = check_error(got, want, verbose=False)
    assert res.mean_error <= GATE, res


def _spy(monkeypatch, name):
    """Count the calls of a plain version in ops/cuda/grid.py (what a wrapper
    runs on CPU tensors), so a test can say which kernel a path reached."""
    calls = []
    real = getattr(kgrid, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(kgrid, name, spy)
    return calls


# (a) host plans: exact ------------------------------------------------------

@pytest.mark.parametrize("case", ["wrap", "sparse", "dense"])
def test_slot_plan_equals_jax(case):
    pb = _problem(case)
    rng = np.random.default_rng(5)
    perm = rng.permutation(pb.cx.shape[0])     # the slot plan needs no sort
    for cx, cy in ((pb.cx, pb.cy), (pb.cx[perm], pb.cy[perm])):
        t = tgrid.plan_grid_add(cx, cy, pb.g, N)
        j = jgrid.plan_grid_add(cx, cy, pb.g, N)
        for name in ("slots", "piece_blocks"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
            assert getattr(t, name).dtype == getattr(j, name).dtype
        for name in ("nby", "nbx", "cap", "nr_subgrids", "grid_size", "subgrid_size",
                     "slot_inflation"):
            assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("case,m,merges", [
    ("wrap", 16, True), ("wrap", 32, True), ("sparse", 16, True), ("sparse", 2, True),
    ("wrap", 1, False), ("wrap", 3, False), ("wrap", 64, False), ("crowded", 2, False),
    ("tail", 2, False),
])
def test_merged_plan_equals_jax(case, m, merges):
    """Equal tables, and None in the same cases: m < 2, m ∤ nbx, a padded
    block tail (nb = 9 → nbp = 16), a window wider than 16·m (40 subgrids
    in one block)."""
    if case == "tail":
        cx = cy = np.array([0, 5, 17, 40], np.int32)
        g = 48
    elif case == "crowded":
        cx = cy = np.concatenate([np.full(40, 5), [60, 100]]).astype(np.int32)
        g = 128
    else:
        pb = _problem(case)
        cx, cy, g = pb.cx, pb.cy, pb.g
    t = tgrid.plan_grid_add_merged(tgrid.plan_grid_add_ranges(cx, cy, g, N), m)
    j = jgrid.plan_grid_add_merged(jgrid.plan_grid_add_ranges(cx, cy, g, N), m)
    assert (t is not None) == (j is not None) == merges
    if merges:
        assert (t.m, t.wm) == (j.m, j.wm)
        for name in ("gbase", "gocc", "miss_rows", "miss_blocks"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
            assert getattr(t, name).dtype == getattr(j, name).dtype
    if (case, m) == ("wrap", 16):
        assert len(t.miss_rows) > 0, "the data must exercise wrap misses"


@pytest.mark.parametrize("case", ["wrap", "dense"])
def test_quadrant_and_masked_pieces_equal_jax(case):
    pb = _problem(case)
    got = tgrid._quadrant_pieces(pb.tsub, pb.cy, pb.cx, pb.g)
    want = jgrid._quadrant_pieces(pb.pair, pb.cy, pb.cx, pb.g)
    assert got.shape == (4 * pb.cx.shape[0], P, N, N)
    for a, b in zip(_pair(got), want):
        np.testing.assert_array_equal(a, np.asarray(b))
    oyx = torch.from_numpy(tgrid.roll_offsets(pb.cx, pb.cy, pb.g, N))
    got = tgrid._mask_pieces(pb.tsub, oyx[:, 0], oyx[:, 1])
    want = jgrid._mask_pieces(pb.pair, oyx[:, 0].numpy(), oyx[:, 1].numpy())
    for a, b in zip(_pair(got), want):
        np.testing.assert_array_equal(a, np.asarray(b))


# (b) the range dispatch: sparse, no-FFT and bucketed routes ---------------------

# The one expected difference from the JAX dispatch: its sparse route
# (masked pieces + its piece kernel, for plans of more than 2·S blocks) is
# the tile route (K4) in the port, which reads only its runs on Hopper.
JAX_ROUTE_DIFFERENCES = {"sparse": "tile"}
ROUTE_PLAIN = {"tile": "grid_add_plain", "quadrant": "grid_add_pieces_plain"}


def jax_route(plan, apply_fft: bool, p: int = P) -> str:
    """The route the JAX package's subgrids_to_grid_ranges takes
    (idg_tpu/ops/grid.py:1940-2021)."""
    if p * N * N % 1024:
        return "bucketed"
    if not apply_fft:
        return "quadrant"
    return "tile" if plan.nbp <= 2 * plan.nr_subgrids else "sparse"


@pytest.mark.parametrize("case,apply_fft,route", [
    ("wrap", True, "sparse"), ("sparse", False, "quadrant"), ("dense", False, "quadrant"),
])
def test_ranges_routes_match_jax_interpret(case, apply_fft, route, monkeypatch):
    """`route` is the JAX dispatch's; the port takes it but for
    JAX_ROUTE_DIFFERENCES, and its grid matches JAX's either way."""
    pb = _problem(case)
    plan = pb.rplan()
    assert jax_route(plan, apply_fft) == route
    port_route = JAX_ROUTE_DIFFERENCES.get(route, route)
    assert tgrid.ranges_route(plan, apply_fft) == port_route
    calls = _spy(monkeypatch, ROUTE_PLAIN[port_route])
    got = tgrid.subgrids_to_grid_ranges(pb.tsub, pb.cx, pb.cy, pb.g, apply_fft,
                                        grid_in=torch.from_numpy(pb.grid_in), plan=plan)
    assert calls == [ROUTE_PLAIN[port_route]]
    want = jgrid.subgrids_to_grid_ranges(pb.pair, pb.cx, pb.cy, pb.g, apply_fft,
                                         interpret=True, grid_in=_pair(pb.grid_in),
                                         plan=jgrid.plan_grid_add_ranges(pb.cx, pb.cy, pb.g, N))
    assert got.shape == (P, pb.g, pb.g) and got.dtype == torch.complex64
    _gate(got, _complex(want))


@pytest.mark.parametrize("apply_fft", [True, False])
def test_odd_payload_takes_the_bucketed_gather_like_jax(apply_fft):
    """P·N² % 1024 ≠ 0 (one polarization): both packages take the bucketed
    gather for the grid-add and the plain gather for the extraction."""
    pb = _problem("dense")
    sub = pb.sub[:, :1]
    plan = pb.rplan()
    assert tgrid.ranges_route(plan, apply_fft, nr_correlations=1) == "bucketed"
    got = tgrid.subgrids_to_grid_ranges(torch.from_numpy(sub), pb.cx, pb.cy, pb.g, apply_fft,
                                        plan=plan)
    want = jgrid.subgrids_to_grid_ranges(_pair(sub), pb.cx, pb.cy, pb.g, apply_fft,
                                         interpret=True)
    _gate(got, _complex(want))
    grid = pb.grid_in[:1]
    got = tgrid.grid_to_subgrids_ranges(torch.from_numpy(grid), pb.cx, pb.cy, N, apply_fft)
    want = jgrid.grid_to_subgrids_ranges(_pair(grid), pb.cx, pb.cy, N, apply_fft,
                                         interpret=True)
    _gate(got, _complex(want))
    with pytest.raises(ValueError, match="1024"):
        tgrid.grid_to_subgrids_ranges(torch.from_numpy(grid), pb.cx, pb.cy, N, pieces=True)


# (c) the merged stripe (K7) and the streamed paths ------------------------------

def _jax_padded_pieces(pieces: torch.Tensor, wm: int):
    """The port's [4S, P, N, N] pieces as the JAX kernels take them: window
    padded and reshaped to [m_pad, 8, P·N²/8] per component."""
    m = pieces.shape[0]
    d = pieces[0].numel()
    pad = jgrid._pad_to_windows(m, wm)
    return tuple(np.concatenate([v.reshape(m, d), np.zeros((pad, d), np.float32)])
                 .reshape(m + pad, 8, d // 8) for v in _pair(pieces))


@pytest.mark.parametrize("stripe", [(256, 320), (768, 832), (0, 1024)])
def test_merged_stripe_before_patch_matches_jax_kernel(stripe):
    pb = _problem("wrap")
    plan = pb.rplan()
    mplan = tgrid.plan_grid_add_merged(plan, 16)
    oyx = torch.from_numpy(tgrid.roll_offsets(pb.cx, pb.cy, pb.g, N))
    pieces = tgrid._mask_pieces(tgrid.pieces_from_subgrids(pb.tsub, oyx), oyx[:, 0], oyx[:, 1])
    lo, hi = stripe
    assert ((mplan.miss_blocks >= lo) & (mplan.miss_blocks < hi)).any()
    got = kernels.grid_add_merged_cuda(pieces, plan, mplan, lo, hi)
    m = mplan.m
    blocks = jgrid._grid_add_ranges_merged_call(
        _jax_padded_pieces(pieces, mplan.wm), m, mplan.wm, plan.starts[:, lo:hi],
        plan.lens[:, lo:hi], mplan.gbase[:, lo // m:hi // m], mplan.gocc[lo // m:hi // m],
        interpret=True)
    want = tgrid._blocks_to_grid(torch.from_numpy(_complex(blocks).reshape(hi - lo, -1)
                                                  .astype(np.complex64)),
                                 (hi - lo) // plan.nbx, plan.nbx, N, pb.g, P)
    assert got.shape == want.shape == (P, (hi - lo) // plan.nbx * N, pb.g)
    _gate(got, want)
    # the wrap misses are exactly what the patch adds: window sums + misses
    # = the whole runs, K6's sum
    tgrid._patch_misses(got, pieces, plan, mplan, lo, hi)
    _gate(got, kernels.grid_add_pieces_cuda(pieces, plan, lo, hi))


@pytest.mark.parametrize("case,merge,kernel", [
    ("wrap", 16, "grid_add_merged_plain"), ("sparse", 0, "grid_add_pieces_plain"),
    ("sparse", None, "grid_add_merged_plain"),
])
def test_streamed_bands_match_jax(case, merge, kernel, monkeypatch):
    pb = _problem(case)
    monkeypatch.setattr(tgrid, "MAX_RANGE_BLOCKS", 64)
    monkeypatch.setattr(jgrid, "MAX_RANGE_BLOCKS", 64)
    calls = _spy(monkeypatch, kernel)
    got = tgrid.subgrids_to_grid_ranges_streamed(pb.tsub, pb.cx, pb.cy, pb.g, plan=pb.rplan(),
                                                 merge=merge)
    jplan = jgrid.plan_grid_add_ranges(pb.cx, pb.cy, pb.g, N)
    re_b, im_b = jgrid.subgrids_to_grid_ranges_streamed(pb.pair, pb.cx, pb.cy, pb.g,
                                                        interpret=True, plan=jplan, merge=merge)
    rows = 64 // (pb.g // N)
    assert len(got) == len(re_b) == len(calls) == pb.g // N // rows
    for band, re, im in zip(got, re_b, im_b):
        assert band.shape == (P, rows * N, pb.g)
        _gate(band, _complex((re, im)))
    whole = torch.cat(got, dim=1)
    _gate(whole, tgrid.subgrids_to_grid(pb.tsub, pb.cx, pb.cy, pb.g))


def test_streamed_merged_keeps_the_outliers_of_empty_wrap_groups():
    """A wrap group with gocc == 0 whose outlier rows lie inside its window
    (S of three subgrids: rows S + r0 < 2·wm): K7 skips the group and the
    JAX plan lists no miss, so the JAX merged path drops that subgrid's
    right-hand pieces (max error 0.18 against a max of 0.23 on this data,
    ROADMAP Queue 3). The port's patch adds them."""
    g = 256
    cx = np.array([40, g - N + 3, 100], np.int32)     # one subgrid homed in the last
    cy = np.array([230, 5 * N + 2, 200], np.int32)    # block column of row 5, m = 8
    order = tgrid.block_sort_order(cx, cy, g, N)
    cx, cy = cx[order], cy[order]
    sub = torch.from_numpy(_problem("sparse").sub[:3])
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, N)
    mplan = tgrid.plan_grid_add_merged(plan, 8)
    rows, _ = tgrid.wrap_patch_rows(plan, mplan)
    assert len(mplan.miss_rows) == 0 and len(rows) > 0
    bands = tgrid.subgrids_to_grid_ranges_streamed(sub, cx, cy, g, plan=plan, merge=8)
    _gate(torch.cat(bands, dim=1), tgrid.subgrids_to_grid(sub, cx, cy, g))


def test_streamed_consume_reduces_each_band(monkeypatch):
    pb = _problem("wrap")
    monkeypatch.setattr(tgrid, "MAX_RANGE_BLOCKS", 128)
    plan = pb.rplan()
    bands = tgrid.subgrids_to_grid_ranges_streamed(pb.tsub, pb.cx, pb.cy, pb.g, plan=plan)
    corners = tgrid.subgrids_to_grid_ranges_streamed(
        pb.tsub, pb.cx, pb.cy, pb.g, plan=plan, consume=lambda b: b[:, :1, :1].clone())
    assert isinstance(corners, list) and len(corners) == len(bands) == 8
    for c, b in zip(corners, bands):
        assert torch.equal(c, b[:, :1, :1])


def test_merge_auto_and_env_pick_as_jax(monkeypatch):
    """Auto tries 64, 32, 16 on sparse plans (nb ≥ 8·S); IDG_GRID_MERGE
    overrides; 0 forces per-block; dense plans stay per-block."""
    plan = _problem("wrap").rplan()
    assert tgrid.merged_plan_for(plan).m == 32      # nbx = 32: 64 does not divide it
    assert tgrid.merged_plan_for(plan, 0) is None
    monkeypatch.setenv("IDG_GRID_MERGE", "16")
    assert tgrid.merged_plan_for(plan).m == 16
    monkeypatch.delenv("IDG_GRID_MERGE")
    assert tgrid.merged_plan_for(_problem("dense").rplan()) is None


# (d) the slot-plan grid-adds (K11a, K11b) and the plain paths ---------------------

@pytest.mark.parametrize("mode,kernel", [
    ("vmem", "grid_add_scatter_plain"), ("gather", "grid_add_slots_plain"),
    ("auto", "grid_add_scatter_plain"),
])
def test_slot_plan_modes_match_jax_interpret(mode, kernel, monkeypatch):
    pb = _problem("sparse")
    plan = tgrid.plan_grid_add(pb.cx, pb.cy, pb.g, N)
    calls = _spy(monkeypatch, kernel)
    got = tgrid.subgrids_to_grid_pallas(pb.tsub, pb.cx, pb.cy, pb.g, plan=plan, mode=mode,
                                        grid_in=torch.from_numpy(pb.grid_in))
    assert calls == [kernel]
    want = jgrid.subgrids_to_grid_pallas(pb.pair, pb.cx, pb.cy, pb.g, interpret=True,
                                         grid_in=_pair(pb.grid_in), mode=mode,
                                         plan=jgrid.plan_grid_add(pb.cx, pb.cy, pb.g, N))
    _gate(got, _complex(want))


def test_slot_plan_without_piece_blocks_takes_the_gather(monkeypatch):
    pb = _problem("sparse")
    plan = tgrid.plan_grid_add(pb.cx, pb.cy, pb.g, N)
    plan.piece_blocks = None
    calls = _spy(monkeypatch, "grid_add_slots_plain")
    got = tgrid.subgrids_to_grid_pallas(pb.tsub, pb.cx, pb.cy, pb.g, plan=plan, mode="vmem")
    assert calls == ["grid_add_slots_plain"]
    _gate(got, tgrid.subgrids_to_grid(pb.tsub, pb.cx, pb.cy, pb.g))
    with pytest.raises(ValueError, match="mode"):
        tgrid.subgrids_to_grid_pallas(pb.tsub, pb.cx, pb.cy, pb.g, plan=plan, mode="rows")


@pytest.mark.parametrize("apply_fft", [True, False])
def test_bucketed_and_streamed_planes_match_jax(apply_fft, monkeypatch):
    pb = _problem("dense")
    monkeypatch.setattr(tgrid, "SLOT_SUM_CHUNK_BYTES", 1 << 16)   # several chunks
    plan = tgrid.plan_grid_add(pb.cx, pb.cy, pb.g, N)
    got = tgrid.subgrids_to_grid_bucketed(pb.tsub, pb.cx, pb.cy, pb.g, apply_fft, plan=plan,
                                          grid_in=torch.from_numpy(pb.grid_in))
    want = jgrid.subgrids_to_grid_bucketed(pb.pair, pb.cx, pb.cy, pb.g, apply_fft,
                                           grid_in=_pair(pb.grid_in))
    _gate(got, _complex(want))
    planes = tgrid.subgrids_to_grid_streamed(pb.tsub, pb.cx, pb.cy, pb.g, apply_fft)
    re_p, im_p = jgrid.subgrids_to_grid_streamed(pb.pair, pb.cx, pb.cy, pb.g, apply_fft)
    assert len(planes) == len(re_p) == P
    for plane, re, im in zip(planes, re_p, im_p):
        assert plane.shape == (pb.g, pb.g)
        _gate(plane, _complex((re, im)))


def test_apply_fft_false_matches_jax_both_ways():
    pb = _problem("dense")
    grid = torch.from_numpy(pb.grid_in)
    _gate(tgrid.subgrids_to_grid(pb.tsub, pb.cx, pb.cy, pb.g, apply_fft=False),
          _complex(jgrid.subgrids_to_grid(pb.pair, pb.cx, pb.cy, pb.g, apply_fft=False)))
    want = _complex(jgrid.grid_to_subgrids(_pair(grid), pb.cx, pb.cy, N, apply_fft=False))
    for got in (tgrid.grid_to_subgrids(grid, pb.cx, pb.cy, N, apply_fft=False),
                tgrid.grid_to_subgrids_ranges(grid, pb.cx, pb.cy, N, apply_fft=False)):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.complex64))
    jr = jgrid.grid_to_subgrids_ranges(_pair(grid), pb.cx, pb.cy, N, apply_fft=False,
                                       interpret=True)
    np.testing.assert_array_equal(_pair(tgrid.grid_to_subgrids_ranges(
        grid, torch.from_numpy(pb.cx), torch.from_numpy(pb.cy), N, apply_fft=False))[0],
        np.asarray(jr[0]))


# (e) wrappers ----------------------------------------------------------------

@pytest.mark.parametrize("bad", ["dtype", "count", "pols", "stripe", "merged_stripe",
                                 "no_piece_blocks", "subgrid_size"])
def test_new_wrappers_reject_bad_input(bad):
    pb = _problem("wrap")
    plan = pb.rplan()
    mplan = tgrid.plan_grid_add_merged(plan, 16)
    splan = tgrid.plan_grid_add(pb.cx, pb.cy, pb.g, N)
    pieces = torch.zeros((4 * pb.cx.shape[0], P, N, N), dtype=torch.complex64)
    with pytest.raises(ValueError):
        if bad == "dtype":
            kernels.grid_add_pieces_cuda(pieces.to(torch.complex128), plan)
        elif bad == "count":
            kernels.grid_add_slots_cuda(pieces[:-1], splan)
        elif bad == "pols":
            kernels.grid_add_scatter_cuda(pieces[:, :2].contiguous(), splan)
        elif bad == "stripe":
            kernels.grid_add_pieces_cuda(pieces, plan, 0, plan.nbx + 1)
        elif bad == "merged_stripe":
            kernels.grid_add_merged_cuda(pieces, plan, mplan, plan.nbx, plan.nb + plan.nbx)
        elif bad == "no_piece_blocks":
            splan.piece_blocks = None
            kernels.grid_add_scatter_cuda(pieces, splan)
        else:
            kernels.grid_add_pieces_cuda(torch.zeros((4 * pb.cx.shape[0], P, 8, 8),
                                                     dtype=torch.complex64), plan)


def test_cpu_tensors_leave_new_counters_at_zero(monkeypatch):
    pb = _problem("sparse")
    monkeypatch.setattr(tgrid, "MAX_RANGE_BLOCKS", 64)
    kernels.reset_launch_counts()
    tgrid.subgrids_to_grid_ranges(pb.tsub, pb.cx, pb.cy, pb.g)
    tgrid.subgrids_to_grid_ranges_streamed(pb.tsub, pb.cx, pb.cy, pb.g, merge=16)
    for mode in ("vmem", "gather"):
        tgrid.subgrids_to_grid_pallas(pb.tsub, pb.cx, pb.cy, pb.g, mode=mode)
    assert all(k.launches == 0 for k in kernels.KERNELS)
    assert {kernels.grid_add_pieces_cuda, kernels.grid_add_merged_cuda,
            kernels.grid_add_scatter_cuda, kernels.grid_add_slots_cuda} <= set(kernels.KERNELS)
