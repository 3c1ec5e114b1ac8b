"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version and the f64 oracle at the 1e-5 gate (the grid
extraction, a pure gather, and vadd exactly), and the launch counters. They
skip on a host without a CUDA device.

This file imports no JAX, so it also runs on a GPU host that has none,
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from idg_tpu_torch.config import IDGParams
from idg_tpu_torch.data import make_observation, make_w_observation
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops import grid as tgrid
from idg_tpu_torch.ops.api import _resolve
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.ops.vadd import make_vadd_inputs, vadd_plain
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
SMALL = dict(grid_size=128, nr_stations=3, nr_timeslots=2, nr_timesteps_subgrid=16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the kernels on the card)")
    return torch.device("cuda")


def _inputs(n, channels, w_scale):
    params = IDGParams(subgrid_size=n, nr_channels=channels, **SMALL)
    if w_scale is None:
        obs, sub = make_observation(params, include_subgrids=True)
    else:
        params, obs, sub = make_w_observation(params, w_scale=w_scale,
                                              include_subgrids=True)
    rank = _resolve("gridder", "cuda_v6", params, obs)[1] or 2
    return params, obs, np.ascontiguousarray(sub), rank


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_scale", [
    (16, 8, None), (32, 7, None), (16, 8, 1000.0), (32, 16, 1000.0),
    (16, 48, None), (32, 48, None), (16, 3, None), (32, 16, "non-uniform"),
    (32, 7, "ragged"), (16, 7, "ragged"),
])
def test_kernels_match_plain_and_oracle(card, n, channels, w_scale):
    """K1 and K2 (TF32 wgmma) against their plain versions and the oracle:
    w = 0, rank 4 (w_scale 1000), 48 channels, a ragged V (T·C = 112, 48
    and 37·7 are not multiples of the kernels' 32-visibility tile) and
    non-uniform wavenumbers, which K1 and K2 take with no fallback."""
    if w_scale == "ragged":
        params = IDGParams(subgrid_size=n, nr_channels=channels,
                           **dict(SMALL, nr_timesteps_subgrid=37))
        obs, sub = make_observation(params, include_subgrids=True)
        sub, rank = np.ascontiguousarray(sub), _resolve("gridder", "cuda_v6", params, obs)[1] or 2
    elif w_scale == "non-uniform":
        params, obs, sub, rank = _inputs(n, channels, None)
        k = np.array(obs.wavenumbers, copy=True)
        k[-1] *= 1.05
        obs = dataclasses.replace(obs, wavenumbers=k)
        assert _resolve("gridder", "cuda_v6", params, obs)[0] == "cuda_v6"
    else:
        params, obs, sub, rank = _inputs(n, channels, w_scale)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    sub_cpu, sub_gpu = torch.from_numpy(sub), torch.from_numpy(sub).to(card)

    got = kernels.gridder_cuda_v6(params, stg_gpu, rank)
    torch.cuda.synchronize()
    assert check_error(got, kernels.gridder_plain(params, stg_cpu, rank),
                       verbose=False).mean_error <= GATE
    assert check_error(got, gridder_reference(params, obs), verbose=False).mean_error <= GATE

    got = kernels.degridder_cuda_v7(params, stg_gpu, sub_gpu, rank)
    torch.cuda.synchronize()
    assert check_error(got, kernels.degridder_plain(params, stg_cpu, sub_cpu, rank),
                       verbose=False).mean_error <= GATE
    assert check_error(got, degridder_reference(params, obs, sub),
                       verbose=False).mean_error <= GATE


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 6])
def test_k2_matches_plain_at_every_rank(card, n, rank):
    """K2, both forms, against its plain version at every Taylor rank on
    w ≠ 0 data (V = 16·7, a ragged last tile): at N = 32 up to rank 2 the
    turned product (the tile's visibilities the m64 operand, rank 1 folded
    into it, two consumer warpgroups on alternate tiles), above rank 2 and
    at N = 16 the pol-stacked one, which at N = 32 walks the tiles once per
    group of two ranks and adds the groups' visibilities."""
    params, obs, sub, _ = _inputs(n, 7, 1000.0)
    md = obs.metadata
    oyx = torch.from_numpy(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size, n))
    pieces = tgrid.pieces_from_subgrids(torch.from_numpy(sub), oyx)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    want = kernels.degridder_plain(params, stg_cpu, torch.from_numpy(sub), rank)
    got = kernels.degridder_cuda_v7(params, stg_gpu, torch.from_numpy(sub).to(card), rank)
    got_f = kernels.degridder_cuda_v7(params, stg_gpu, pieces.to(card), rank,
                                      fuse_oyx=oyx.to(card))
    torch.cuda.synchronize()
    _gate(got, want)
    _gate(got_f, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fused", "non-fused"])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 6])
def test_k1_fused_matches_plain_at_every_rank(card, n, rank, form):
    """K1 against its plain version at every Taylor rank on w ≠ 0 data, in
    both forms: the fused one (the inverse DFT K3 on the TF32 tensor cores,
    then the roll) and the non-fused one. N = 32 takes the turned product
    (the lhs the 64-row operand) at every rank, N = 16 the transposed one;
    at N = 32 above rank 3 the block has one stage, and at rank 4 the fused
    epilogue fills it."""
    params, obs, _, _ = _inputs(n, 7, 1000.0)
    md = obs.metadata
    oyx = torch.from_numpy(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size, n))
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    if form == "fused":
        got = kernels.gridder_cuda_v6_pieces(params, stg_gpu, oyx.to(card), rank)
        want = kernels.gridder_v6_pieces_plain(params, stg_cpu, oyx, rank)
    else:
        got = kernels.gridder_cuda_v6(params, stg_gpu, rank)
        want = kernels.gridder_plain(params, stg_cpu, rank)
    torch.cuda.synchronize()
    _gate(got, want)


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches(card):
    params, obs, sub, rank = _inputs(16, 8, None)
    stg = stage(params, obs, card)
    kernels.reset_launch_counts()
    kernels.gridder_cuda_v6(params, stg, rank)
    kernels.gridder_cuda_v6(params, stg, rank)
    kernels.degridder_cuda_v7(params, stg, torch.from_numpy(sub).to(card), rank)
    kernels.gridder_plain(params, stg, rank)
    assert kernels.gridder_cuda_v6.launches == 2
    assert kernels.degridder_cuda_v7.launches == 1


def _grid_problem(n, nr_stations):
    """Block-sorted observation on an 8×8-block grid: 5 stations give the
    tile-path plan (40 subgrids, 64 blocks), 3 a sparse one (6 subgrids)."""
    params = IDGParams(grid_size=8 * n, subgrid_size=n, nr_stations=nr_stations,
                       nr_timeslots=4 if nr_stations == 5 else 2,
                       nr_timesteps_subgrid=8, nr_channels=8)
    g = params.grid_size
    obs, _ = tgrid.sort_observation_blocks(make_observation(params)[0], g, n)
    md = obs.metadata
    oyx = torch.from_numpy(tgrid.roll_offsets(md.coord_x, md.coord_y, g, n))
    plan = tgrid.plan_grid_add_ranges(md.coord_x, md.coord_y, g, n)
    rank = _resolve("gridder", "cuda_v6", params, obs)[1] or 2
    rng = np.random.default_rng(11)
    grid = torch.complex(*(torch.from_numpy((rng.normal(size=(4, g, g)) / n**2)
                                            .astype(np.float32)) for _ in range(2)))
    return params, obs, oyx, plan, rank, grid


def _gate(got, want):
    res = check_error(got, want, verbose=False)
    assert res.mean_error <= GATE, res


@pytest.mark.cuda
@pytest.mark.parametrize("n,nr_stations", [(16, 5), (32, 5), (32, 3)])
def test_grid_stage_kernels_match_plain_and_oracle(card, n, nr_stations):
    params, obs, oyx, plan, rank, grid = _grid_problem(n, nr_stations)
    g = params.grid_size
    md = obs.metadata
    cx, cy = (torch.from_numpy(np.asarray(c, np.int32)) for c in (md.coord_x, md.coord_y))
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    oyx_gpu = oyx.to(card)

    # K1 with its fused epilogue (K3 inverse + roll)
    pieces = kernels.gridder_cuda_v6_pieces(params, stg_gpu, oyx_gpu, rank)
    torch.cuda.synchronize()
    _gate(pieces, kernels.gridder_v6_pieces_plain(params, stg_cpu, oyx, rank))
    oracle_sub = torch.from_numpy(gridder_reference(params, obs))
    _gate(pieces, tgrid.pieces_from_subgrids(oracle_sub, oyx))

    # K4, dispatched as the pipeline does
    got = tgrid.subgrids_to_grid_ranges(None, md.coord_x, md.coord_y, g, plan=plan,
                                        tiles=pieces)
    torch.cuda.synchronize()
    _gate(got, kernels.grid_add_plain(pieces.cpu(), oyx, plan, g))
    _gate(got, tgrid.subgrids_to_grid(oracle_sub, md.coord_x, md.coord_y, g))

    # K5: a pure gather, so exact
    got = kernels.grid_extract_cuda(grid.to(card), cx.to(card), cy.to(card), n)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.grid_extract_plain(grid, cx, cy, n))

    # K2 with its fused prologue (un-roll + K3 forward)
    vis = kernels.degridder_cuda_v7(params, stg_gpu, got, rank, fuse_oyx=oyx_gpu)
    torch.cuda.synchronize()
    _gate(vis, kernels.degridder_cuda_v7(params, stg_cpu, got.cpu(), rank, fuse_oyx=oyx))
    oracle_vis = degridder_reference(
        params, obs, tgrid.grid_to_subgrids(grid, md.coord_x, md.coord_y, n).numpy())
    _gate(vis, oracle_vis)


@pytest.mark.cuda
def test_grid_stage_launch_counters(card):
    params, obs, oyx, plan, rank, grid = _grid_problem(16, 5)
    md = obs.metadata
    stg = stage(params, obs, card)
    oyx = oyx.to(card)
    kernels.reset_launch_counts()
    pieces = kernels.gridder_cuda_v6_pieces(params, stg, oyx, rank)
    kernels.grid_add_cuda(pieces, oyx, plan, params.grid_size)
    got = tgrid.grid_to_subgrids_ranges(grid.to(card), md.coord_x, md.coord_y, 16,
                                        pieces=True)
    kernels.degridder_cuda_v7(params, stg, got, rank, fuse_oyx=oyx)
    kernels.degridder_cuda_v7(params, stg, got, rank)
    tgrid.pieces_from_subgrids(kernels.gridder_plain(params, stg, rank), oyx)
    torch.cuda.synchronize()
    assert kernels.gridder_cuda_v6_pieces.launches == 1
    assert kernels.gridder_cuda_v6.launches == 0
    assert kernels.grid_add_cuda.launches == 1
    assert kernels.grid_extract_cuda.launches == 1
    assert kernels.degridder_cuda_v7.launches == 2
    assert kernels.degridder_cuda_v7.fused_launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["default", "n16"])
def test_probed_k1_and_k2_match_unprobed_bitwise_and_sum_their_phases(card, problem):
    """Under a profiler one launch in PROBE_EVERY of the fused K1 and K2
    runs their probed instances (utils/trace.py:probe): the same output, bit
    for bit, as the unprobed kernels, on the default problem (N = 32) and at
    N = 16; the probe sums count every block of every probed launch, and
    each phase lies inside its whole."""
    from torch.profiler import ProfilerActivity, profile

    from idg_tpu_torch.data import make_perf_observation
    from idg_tpu_torch.utils import trace

    params = IDGParams() if problem == "default" else IDGParams(subgrid_size=16, **SMALL)
    obs = make_perf_observation(params)
    md = obs.metadata
    stg = stage(params, obs, card)
    oyx = torch.from_numpy(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size,
                                              params.subgrid_size)).to(card)
    rank = _resolve("gridder", "cuda_v6", params, obs)[1] or 2
    trace.reset()

    def both():
        pieces = kernels.gridder_cuda_v6_pieces(params, stg, oyx, rank)
        return pieces, kernels.degridder_cuda_v7(params, stg, pieces, rank, fuse_oyx=oyx)

    plain = both()
    assert trace.probe("gridder_cuda_v6_pieces", card) is None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for i in range(trace.PROBE_EVERY + 1):     # launches 0 and PROBE_EVERY run probed
            got = both()
            if i % trace.PROBE_EVERY == 0:
                torch.cuda.synchronize()
                for want, out in zip(plain, got):
                    assert torch.equal(torch.view_as_real(want), torch.view_as_real(out))
    torch.cuda.synchronize()
    sums = trace.snapshot()["probes"]
    assert set(sums) == {"gridder_cuda_v6_pieces", "degridder_cuda_v7_fused"}
    for kernel, got in sums.items():
        assert got["launches"] == 2, kernel
        assert got["blocks"] == params.nr_subgrids * got["launches"], kernel
        assert 0 < got["k3"] <= got["total"], (kernel, got)
        assert 0 < got["loop"] <= got["total"], (kernel, got)
        assert got["tc_wait"] <= got["loop"] and got["form_wait"] <= got["loop"], (kernel, got)
    trace.reset()


def _piece_problem(n, g, s):
    """Block-sorted coordinates with ten subgrids on the last block column
    (so that merged groups have wrap misses) and c64 uv subgrids."""
    rng = np.random.default_rng(11)
    cx = np.concatenate([np.full(10, g - n + 5), rng.integers(0, g, s - 10)])
    cy = rng.integers(0, g, s)
    order = tgrid.block_sort_order(cx, cy, g, n)
    cx, cy = cx[order].astype(np.int32), cy[order].astype(np.int32)
    sub = (rng.normal(size=(s, 4, n, n)) + 1j * rng.normal(size=(s, 4, n, n))).astype(np.complex64)
    return cx, cy, torch.from_numpy(sub)


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,s", [(16, 512, 70), (32, 1024, 200)])
def test_grid_add_piece_and_slot_kernels_match_plain(card, n, g, s):
    """K6, K7 (before the patch), K11a and K11b against their plain versions
    (K11a's atomics sum in a run-dependent order), and the streamed path
    against the plain periodic scatter."""
    cx, cy, sub = _piece_problem(n, g, s)
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    mplan = tgrid.plan_grid_add_merged(plan, 16)
    splan = tgrid.plan_grid_add(cx, cy, g, n)
    oyx = torch.from_numpy(tgrid.roll_offsets(cx, cy, g, n))
    masked = tgrid._mask_pieces(tgrid.pieces_from_subgrids(sub, oyx), oyx[:, 0], oyx[:, 1])
    quad = tgrid._quadrant_pieces(sub, cy, cx, g)
    masked_gpu, quad_gpu = masked.to(card), quad.to(card)

    got = kernels.grid_add_pieces_cuda(masked_gpu, plan)
    torch.cuda.synchronize()
    _gate(got, kernels.grid_add_pieces_plain(masked, plan))
    lo, hi = 8 * plan.nbx, 16 * plan.nbx
    _gate(kernels.grid_add_pieces_cuda(masked_gpu, plan, lo, hi),
          kernels.grid_add_pieces_plain(masked, plan, lo, hi))
    assert mplan is not None and len(mplan.miss_blocks)
    for b in np.unique(mplan.miss_blocks // plan.nbx):
        lo, hi = int(b) * plan.nbx, (int(b) + 1) * plan.nbx
        got = kernels.grid_add_merged_cuda(masked_gpu, plan, mplan, lo, hi)
        torch.cuda.synchronize()
        _gate(got, kernels.grid_add_merged_plain(masked, plan, mplan, lo, hi))
    _gate(kernels.grid_add_scatter_cuda(quad_gpu, splan),
          kernels.grid_add_scatter_plain(quad, splan))
    got = kernels.grid_add_slots_cuda(quad_gpu, splan)
    torch.cuda.synchronize()
    _gate(got, kernels.grid_add_slots_plain(quad, splan))
    bands = tgrid.subgrids_to_grid_ranges_streamed(sub.to(card), cx, cy, g, plan=plan, merge=16)
    _gate(torch.cat(bands, dim=1), tgrid.subgrids_to_grid(sub, cx, cy, g))


@pytest.mark.cuda
def test_grid_add_launch_counters(card):
    """The sparse plan (1,024 blocks > 2·S, LOFAR-4096's route) reaches K4
    from uv subgrids and from pieces (the pipeline's form), not K6."""
    cx, cy, sub = _piece_problem(16, 512, 70)
    g = 512
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, 16)
    assert plan.nbp > 2 * len(cx)
    sub = sub.to(card)
    oyx = torch.from_numpy(tgrid.roll_offsets(cx, cy, g, 16)).to(card)
    pieces = tgrid.pieces_from_subgrids(sub, oyx)
    kernels.reset_launch_counts()
    tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, plan=plan)             # sparse: K4
    tgrid.subgrids_to_grid_ranges(None, cx, cy, g, plan=plan, tiles=pieces)
    tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, apply_fft=False, plan=plan)
    tgrid.subgrids_to_grid_ranges_streamed(sub, cx, cy, g, plan=plan, merge=16)
    for mode in ("vmem", "gather"):
        tgrid.subgrids_to_grid_pallas(sub, cx, cy, g, mode=mode)
    torch.cuda.synchronize()
    assert kernels.grid_add_cuda.launches == 2
    assert kernels.grid_add_pieces_cuda.launches == 1      # the no-FFT quadrant route
    assert kernels.grid_add_merged_cuda.launches == 1      # one stripe at G = 512
    assert kernels.grid_add_scatter_cuda.launches == 1
    assert kernels.grid_add_slots_cuda.launches == 1


def _k4_problem(n, g, s):
    """Block-sorted coords with rolls from {0, 5, N − 1} on both axes and a
    quarter of the subgrids on the last block row or column (their pieces
    wrap into block row / column 0), and random block-rolled pieces."""
    rng = np.random.default_rng(13)
    nbx = g // n
    bx, by = rng.integers(0, nbx, s), rng.integers(0, nbx, s)
    bx[:s // 8], by[s // 8:s // 4] = nbx - 1, nbx - 1
    rolls = np.array([0, 5, n - 1])
    cx = bx * n + rolls[rng.integers(0, 3, s)]
    cy = by * n + rolls[rng.integers(0, 3, s)]
    order = tgrid.block_sort_order(cx, cy, g, n)
    cx, cy = cx[order].astype(np.int32), cy[order].astype(np.int32)
    shape = (s, 4, n, n)
    pieces = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    return (tgrid.plan_grid_add_ranges(cx, cy, g, n), torch.from_numpy(pieces),
            torch.from_numpy(tgrid.roll_offsets(cx, cy, g, n)))


def _run_order_sum(pieces, oyx, plan):
    """K4's sums in its own order, on the CPU: block by block, quadrant by
    quadrant, each run in order, the masked-out pixels added as zeros."""
    n, g = plan.subgrid_size, plan.grid_size
    i = torch.arange(n)
    grid = torch.zeros((4, g, g), dtype=torch.complex64)
    for b in range(plan.nb):
        by, bx = divmod(b, plan.nbx)
        for q, (qy, qx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            t0 = int(plan.tstarts[q, b])
            for t in range(t0, t0 + int(plan.lens[q, b])):
                keep = (((i >= oyx[t, 0]) == (qy == 0))[:, None]
                        & ((i >= oyx[t, 1]) == (qx == 0))[None, :])
                grid[:, by * n:(by + 1) * n, bx * n:(bx + 1) * n] += torch.where(
                    keep, pieces[t], torch.zeros((), dtype=torch.complex64))
    return grid


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,s", [(16, 128, 40), (16, 256, 20), (32, 256, 40), (32, 256, 12),
                                   (32, 1024, 200)])
def test_k4_matches_plain_on_sparse_plans_and_edge_rolls(card, n, g, s):
    """K4 on tile and sparse plans (nbp ≤ / > 2·S) with rolls 0, odd and
    N − 1 and pieces that wrap: within the gate of its plain version, equal
    bit for bit to the same sums in its order on the CPU, and bit for bit
    the same from two launches."""
    plan, pieces, oyx = _k4_problem(n, g, s)
    pieces_gpu, oyx_gpu = pieces.to(card), oyx.to(card)
    got = kernels.grid_add_cuda(pieces_gpu, oyx_gpu, plan, g)
    again = kernels.grid_add_cuda(pieces_gpu, oyx_gpu, plan, g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _gate(got, kernels.grid_add_plain(pieces, oyx, plan, g))
    assert torch.equal(got.cpu(), _run_order_sum(pieces, oyx, plan))


def _direct_problem(n, channels, w_value, timesteps=16):
    """w = 0 or a constant w that no Taylor rank reaches; 16 channels are two
    of K9a's channel groups, 11 a full and a partial one, 7 a partial one;
    37 timesteps a ragged tile of K8a's groups of 4 and K9a's rows of 16."""
    params = IDGParams(subgrid_size=n, nr_channels=channels,
                       **dict(SMALL, nr_timesteps_subgrid=timesteps))
    obs, sub = make_observation(params, include_subgrids=True)
    if w_value is not None:
        uvw = np.array(obs.uvw, copy=True)
        uvw[:, :, 2] = w_value
        obs = dataclasses.replace(obs, uvw=uvw)
    return params, obs, np.ascontiguousarray(sub)


def _direct_oracle_gate(got, oracle, plain):
    """K8a's and K9a's bound against the oracle (chip_smoke.py
    DIRECT_ORACLE_GATE): 4e-6, or 1.15× the plain version's own error where
    the rung's definition (float32 phases) is itself past 4e-6."""
    err = check_error(got, oracle, verbose=False).mean_error
    own = check_error(plain, oracle, verbose=False).mean_error
    assert err <= max(4e-6, 1.15 * own), (err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_value,timesteps", [
    (16, 16, None, 16), (32, 11, None, 16), (32, 7, None, 16), (16, 16, 2.0e4, 16),
    (32, 16, 2.0e4, 16), (16, 256, None, 16), (32, 16, None, 37),
])
def test_direct_kernels_match_plain_and_oracle(card, n, channels, w_value, timesteps):
    """K8a and K9a, full phase (v1) and channel recurrence (v2), on the TF32
    tensor cores; at 256 channels the recurrences hold the gate by their
    exact restarts every 8 channels; T = 37 is a ragged tile."""
    params, obs, sub = _direct_problem(n, channels, w_value, timesteps)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    sub_cpu, sub_gpu = torch.from_numpy(sub), torch.from_numpy(sub).to(card)
    grid_oracle = gridder_reference(params, obs)
    degrid_oracle = degridder_reference(params, obs, sub)
    for recurrence, gridder, degridder in (
            (False, kernels.gridder_cuda_v1, kernels.degridder_cuda_v1),
            (True, kernels.gridder_cuda_v2, kernels.degridder_cuda_v2)):
        got = gridder(params, stg_gpu)
        torch.cuda.synchronize()
        plain = kernels.gridder_direct_plain(params, stg_cpu, recurrence)
        _gate(got, plain)
        _gate(got, grid_oracle)
        _direct_oracle_gate(got, grid_oracle, plain)
        got = degridder(params, stg_gpu, sub_gpu)
        torch.cuda.synchronize()
        plain = kernels.degridder_direct_plain(params, stg_cpu, sub_cpu, recurrence)
        _gate(got, plain)
        _gate(got, degrid_oracle)
        _direct_oracle_gate(got, degrid_oracle, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [
    (1 << 20, 0), ((1 << 20) + 3, 0), (4099, 1), (1 << 28, 0), (3, 0), (2048, 0),
    (2048 * 397 + 4, 0), (2048 * 397 + 5, 0), (2048 * 397 + 5, 2),
])
def test_vadd_kernel_matches_plain(card, n, offset):
    """K10 on its 2048-float chunks with a partial last chunk and a scalar
    tail, at n = 2^28, below one quad, and on misaligned inputs."""
    x, y = make_vadd_inputs(n + offset, card)
    x, y = x[offset:], y[offset:]
    got = kernels.vadd_cuda(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, vadd_plain(x, y))


@pytest.mark.cuda
def test_direct_launch_counters(card):
    params, obs, sub = _direct_problem(16, 16, None)
    stg = stage(params, obs, card)
    sub = torch.from_numpy(sub).to(card)
    kernels.reset_launch_counts()
    kernels.gridder_cuda_v1(params, stg)
    kernels.gridder_cuda_v2(params, stg)
    kernels.gridder_cuda_v2(params, stg)
    kernels.degridder_cuda_v1(params, stg, sub)
    kernels.degridder_cuda_v2(params, stg, sub)
    kernels.gridder_direct_plain(params, stg, False)
    kernels.vadd_cuda(*make_vadd_inputs(1000, card))
    torch.cuda.synchronize()
    assert kernels.gridder_cuda_v1.launches == 1
    assert kernels.gridder_cuda_v2.launches == 2
    assert kernels.degridder_cuda_v1.launches == 1
    assert kernels.degridder_cuda_v2.launches == 1
    assert kernels.vadd_cuda.launches == 1
    assert kernels.gridder_cuda_v6.launches == 0


SEPARABLE = ("v3", "v4", "v5")


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_scale", [
    (16, 8, None), (32, 7, None), (16, 8, 45.0), (16, 8, 1000.0), (32, 16, 1000.0),
    (16, 48, None), (32, 48, None), (32, 7, "ragged"), (16, 7, "ragged"),
])
def test_separable_kernels_match_plain_and_oracle(card, n, channels, w_scale):
    """K8b (v3, v4), K8c (v5), K9b (v3, v4) and K9c (v5) against their plain
    versions and the oracle: T = 16 is one ragged tile, 7 and 48 channels a
    short and a resyncing recurrence (restarts at c = 16 and 32, N = 16 and
    32), w_scale 45 the rank-2 bf16 pass with μ != 0, w_scale 1000 rank 4
    (all passes bf16_3x), and V = 37·7 a ragged last tile of 32 visibilities
    (v3, v4) and of 32 timesteps (v5)."""
    if w_scale == "ragged":
        params = IDGParams(subgrid_size=n, nr_channels=channels,
                           **dict(SMALL, nr_timesteps_subgrid=37))
        obs, sub = make_observation(params, include_subgrids=True)
        sub, rank = np.ascontiguousarray(sub), _resolve("gridder", "cuda_v4", params, obs)[1] or 2
    else:
        params, obs, sub, rank = _inputs(n, channels, w_scale)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    sub_cpu, sub_gpu = torch.from_numpy(sub), torch.from_numpy(sub).to(card)
    grid_oracle = gridder_reference(params, obs)
    degrid_oracle = degridder_reference(params, obs, sub)
    for version in SEPARABLE:
        gridder = getattr(kernels, f"gridder_cuda_{version}")
        degridder = getattr(kernels, f"degridder_cuda_{version}")
        got = gridder(params, stg_gpu, rank)
        torch.cuda.synchronize()
        _gate(got, gridder(params, stg_cpu, rank))
        _gate(got, grid_oracle)
        got = degridder(params, stg_gpu, sub_gpu, rank)
        torch.cuda.synchronize()
        _gate(got, degridder(params, stg_cpu, sub_cpu, rank))
        _gate(got, degrid_oracle)


@pytest.mark.cuda
@pytest.mark.parametrize("version", SEPARABLE)
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 6])
def test_separable_kernels_match_plain_at_every_rank(card, version, n, rank):
    """K8b, K8c, K9b and K9c (cuda_v3, cuda_v4, cuda_v5) against their plain
    versions at every Taylor rank on w ≠ 0 data: v3 takes the ranks in
    pairs, v4 and v5 in groups that fit shared memory, each group walking
    the tiles again (v5's recurrence from channel 0)."""
    params, obs, sub, _ = _inputs(n, 7, 1000.0)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    sub_cpu, sub_gpu = torch.from_numpy(sub), torch.from_numpy(sub).to(card)
    gridder = getattr(kernels, f"gridder_cuda_{version}")
    degridder = getattr(kernels, f"degridder_cuda_{version}")
    got = gridder(params, stg_gpu, rank)
    torch.cuda.synchronize()
    _gate(got, gridder(params, stg_cpu, rank))
    got = degridder(params, stg_gpu, sub_gpu, rank)
    torch.cuda.synchronize()
    _gate(got, degridder(params, stg_cpu, sub_cpu, rank))


@pytest.mark.cuda
def test_separable_launch_counters(card):
    params, obs, sub, rank = _inputs(16, 8, None)
    stg = stage(params, obs, card)
    sub = torch.from_numpy(sub).to(card)
    kernels.reset_launch_counts()
    for version in SEPARABLE:
        getattr(kernels, f"gridder_cuda_{version}")(params, stg, rank)
        getattr(kernels, f"degridder_cuda_{version}")(params, stg, sub, rank)
    kernels.gridder_cuda_v4(params, stg, rank)
    kernels.gridder_separable_plain(params, stg, rank, ("3x", "default"), False)
    kernels.degridder_separable_plain(params, stg, sub, rank, ("3x", "default"), True)
    torch.cuda.synchronize()
    assert kernels.gridder_cuda_v3.launches == 1
    assert kernels.gridder_cuda_v4.launches == 2
    assert kernels.gridder_cuda_v5.launches == 1
    assert all(getattr(kernels, f"degridder_cuda_{v}").launches == 1 for v in SEPARABLE)
    assert kernels.gridder_cuda_v6.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_scale", [
    (16, 8, None), (32, 16, None), (16, 8, 45.0), (16, 8, 1000.0), (32, 16, 1000.0),
    (16, 48, None), (32, 48, None), (32, 8, 45.0), (32, 7, "ragged"), (16, 7, "ragged"),
])
def test_polstack_kernel_matches_plain_and_oracle(card, n, channels, w_scale):
    """K9d (degridder cuda_v6) against its plain version and the oracle at
    N = 16 and 32: rank 2 at w = 0 and with μ != 0 (w_scale 45, the rank-1
    single bf16 pass), rank 4 (w_scale 1000, "3x2k" throughout), 48
    channels, where the recurrence resyncs at c = 16 and 32, and V = 37·7, a
    ragged last tile of 32 timesteps."""
    if w_scale == "ragged":
        params = IDGParams(subgrid_size=n, nr_channels=channels,
                           **dict(SMALL, nr_timesteps_subgrid=37))
        obs, sub = make_observation(params, include_subgrids=True)
        sub = np.ascontiguousarray(sub)
    else:
        params, obs, sub, _ = _inputs(n, channels, w_scale)
    rank = _resolve("degridder", "cuda_v6", params, obs)[1] or 2
    assert (rank == 4) == (w_scale == 1000.0)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    got = kernels.degridder_cuda_v6(params, stg_gpu, torch.from_numpy(sub).to(card), rank)
    torch.cuda.synchronize()
    _gate(got, kernels.degridder_cuda_v6(params, stg_cpu, torch.from_numpy(sub), rank))
    _gate(got, degridder_reference(params, obs, sub))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 6])
def test_polstack_kernel_matches_plain_at_every_rank(card, n, rank):
    """K9d against its plain version at every Taylor rank on w ≠ 0 data: at
    N = 32 the ranks go four a group, and at rank 5 and 6 the second group
    walks the tiles again, its recurrence from channel 0."""
    params, obs, sub, _ = _inputs(n, 7, 1000.0)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    got = kernels.degridder_cuda_v6(params, stg_gpu, torch.from_numpy(sub).to(card), rank)
    torch.cuda.synchronize()
    _gate(got, kernels.degridder_cuda_v6(params, stg_cpu, torch.from_numpy(sub), rank))


@pytest.mark.cuda
def test_polstack_launch_counter(card):
    params, obs, sub, rank = _inputs(16, 8, None)
    stg = stage(params, obs, card)
    sub = torch.from_numpy(sub).to(card)
    kernels.reset_launch_counts()
    kernels.degridder_cuda_v6(params, stg, sub, rank)
    kernels.degridder_cuda_v6(params, stg, sub, 4)
    kernels.degridder_polstack_plain(params, stg, sub, rank)
    torch.cuda.synchronize()
    assert kernels.degridder_cuda_v6.launches == 2
    assert kernels.degridder_cuda_v5.launches == 0
