"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version and the f64 oracle at the 1e-5 gate (the grid
extraction, a pure gather, exactly), and the launch counters. They skip on a
host without a CUDA device.

This file imports no JAX, so it also runs on a GPU host that has none,
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

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
])
def test_kernels_match_plain_and_oracle(card, n, channels, w_scale):
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
    cx, cy, sub = _piece_problem(16, 512, 70)
    g = 512
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, 16)
    sub = sub.to(card)
    kernels.reset_launch_counts()
    tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, plan=plan)             # sparse: K6
    tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, apply_fft=False, plan=plan)
    tgrid.subgrids_to_grid_ranges_streamed(sub, cx, cy, g, plan=plan, merge=16)
    for mode in ("vmem", "gather"):
        tgrid.subgrids_to_grid_pallas(sub, cx, cy, g, mode=mode)
    torch.cuda.synchronize()
    assert kernels.grid_add_pieces_cuda.launches == 2
    assert kernels.grid_add_merged_cuda.launches == 1      # one stripe at G = 512
    assert kernels.grid_add_scatter_cuda.launches == 1
    assert kernels.grid_add_slots_cuda.launches == 1
    assert kernels.grid_add_cuda.launches == 0
