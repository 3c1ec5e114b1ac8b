"""The port on the card (marker `cuda`): each CUDA kernel against its
plain PyTorch version and the f64 oracle (the grid extraction, a pure
gather, and vadd exactly), the launch counters, the built instances (ptxas's
spills, the tensor-core opcodes in the SASS), the card-only commands
(`pipeline`, `grid`, perf mode, `--sustain`, the bench), every rung through
scripts/validate_cuda.py, the trace hook and the multi-device layer at a
world of one on NCCL. They skip on a host without a CUDA device.

This file imports no JAX, so it also runs on a GPU host that has none,
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel times are not taken here: scripts/time_kernels.py, time_direct.py and
time_separable.py time the kernels alone, and benchmark/ times the passes.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from idg_tpu_torch.config import HarnessConfig, IDGParams
from idg_tpu_torch.data import (initialize_subgrids, make_observation, make_perf_observation,
                                make_w_observation)
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops import grid as tgrid
from idg_tpu_torch.ops.api import _resolve
from idg_tpu_torch.ops.common import slice_staged, stage
from idg_tpu_torch.ops.vadd import make_vadd_inputs, vadd_plain
from idg_tpu_torch.utils.compare import check_error

ROOT = pathlib.Path(__file__).resolve().parents[1]
GATE = 1e-5
SMALL = dict(grid_size=128, nr_stations=3, nr_timeslots=2, nr_timesteps_subgrid=16)
# the correctness problem (IDGParams.correctness_defaults: 2 subgrids of
# T = 128) at w = 0 and at w_scale 1000, where the tables below were taken
CHECK = ("check", "check-1000")
# K1 and K2 (TF32, three passes) at N = 32 against the f64 oracle and
# against their float32 plain versions; N = 16, whose plain version itself
# reads close to 1e-5 at C = 48, at the check gate
K_ORACLE_GATE = {32: 4e-6, 16: GATE}
K_PLAIN_GATE = {32: 3e-6, 16: GATE}
K1_EVERY_RANK_GATE = 3e-6   # K1 against its plain version at every rank, N = 16 and 32


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card runs -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _inputs(n, channels, w_scale):
    """(params, observation, subgrids, K1's rank by the guard) on the small
    problem or ("check ...") the correctness problem: w = 0 (None), a
    w_scale, a ragged V (T = 37) or non-uniform wavenumbers."""
    case = str(w_scale)
    over = dict(subgrid_size=n, nr_channels=channels)
    if case.endswith("ragged"):
        over["nr_timesteps_subgrid"] = 37
    if case.startswith("check"):
        params = IDGParams.correctness_defaults(**over)
    else:
        params = IDGParams(**{**SMALL, **over})
    w_scale = 1000.0 if case == "check-1000" else w_scale if isinstance(w_scale, float) else None
    if w_scale is None:
        obs, sub = make_observation(params, include_subgrids=True)
    else:
        params, obs, sub = make_w_observation(params, w_scale=w_scale,
                                              include_subgrids=True)
    if case.endswith("non-uniform"):
        k = np.array(obs.wavenumbers, copy=True)
        k[-1] *= 1.05
        obs = dataclasses.replace(obs, wavenumbers=k)
    rank = _resolve("gridder", "cuda_v6", params, obs)[1] or 2
    return params, obs, np.ascontiguousarray(sub), rank


def _launches() -> dict:
    """Every wrapper's launch count by its name; K2's fused launches, which
    its own count holds too, also as degridder_cuda_v7_fused."""
    counts = {w.__name__: w.launches for w in kernels.KERNELS}
    counts["degridder_cuda_v7_fused"] = kernels.degridder_cuda_v7.fused_launches
    return counts


def _script(name):
    """scripts/<name>.py, imported as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_scale", [
    (16, 8, None), (32, 7, None), (16, 8, 1000.0), (32, 16, 1000.0),
    (16, 48, None), (32, 48, None), (16, 3, None), (32, 16, "non-uniform"),
    (32, 7, "ragged"), (16, 7, "ragged"), (32, 16, None), (16, 16, "non-uniform"),
    (32, 16, "rank 1"), *((n, c, w) for n in (32, 16) for c, w in (
        (16, "check"), (16, "check-1000"), (48, "check"), (16, "check non-uniform"),
        (7, "check ragged"))),
])
def test_kernels_match_plain_and_oracle(card, n, channels, w_scale):
    """K1 and K2 (TF32 wgmma), both forms, against their plain versions and
    the oracle (K_ORACLE_GATE, K_PLAIN_GATE): w = 0 at the guard's rank and
    at rank 1, rank 4 (w_scale 1000), 48 channels, a ragged V (T·C = 112, 48
    and 37·7 are not multiples of the kernels' 32-visibility tile) and
    non-uniform wavenumbers, which K1 and K2 take with no fallback; on the
    small problem and ("check ...") on the correctness problem, whose
    T = 128 gives 64 tiles a subgrid. The fused forms take the subgrids'
    block-rolled pieces (K2) or give them (K1)."""
    params, obs, sub, rank = _inputs(n, channels, w_scale)
    assert _resolve("gridder", "cuda_v6", params, obs)[0] == "cuda_v6"
    rank = 1 if w_scale == "rank 1" else rank
    assert (rank >= 4) == (w_scale in (1000.0, "check-1000"))
    md = obs.metadata
    oyx = torch.from_numpy(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size, n))
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    sub_cpu = torch.from_numpy(sub)
    pieces = tgrid.pieces_from_subgrids(sub_cpu, oyx)
    grid_oracle = torch.from_numpy(gridder_reference(params, obs))
    degrid_oracle = degridder_reference(params, obs, sub)
    cases = (   # (kernel, plain version, oracle)
        (kernels.gridder_cuda_v6(params, stg_gpu, rank),
         kernels.gridder_plain(params, stg_cpu, rank), grid_oracle),
        (kernels.gridder_cuda_v6_pieces(params, stg_gpu, oyx.to(card), rank),
         kernels.gridder_v6_pieces_plain(params, stg_cpu, oyx, rank),
         tgrid.pieces_from_subgrids(grid_oracle, oyx)),
        (kernels.degridder_cuda_v7(params, stg_gpu, sub_cpu.to(card), rank),
         kernels.degridder_plain(params, stg_cpu, sub_cpu, rank), degrid_oracle),
        (kernels.degridder_cuda_v7(params, stg_gpu, pieces.to(card), rank, fuse_oyx=oyx.to(card)),
         kernels.degridder_cuda_v7(params, stg_cpu, pieces, rank, fuse_oyx=oyx), degrid_oracle))
    torch.cuda.synchronize()
    for got, plain, oracle in cases:
        _gate(got, plain, K_PLAIN_GATE[n])
        _gate(got, oracle, K_ORACLE_GATE[n])


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
    epilogue fills it. On the small problem (C = 7) and on the correctness
    problem (T = 128, C = 16)."""
    for channels, w_scale in ((7, 1000.0), (16, "check-1000")):
        params, obs, _, _ = _inputs(n, channels, w_scale)
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
        _gate(got, want, K1_EVERY_RANK_GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["k1-k2", "grid-stage", "direct", "separable", "polstack"])
def test_launch_counters_count_kernel_launches(card, family):
    """Each wrapper counts one launch a call, its plain version none, and no
    other wrapper counts."""
    params, obs, sub, rank = _inputs(16, 8, None)
    stg = stage(params, obs, card)
    sub = torch.from_numpy(sub).to(card)
    kernels.reset_launch_counts()
    if family == "k1-k2":
        kernels.gridder_cuda_v6(params, stg, rank)
        kernels.gridder_cuda_v6(params, stg, rank)
        kernels.degridder_cuda_v7(params, stg, sub, rank)
        kernels.gridder_plain(params, stg, rank)
        want = {"gridder_cuda_v6": 2, "degridder_cuda_v7": 1}
    elif family == "grid-stage":
        params, obs, oyx, plan, rank, grid = _grid_problem(16, 5)
        md, stg, oyx = obs.metadata, stage(params, obs, card), oyx.to(card)
        pieces = kernels.gridder_cuda_v6_pieces(params, stg, oyx, rank)
        kernels.grid_add_cuda(pieces, oyx, plan, params.grid_size)
        got = tgrid.grid_to_subgrids_ranges(grid.to(card), md.coord_x, md.coord_y, 16,
                                            pieces=True)
        kernels.degridder_cuda_v7(params, stg, got, rank, fuse_oyx=oyx)
        kernels.degridder_cuda_v7(params, stg, got, rank)
        tgrid.pieces_from_subgrids(kernels.gridder_plain(params, stg, rank), oyx)
        want = {"gridder_cuda_v6_pieces": 1, "grid_add_cuda": 1, "grid_extract_cuda": 1,
                "degridder_cuda_v7": 2, "degridder_cuda_v7_fused": 1}
    elif family == "direct":
        kernels.gridder_cuda_v1(params, stg)
        kernels.gridder_cuda_v2(params, stg)
        kernels.gridder_cuda_v2(params, stg)
        kernels.degridder_cuda_v1(params, stg, sub)
        kernels.degridder_cuda_v2(params, stg, sub)
        kernels.gridder_direct_plain(params, stg, False)
        kernels.vadd_cuda(*make_vadd_inputs(1000, card))
        want = {"gridder_cuda_v1": 1, "gridder_cuda_v2": 2, "degridder_cuda_v1": 1,
                "degridder_cuda_v2": 1, "vadd_cuda": 1}
    elif family == "separable":
        for version in SEPARABLE:
            getattr(kernels, f"gridder_cuda_{version}")(params, stg, rank)
            getattr(kernels, f"degridder_cuda_{version}")(params, stg, sub, rank)
        kernels.gridder_cuda_v4(params, stg, rank)
        kernels.gridder_separable_plain(params, stg, rank, ("3x", "default"), False)
        kernels.degridder_separable_plain(params, stg, sub, rank, ("3x", "default"), True)
        want = {f"{w}_cuda_{v}": 1 for w in ("gridder", "degridder") for v in SEPARABLE}
        want["gridder_cuda_v4"] = 2
    else:
        kernels.degridder_cuda_v6(params, stg, sub, rank)
        kernels.degridder_cuda_v6(params, stg, sub, 4)
        kernels.degridder_polstack_plain(params, stg, sub, rank)
        want = {"degridder_cuda_v6": 2}
    torch.cuda.synchronize()
    assert {name: n for name, n in _launches().items() if n} == want


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


def _gate(got, want, bound=GATE):
    res = check_error(got, want, verbose=False)
    assert res.mean_error <= bound, res


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


COMPARE_SUBGRIDS = 512   # the default problem's first block-sorted subgrids


@pytest.fixture(scope="module")
def default_problem(card):
    """The cells' shape (IDGParams(): N = 32, T = 128, C = 16, grid 1024),
    block-sorted and staged on the card: (params, metadata, staging, roll
    offsets, [coord_x, coord_y], a random grid normal(0, 1)/N², which gives
    O(1) visibilities)."""
    params = IDGParams()
    g, n = params.grid_size, params.subgrid_size
    obs, _ = tgrid.sort_observation_blocks(make_perf_observation(params), g, n)
    md = obs.metadata
    cxy = [torch.as_tensor(np.asarray(c, np.int32), device=card)
           for c in (md.coord_x, md.coord_y)]
    rng = np.random.default_rng(11)
    grid = torch.complex(*(torch.as_tensor((rng.normal(size=(4, g, g)) / n**2)
                                           .astype(np.float32), device=card) for _ in range(2)))
    oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, g, n), device=card)
    return params, md, stage(params, obs, card), oyx, cxy, grid


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 2, 4])
def test_cell_kernels_match_plain_on_the_default_problem(default_problem, rank):
    """K1, both forms, K4, K5 and K2, both forms, on the first
    COMPARE_SUBGRIDS subgrids of the default problem against their plain
    versions on the card: K1 and K2 at K_PLAIN_GATE[32] at ranks 1 and 2
    (the turned products) and 4 (K2's pol-stacked one), K4 at the gate, K5
    exactly. At rank 2, on the whole problem: K3 in the fused forms against
    the non-fused kernels with the plain (i)DFT and roll, and K4 twice bit
    for bit."""
    params, md, stg, oyx, (cx, cy), grid = default_problem
    g, n, k = params.grid_size, params.subgrid_size, COMPARE_SUBGRIDS
    small, oyx_k = slice_staged(stg, 0, k), oyx[:k]
    pieces = kernels.gridder_cuda_v6_pieces(params, small, oyx_k, rank)
    _gate(pieces, kernels.gridder_v6_pieces_plain(params, small, oyx_k, rank), K_PLAIN_GATE[n])
    _gate(kernels.gridder_cuda_v6(params, small, rank),
          kernels.gridder_plain(params, small, rank), K_PLAIN_GATE[n])
    plan = tgrid.plan_grid_add_ranges(md.coord_x[:k], md.coord_y[:k], g, n)
    _gate(kernels.grid_add_cuda(pieces, oyx_k, plan, g),
          kernels.grid_add_plain(pieces, oyx_k, plan, g))
    xpieces = kernels.grid_extract_cuda(grid, cx[:k], cy[:k], n)
    assert torch.equal(xpieces, kernels.grid_extract_plain(grid, cx[:k], cy[:k], n))
    sub = tgrid._finish_extract(xpieces, oyx_k)
    want = kernels.degridder_plain(params, small, sub, rank)
    _gate(kernels.degridder_cuda_v7(params, small, xpieces, rank, fuse_oyx=oyx_k), want,
          K_PLAIN_GATE[n])
    _gate(kernels.degridder_cuda_v7(params, small, sub, rank), want, K_PLAIN_GATE[n])
    if rank == 2:
        pieces = kernels.gridder_cuda_v6_pieces(params, stg, oyx, rank)
        _gate(pieces, tgrid.pieces_from_subgrids(kernels.gridder_cuda_v6(params, stg, rank), oyx))
        plan = tgrid.plan_grid_add_ranges(md.coord_x, md.coord_y, g, n)
        assert torch.equal(kernels.grid_add_cuda(pieces, oyx, plan, g),
                           kernels.grid_add_cuda(pieces, oyx, plan, g))
        xpieces = kernels.grid_extract_cuda(grid, cx, cy, n)
        _gate(kernels.degridder_cuda_v7(params, stg, xpieces, rank, fuse_oyx=oyx),
              kernels.degridder_cuda_v7(params, stg, tgrid._finish_extract(xpieces, oyx), rank))


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["cuda_v1", "cuda_v2", "cuda_v3", "cuda_v4", "cuda_v5",
                                     "polstack"])
def test_rungs_match_plain_on_the_default_problem(default_problem, version):
    """The direct rungs (K8a, K9a) within DIRECT_PLAIN_GATE, the separable
    ones (K8b, K8c, K9b, K9c) and the pol-stacked degridder (K9d) within the
    gate of their plain versions at rank 2, on the first COMPARE_SUBGRIDS
    subgrids of the default problem, the plain versions on the card."""
    from idg_tpu_torch.ops.cuda.gridder_separable import plain_precisions

    params, _, stg, oyx, (cx, cy), grid = default_problem
    k, n = COMPARE_SUBGRIDS, params.subgrid_size
    small = slice_staged(stg, 0, k)
    sub = tgrid._finish_extract(kernels.grid_extract_cuda(grid, cx[:k], cy[:k], n), oyx[:k])
    if version == "polstack":
        pairs, gate = [(kernels.degridder_cuda_v6(params, small, sub, 2),
                        kernels.degridder_polstack_plain(params, small, sub, 2))], GATE
    elif version in ("cuda_v1", "cuda_v2"):
        rec, gate = version == "cuda_v2", DIRECT_PLAIN_GATE
        pairs = [(getattr(kernels, f"gridder_{version}")(params, small),
                  kernels.gridder_direct_plain(params, small, rec)),
                 (getattr(kernels, f"degridder_{version}")(params, small, sub),
                  kernels.degridder_direct_plain(params, small, sub, rec))]
    else:
        prec, rec, gate = plain_precisions(version, 2), version == "cuda_v5", GATE
        pairs = [(getattr(kernels, f"gridder_{version}")(params, small, 2),
                  kernels.gridder_separable_plain(params, small, 2, prec, rec)),
                 (getattr(kernels, f"degridder_{version}")(params, small, sub, 2),
                  kernels.degridder_separable_plain(params, small, sub, 2, prec, rec))]
    for got, want in pairs:
        _gate(got, want, gate)


# LOFAR-4096 (27 stations on a 4096² grid: a sparse range plan, 7,020
# subgrids) and the default problem on a 16384² grid (the merged plan, m = 64)
LOFAR_4096 = dict(grid_size=4096, nr_stations=27)
GRID_16384 = dict(grid_size=16384)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [{}, LOFAR_4096, GRID_16384], ids=["default", "lofar4096", "16384"])
def test_grid_add_kernels_match_plain_at_full_size(card, size):
    """The grid-add kernels at the shapes the `grid` command and the
    pipelines give them, on random block-rolled pieces: K11a on the default
    problem; K4 (within the gate, twice bit for bit), K6 and K11b on
    LOFAR-4096; K7 on one 16384² stripe with wrap misses."""
    params = IDGParams(**size)
    g, n = params.grid_size, params.subgrid_size
    md = make_perf_observation(params).metadata
    _, cx, cy = tgrid.sorted_block_coords(md.coord_x, md.coord_y, g, n)
    gen = torch.Generator(device=card).manual_seed(11)
    tiles = torch.randn((params.nr_subgrids, params.nr_correlations, n, n),
                        dtype=torch.complex64, device=card, generator=gen)
    oyx = torch.as_tensor(tgrid.roll_offsets(cx, cy, g, n), device=card)
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    if size == GRID_16384:
        mplan = tgrid.merged_plan_for(plan)
        assert mplan is not None and mplan.m == 64
        masked = tgrid._mask_pieces(tiles, oyx[:, 0], oyx[:, 1])
        stripe = (tgrid.MAX_RANGE_BLOCKS // plan.nbx) * plan.nbx
        lo = int(mplan.miss_blocks[0]) // stripe * stripe
        _gate(kernels.grid_add_merged_cuda(masked, plan, mplan, lo, lo + stripe),
              kernels.grid_add_merged_plain(masked, plan, mplan, lo, lo + stripe))
        return
    splan = tgrid.plan_grid_add(cx, cy, g, n)
    quad = tgrid._quadrant_pieces(tiles, cy, cx, g)
    if not size:
        _gate(kernels.grid_add_scatter_cuda(quad, splan),
              kernels.grid_add_scatter_plain(quad, splan))
        return
    assert plan.nbp > 2 * params.nr_subgrids      # sparse
    got = kernels.grid_add_cuda(tiles, oyx, plan, g)
    assert torch.equal(got, kernels.grid_add_cuda(tiles, oyx, plan, g))
    _gate(got, kernels.grid_add_plain(tiles, oyx, plan, g))
    masked = tgrid._mask_pieces(tiles, oyx[:, 0], oyx[:, 1])
    _gate(kernels.grid_add_pieces_cuda(masked, plan), kernels.grid_add_pieces_plain(masked, plan))
    _gate(kernels.grid_add_slots_cuda(quad, splan), kernels.grid_add_slots_plain(quad, splan))


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["default", "n16"])
def test_probed_k1_and_k2_match_unprobed_bitwise_and_sum_their_phases(card, problem):
    """Under a profiler one launch in PROBE_EVERY of the fused K1 and K2
    runs their probed instances (utils/trace.py:probe): the same output, bit
    for bit, as the unprobed kernels, on the default problem (N = 32) and at
    N = 16; the probe sums count every block of every probed launch, and
    each phase lies inside its whole."""
    from torch.profiler import ProfilerActivity, profile

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


DIRECT_ORACLE_GATE = 4e-6  # K8a and K9a (TF32, three passes) against the f64 oracle,
DIRECT_PLAIN_SLACK = 1.15  # or this × their plain version's own error where past that
DIRECT_PLAIN_GATE = 3e-6   # K8a and K9a against their plain versions


def _direct_oracle_gate(got, oracle, plain):
    """K8a's and K9a's bound against the oracle: DIRECT_ORACLE_GATE, or
    DIRECT_PLAIN_SLACK × the plain version's own error where the rung's
    definition (float32 phases) is itself past it."""
    err = check_error(got, oracle, verbose=False).mean_error
    own = check_error(plain, oracle, verbose=False).mean_error
    assert err <= max(DIRECT_ORACLE_GATE, DIRECT_PLAIN_SLACK * own), (err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_value,timesteps", [
    (16, 16, None, 16), (32, 11, None, 16), (32, 7, None, 16), (16, 16, 2.0e4, 16),
    (32, 16, 2.0e4, 16), (16, 256, None, 16), (32, 16, None, 37), (32, 16, None, 16),
])
def test_direct_kernels_match_plain_and_oracle(card, n, channels, w_value, timesteps):
    """K8a and K9a, full phase (v1) and channel recurrence (v2), on the TF32
    tensor cores; at 256 channels the recurrences hold the gate by their
    exact restarts every 8 channels; T = 37 is a ragged tile."""
    _hold_direct_gates(card, *_direct_problem(n, channels, w_value, timesteps))


@pytest.mark.cuda
def test_direct_kernels_hold_the_gates_on_the_correctness_problem(card):
    """The oracle gate on the correctness problem (T = 128) at the cases of
    scripts/time_direct.py:direct_oracle_problems (w = 0, 2·10⁴, C = 256 at
    N = 16, C = 7, 11, T = 37); its sums reach 7·10³, where K8a read 3.8e-6
    from its plain version on an H100, so plain is held at the check gate."""
    for _, params, obs, sub in _script("time_direct").direct_oracle_problems():
        _hold_direct_gates(card, params, obs, sub, plain_gate=GATE, check_gate=False)


def _hold_direct_gates(card, params, obs, sub, plain_gate=DIRECT_PLAIN_GATE, check_gate=True):
    """K8a and K9a, both rungs, within plain_gate of their plain versions
    and _direct_oracle_gate of the oracle; with check_gate, also within the
    check mode's gate of it (past which the correctness problem takes the
    plain version itself at C = 256)."""
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
        _gate(got, plain, plain_gate)
        if check_gate:
            _gate(got, grid_oracle)
        _direct_oracle_gate(got, grid_oracle, plain)
        got = degridder(params, stg_gpu, sub_gpu)
        torch.cuda.synchronize()
        plain = kernels.degridder_direct_plain(params, stg_cpu, sub_cpu, recurrence)
        _gate(got, plain, plain_gate)
        if check_gate:
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


SEPARABLE = ("v3", "v4", "v5")
# the separable rungs' mean errors against the f64 oracle at w = 0 on the
# correctness problem before their redesign (NVIDIA H100 80GB HBM3, 700 W);
# the redesigned kernels stay within 10% of them
SEPARABLE_W0_ERRORS = {("gridder", "v3"): 2.673e-06, ("gridder", "v4"): 2.775e-06,
                       ("gridder", "v5"): 8.645e-06, ("degridder", "v3"): 6.824e-07,
                       ("degridder", "v4"): 7.024e-06, ("degridder", "v5"): 7.121e-06}


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_scale", [
    (16, 8, None), (32, 7, None), (16, 8, 45.0), (16, 8, 1000.0), (32, 16, 1000.0),
    (16, 48, None), (32, 48, None), (32, 7, "ragged"), (16, 7, "ragged"), (32, 16, "check"),
])
def test_separable_kernels_match_plain_and_oracle(card, n, channels, w_scale):
    """K8b (v3, v4), K8c (v5), K9b (v3, v4) and K9c (v5) against their plain
    versions and the oracle: T = 16 is one ragged tile, 7 and 48 channels a
    short and a resyncing recurrence (restarts at c = 16 and 32, N = 16 and
    32), w_scale 45 the rank-2 bf16 pass with μ != 0, w_scale 1000 rank 4
    (all passes bf16_3x), and V = 37·7 a ragged last tile of 32 visibilities
    (v3, v4) and of 32 timesteps (v5); on the correctness problem within
    1.1× SEPARABLE_W0_ERRORS."""
    params, obs, sub, rank = _inputs(n, channels, w_scale)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    sub_cpu, sub_gpu = torch.from_numpy(sub), torch.from_numpy(sub).to(card)
    grid_oracle = gridder_reference(params, obs)
    degrid_oracle = degridder_reference(params, obs, sub)
    for version in SEPARABLE:
        bound = {w: 1.1 * SEPARABLE_W0_ERRORS[w, version] if w_scale == "check" else GATE
                 for w in ("gridder", "degridder")}
        gridder = getattr(kernels, f"gridder_cuda_{version}")
        degridder = getattr(kernels, f"degridder_cuda_{version}")
        got = gridder(params, stg_gpu, rank)
        torch.cuda.synchronize()
        _gate(got, gridder(params, stg_cpu, rank))
        _gate(got, grid_oracle, bound["gridder"])
        got = degridder(params, stg_gpu, sub_gpu, rank)
        torch.cuda.synchronize()
        _gate(got, degridder(params, stg_cpu, sub_cpu, rank))
        _gate(got, degrid_oracle, bound["degridder"])


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


# K9d's mean errors against the f64 oracle on the correctness problem
# before its redesign (NVIDIA H100 80GB HBM3, 700 W), by (C, problem); the
# redesigned kernel stays within 1.1× them
K9D_ORACLE_ERRORS = {(16, "check"): 5.626e-06, (16, "check-1000"): 5.628e-06,
                     (48, "check"): 7.002e-06}


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_scale", [
    (16, 8, None), (32, 16, None), (16, 8, 45.0), (16, 8, 1000.0), (32, 16, 1000.0),
    (16, 48, None), (32, 48, None), (32, 8, 45.0), (32, 7, "ragged"), (16, 7, "ragged"),
    (32, 16, "check"), (32, 16, "check-1000"), (32, 48, "check"),
])
def test_polstack_kernel_matches_plain_and_oracle(card, n, channels, w_scale):
    """K9d (degridder cuda_v6) against its plain version and the oracle at
    N = 16 and 32: rank 2 at w = 0 and with μ != 0 (w_scale 45, the rank-1
    single bf16 pass), rank 4 (w_scale 1000, "3x2k" throughout), 48
    channels, where the recurrence resyncs at c = 16 and 32, and V = 37·7, a
    ragged last tile of 32 timesteps; on the correctness problem within
    1.1× K9D_ORACLE_ERRORS."""
    params, obs, sub, _ = _inputs(n, channels, w_scale)
    rank = _resolve("degridder", "cuda_v6", params, obs)[1] or 2
    assert (rank == 4) == (w_scale in (1000.0, "check-1000"))
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    got = kernels.degridder_cuda_v6(params, stg_gpu, torch.from_numpy(sub).to(card), rank)
    torch.cuda.synchronize()
    _gate(got, kernels.degridder_cuda_v6(params, stg_cpu, torch.from_numpy(sub), rank))
    bound = 1.1 * K9D_ORACLE_ERRORS[channels, w_scale] if w_scale in CHECK else GATE
    _gate(got, degridder_reference(params, obs, sub), bound)


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


def _instances():
    """(id, mangled-name pattern, the tensor-core opcode its products run on
    or None for the CUDA cores, whether it takes the turned m64n128k8
    product (K1, K2) or None, the pattern of its non-fused form (a fused
    K1 or K2: K3's products come on top))."""
    def name(stem, *targs):
        return f"{len(stem)}{stem}ILi{'E'.join(map(str, targs))}EE"

    out = []
    for n in (16, 32):
        for f in (0, 1):
            base = name("gridder_kernel", n, "Lb0", "Lb0") if f else None
            out.append((f"K1-{n}-fuse{f}", name("gridder_kernel", n, f"Lb{f}", "Lb0"), "HGMMA",
                        n == 32, base))
            for t in (0, 1) if n == 32 else (0,):
                base = name("degridder_kernel", n, "Lb0", "Lb0", f"Lb{t}") if f else None
                out.append((f"K2-{n}-fuse{f}-turned{t}",
                            name("degridder_kernel", n, f"Lb{f}", "Lb0", f"Lb{t}"), "HGMMA",
                            bool(t), base))
        out.append((f"K4-{n}", name("grid_add_kernel", n), None, None, None))
        for r in (0, 1):
            for w in ("gridder", "degridder"):
                out.append((f"{w}-direct-{n}-recur{r}", name(f"{w}_direct_kernel", n, f"Lb{r}"),
                            "HMMA", None, None))
        for v in (3, 4, 5):
            for w in ("gridder", "degridder"):
                out.append((f"{w}-sep-v{v}-{n}", name(f"{w}_sep_v{v}_kernel", n),
                             None if v == 3 else "HGMMA", None, None))
        out.append((f"K9d-{n}", name("degridder_polstack_kernel", n), "HGMMA", None, None))
    return out


# spill bytes an instance may have: K9b v4 (degridder cuda_v4) spills 8 B
# at both N (ptxas -v on an H100 host); every other instance spills none
SPILL_BYTES = {"degridder-sep-v4-16": 8, "degridder-sep-v4-32": 8}


@pytest.fixture(scope="module")
def built(card):
    """({mangled name: (spill stores, spill loads)} from ptxas's report in
    nvcc's log, {function: its SASS lines} from `cuobjdump --dump-sass`)."""
    from idg_tpu_torch.ops.cuda import build

    library = build.build()
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        pytest.skip(f"needs cuobjdump beside nvcc ({cuobjdump} is missing)")
    spills, name = {}, None
    for line in build.build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        name = entry.group(1) if entry else name
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and name:
            spills[name] = (int(found.group(1)), int(found.group(2)))
    sass, name = {}, None
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(library)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            sass[name] = []
        elif name:
            sass[name].append(line)
    return spills, sass


@pytest.mark.cuda
@pytest.mark.parametrize("label,pattern,opcode,turned,base", _instances(),
                         ids=[case[0] for case in _instances()])
def test_kernel_instances_build_without_spills_on_their_units(built, label, pattern, opcode,
                                                             turned, base):
    """Every instance (__global__ × template arguments) of K1, K2, K4, the
    direct (K8a, K9a), separable (K8b, K8c, K9b, K9c) and pol-stacked (K9d)
    kernels is built, spills nothing, and runs its products on the units it
    was written for: HMMA (mma.sync) for the direct rungs, HGMMA (wgmma) for
    K1, K2, K9d and the bf16 separable rungs, neither for K4 and v3. Each
    fused K1 and K2 has more HGMMA than its non-fused form (K3), and the
    turned product (HGMMA.64x128) is N = 32's: K1's, and K2's kTurned."""
    spills, sass = built
    (name,) = [fn for fn in spills if pattern in fn]
    assert max(spills[name]) <= SPILL_BYTES.get(label, 0), spills[name]

    def count(fn, op):
        return sum(bool(re.search(op, line)) for line in sass[fn])

    ops = {op: count(name, rf"\b{op}\b") for op in ("HGMMA", "HMMA")}
    assert (ops == {"HGMMA": 0, "HMMA": 0}) if opcode is None else ops[opcode] > 0, ops
    if turned is not None:
        shapes = {m for line in sass[name] for m in re.findall(r"HGMMA\.\w+", line)}
        assert (count(name, r"HGMMA\.64x128x") > 0) == turned, shapes
    if base is not None:
        (plain,) = [fn for fn in sass if base in fn]
        assert ops["HGMMA"] > count(plain, r"\bHGMMA\b")


# The CLI's small problems (the reference's env vars): a dense range plan
# (64 blocks for 40 subgrids) and a sparse one (4,096 blocks for 560
# subgrids: `grid`'s auto pick takes the ranges, K4, and the slot plan
# overflows the resident block array, so --method pallas takes K11b)
DENSE = {"GRID_SIZE": "256", "NR_STATIONS": "5", "NR_TIMESLOTS": "4"}
SPARSE = {"GRID_SIZE": "2048", "NR_STATIONS": "8", "NR_TIMESLOTS": "20"}
# and at full size: the default problem, LOFAR-4096 and the 16384² grid
FULL = {"GRID_SIZE": "1024", "NR_STATIONS": "50", "NR_TIMESLOTS": "20",
        "NR_TIMESTEPS_SUBGRID": "128", "NR_CHANNELS": "16"}
FULL_LOFAR = dict(FULL, GRID_SIZE="4096", NR_STATIONS="27")
FULL_16384 = dict(FULL, GRID_SIZE="16384")


@pytest.fixture
def cli_env(card, monkeypatch, tmp_path):
    """The CLI on a small problem, one timed window of one launch, its CSVs
    in tmp_path; returns monkeypatch to set the problem's size."""
    for key, value in {"SUBGRID_SIZE": "32", "NR_TIMESTEPS_SUBGRID": "16", "NR_CHANNELS": "8",
                       "NR_WARM_UP_RUNS": "1", "NR_ITERATIONS": "1", "NR_WINDOWS": "1",
                       "OUTPUT_PATH": str(tmp_path), **DENSE}.items():
        monkeypatch.setenv(key, value)
    return monkeypatch


@pytest.mark.cuda
@pytest.mark.parametrize("problem", [DENSE, SPARSE, FULL, FULL_LOFAR],
                         ids=["dense", "sparse", "default", "lofar4096"])
@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_pipeline_command_launches_its_kernels(cli_env, direction, problem):
    """`pipeline` (card-only) launches every kernel of its path and never
    K6, on dense and sparse range plans alike (small, and at full size the
    default problem and LOFAR-4096), and gives its --no-fuse composition's
    output within the gate over max |output|."""
    from idg_tpu_torch import cli

    for key, value in problem.items():
        cli_env.setenv(key, value)
    results, run = [], cli._pipeline_one
    cli_env.setattr(cli, "_pipeline_one", lambda *a, **kw: results.append(run(*a, **kw)))
    kernels.reset_launch_counts()
    assert cli.main(["pipeline", "--direction", direction]) == 0
    counts = _launches()
    path = {"grid": ("gridder_cuda_v6_pieces", "grid_add_cuda"),
            "degrid": ("grid_extract_cuda", "degridder_cuda_v7_fused")}[direction]
    assert all(counts[name] for name in path) and not counts["grid_add_pieces_cuda"], counts
    assert cli.main(["pipeline", "--direction", direction, "--no-fuse"]) == 0
    fused, plain = (res.output for res in results)
    scale = float(plain.abs().max())
    _gate(fused / scale, plain / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("problem,args,kernel", [
    (DENSE, [], "grid_add_cuda"),
    (DENSE, ["--no-fft", "--method", "ranges"], "grid_add_pieces_cuda"),
    (DENSE, ["--method", "pallas"], "grid_add_scatter_cuda"),
    (SPARSE, [], "grid_add_cuda"),
    (SPARSE, ["--method", "pallas"], "grid_add_slots_cuda"),
    (DENSE, ["--direction", "to-subgrids"], "grid_extract_cuda"),
    (FULL_LOFAR, [], "grid_add_cuda"),
    (FULL_LOFAR, ["--method", "pallas"], "grid_add_slots_cuda"),
    (FULL_16384, [], "grid_add_merged_cuda"),
    (FULL_16384, ["--direction", "to-subgrids"], "grid_extract_cuda"),
], ids=["default", "no-fft", "pallas", "sparse", "sparse-pallas", "to-subgrids", "lofar4096",
        "lofar4096-pallas", "16384", "16384-to-subgrids"])
def test_grid_command_launches_its_kernel(cli_env, problem, args, kernel):
    """Each path of `grid` (card-only) that reaches a grid-stage kernel
    launches it; the sparse plans' default path (the small one's and
    LOFAR-4096's) takes K4, never K6; the 16384² grid takes K7."""
    from idg_tpu_torch import cli

    for key, value in problem.items():
        cli_env.setenv(key, value)
    kernels.reset_launch_counts()
    assert cli.main(["grid", *args]) == 0
    counts = _launches()
    assert counts[kernel], counts
    assert kernel != "grid_add_cuda" or not counts["grid_add_pieces_cuda"], counts


@pytest.mark.cuda
@pytest.mark.parametrize("argv,launched", [
    (["run", "--workload", "gridder", "--version", "cuda_v6", "--sustain", "1"],
     {"gridder_cuda_v6"}),
    (["run", "--workload", "degridder", "--version", "cuda_v7", "--sustain", "1"],
     {"degridder_cuda_v7"}),
    (["run", "--workload", "gridder", "--version", "cuda_v1"], {"gridder_cuda_v1"}),
    (["run", "--workload", "degridder", "--version", "torch_v1"], set()),
    (["vadd", "--cuda", "--n", str(1 << 20)], {"vadd_cuda"}),
    (None, {"gridder_cuda_v6", "degridder_cuda_v6", "gridder_cuda_v6_pieces", "grid_add_cuda"}),
], ids=["gridder-sustain", "degridder-sustain", "direct", "ladder", "vadd", "bench"])
def test_timed_commands_launch_as_they_report(cli_env, capsys, argv, launched):
    """Perf mode, its sustained window, vadd and the bench (argv None, with
    BENCH_DEGRIDDER_KERNEL=cuda_v6): every timed call launches each of its
    kernels once a pass it reports (the first launch, the warm-ups and the
    timed windows; a sustained window's launches and the 2 + NR_WARM_UP_RUNS
    before them), and the command launches `launched` and no other kernel
    (a ladder rung none)."""
    from idg_tpu_torch import bench, cli
    from idg_tpu_torch.utils import timing

    calls = []

    def counted(timer):
        def run(*args, **kwargs):
            before = _launches()
            res = timer(*args, **kwargs)
            after = _launches()
            calls.append((res, {k: after[k] - before[k] for k in after if after[k] > before[k]}))
            return res
        return run

    for name in ("time_kernel", "time_kernel_sustained"):
        cli_env.setattr(timing, name, counted(getattr(timing, name)))
    kernels.reset_launch_counts()
    if argv is None:
        cli_env.setenv("BENCH_DEGRIDDER_KERNEL", "cuda_v6")
        assert bench.main() == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["degridder_metric"] == "degridder_cuda_v6_throughput", line
    else:
        assert cli.main(argv) == 0
    assert calls
    warm = HarnessConfig.from_env().nr_warm_up_runs
    for res, counts in calls:
        if isinstance(res, timing.SustainedResult):
            passes = res.launches + 2 + warm
        else:
            passes = 1 + res.warmup_runs + sum(n for n, _ in res.timed_windows)
        counts.pop("degridder_cuda_v7_fused", None)
        assert all(n == passes for n in counts.values()), (passes, counts)
    assert set().union(*(counts for _, counts in calls)) == launched
    assert {k for k, n in _launches().items() if n} == launched


@pytest.mark.cuda
def test_validate_script_passes_every_rung(card, tmp_path):
    """scripts/validate_cuda.py on the card: every registered rung against
    the oracle at w = 0 and w != 0, the grid stage and the fused pipelines;
    no row FAILED or ERROR."""
    out = tmp_path / "VALIDATION.md"
    assert _script("validate_cuda").main(["--out", str(out)]) == 0
    table = out.read_text()
    assert "| FAILED |" not in table and "| ERROR |" not in table


# the kernels whose count in a trace equals their launches in its windows:
# (__global__ name, whether the instance is fused, or None)
TRACE_EXACT = {"gridder_cuda_v6_pieces": ("gridder_kernel", True),
               "grid_add_cuda": ("grid_add_kernel", None),
               "grid_extract_cuda": ("grid_extract_kernel", None),
               "degridder_cuda_v7_fused": ("degridder_kernel", True)}
TRACE_SPAN_SLACK = 0.05   # a trace's device span a pass against the CUDA-event seconds


# `pipeline` with IDG_PROFILE_DIR set, each time_kernel call's trace with
# the launches made in its windows and their (iterations, seconds); run in
# a fresh process: a trace taken about a minute after the process's first
# profiler run missed the first launches of its windows (torch 2.11)
TRACED_PIPELINE = r"""
import contextlib, json, sys
from idg_tpu_torch import cli
from idg_tpu_torch.utils import timing
from test_torch_cuda import _launches as launches

windows, traced, timed = [], timing.trace_window, timing.time_kernel

@contextlib.contextmanager
def counted_window(profile_dir, label="fn"):
    before = launches()
    with traced(profile_dir, label) as path:
        yield path
    after = launches()
    windows.append({"path": path, "launches": {k: after[k] - before[k] for k in after}})

def noted_time(*args, **kwargs):
    res = timed(*args, **kwargs)
    windows[-1]["timed_windows"] = res.timed_windows
    return res

timing.trace_window, timing.time_kernel = counted_window, noted_time
assert cli.main(["pipeline", "--direction", sys.argv[1]]) == 0
print(json.dumps(windows))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_traced_pipeline_holds_launches_and_event_time(card, tmp_path, direction):
    """`pipeline` on the default problem with IDG_PROFILE_DIR set: each
    time_kernel call writes a trace (utils/trace.py:trace_window) that
    scripts/trace_tools_cuda.py reads. In each, K1's fused form, K4, K5 and
    K2's fused form appear as often as they launched in the traced windows,
    and the device span a pass is within TRACE_SPAN_SLACK of time_kernel's
    CUDA-event seconds over the same windows."""
    tools = _script("trace_tools_cuda")
    env = dict(os.environ, IDG_PROFILE_DIR=str(tmp_path), OUTPUT_PATH=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", TRACED_PIPELINE, direction], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    windows = json.loads(out.stdout.strip().splitlines()[-1])
    assert windows
    for window in windows:
        seen = {}
        for e in tools.load_events(window["path"]):
            if e.get("cat") == "kernel":
                base, targs = tools.kernel_base(e["name"])
                fused = (targs.split(",")[1].strip() in ("true", "(bool)1", "1")
                         if base in ("gridder_kernel", "degridder_kernel") else None)
                seen[base, fused] = seen.get((base, fused), 0) + 1
        for name, key in TRACE_EXACT.items():
            assert seen.get(key, 0) == window["launches"][name], (name, window["launches"], seen)
        passes = sum(n for n, _ in window["timed_windows"])
        span_ms = tools.summarize(window["path"])["streams"][0]["span_ms"] / passes
        event_ms = sum(t for _, t in window["timed_windows"]) * 1e3 / passes
        assert abs(span_ms / event_ms - 1.0) <= TRACE_SPAN_SLACK, (span_ms, event_ms)


def _same_or_gated(got, want):
    """Bit for bit, or within the gate over max |want| (check_error's metric
    as a normalized RMS), the max abs difference shown."""
    if not torch.equal(got, want):
        scale = float(want.abs().max())
        diff = float((got - want).abs().max())
        assert check_error(got / scale, want / scale, verbose=False).mean_error <= GATE, diff


@pytest.mark.cuda
def test_mesh_of_one_on_nccl_matches_the_single_device_paths(card):
    """The multi-device layer at a world of one on NCCL: the staged rungs
    (gridder cuda_v6, degridder cuda_v7) against api.staged_runner; the
    per-rank range recipe (K1's fused form into K4, all_reduce) against the
    `pipeline` command's recipe; the reduce_scatter + all_gather pair into
    K5 and K2 against the replicated path; K1, K4, K5 and K2 launch, K6
    never."""
    import torch.distributed as dist

    from idg_tpu_torch.ops.api import gridded_pipeline_parts, staged_runner
    from idg_tpu_torch.parallel import init_distributed, make_mesh
    from idg_tpu_torch.parallel import sharded as psh

    params = IDGParams(grid_size=256, nr_stations=5, nr_timeslots=4, nr_timesteps_subgrid=16,
                       nr_channels=8)
    obs = make_perf_observation(params)
    subgrids = initialize_subgrids(params.nr_subgrids, params.nr_correlations,
                                   params.subgrid_size)
    dev = init_distributed(device=card)
    try:
        mesh = make_mesh(1)
        for workload, version in (("gridder", "cuda_v6"), ("degridder", "cuda_v7")):
            version, w_rank = _resolve(workload, version, params, obs)
            sub = subgrids if workload == "degridder" else None
            stg, sub_loc = psh.shard_staged_inputs(params, obs, mesh, workload, sub, dev)
            if workload == "gridder":
                got = psh.sharded_gridder_staged(params, mesh, version, w_rank)(stg)
            else:
                got = psh.sharded_degridder_staged(params, mesh, version, w_rank)(stg, sub_loc)
            fn, args = staged_runner(workload, version, params, obs, sub, w_rank, dev)
            _same_or_gated(got, fn(*args))

        version, w_rank = _resolve("gridder", "cuda_v6", params, obs)
        dversion, dw_rank = _resolve("degridder", "cuda_v7", params, obs)
        sorted_obs, _ = tgrid.sort_observation_blocks(obs, params.grid_size,
                                                      params.subgrid_size)
        pfn, pargs, gfn, _, _ = gridded_pipeline_parts(params, sorted_obs, version, w_rank,
                                                       device=dev)
        want = gfn(pfn(*pargs))
        local, _, plan = psh.shard_observation_block_sorted(params, obs, mesh, dev)
        kernels.reset_launch_counts()
        grid = psh.sharded_gridder_to_grid(params, mesh, version, w_rank=w_rank,
                                           grid_method="ranges")(local, plan)
        block = psh.sharded_gridder_to_grid(params, mesh, version, grid_sharded=True,
                                            w_rank=w_rank, grid_method="ranges")(local, plan)
        vis_gather = psh.sharded_grid_to_degridder_gather(params, mesh, dversion,
                                                          w_rank=dw_rank)(local, block)
        torch.cuda.synchronize()
        counts = _launches()
        vis_repl = psh.sharded_grid_to_degridder(params, mesh, dversion,
                                                 w_rank=dw_rank)(local, grid)
        _same_or_gated(grid, want)
        _same_or_gated(block, grid)
        _same_or_gated(vis_gather, vis_repl)
        path = ("gridder_cuda_v6_pieces", "grid_add_cuda", "grid_extract_cuda",
                "degridder_cuda_v7")
        assert all(counts[name] for name in path) and not counts["grid_add_pieces_cuda"], counts
    finally:
        dist.destroy_process_group()
