"""The port's grid stage and both pipelines against the JAX package, on
identical inputs, at small size on the CPU.

Problem: grid 128, N = 16, P = 4, 5 stations × 4 timeslots = 40 subgrids,
T = 8, C = 8: 64 grid blocks ≤ 2·S, so the range plan takes the tile path
(the problem of tests/test_pallas_kernels.py:348); the sparse case is the
3-station, 2-timeslot problem (6 subgrids). On CPU tensors the wrappers
(`gridder_cuda_v6_pieces`, `grid_add_cuda`, `grid_extract_cuda`, the fused
`degridder_cuda_v7`) run their plain versions; the JAX side runs its Pallas
kernels in interpret mode and its XLA fallbacks, as its own tests do. The
CUDA kernels themselves meet these plain versions on the card, in
`-m cuda tests/test_torch_cuda.py`.

Gate: the reference's 1e-5 normalized-RMS comparator (`check_error`)
everywhere, except where an exact equality is stated: the host plans, and
the extraction, which is a pure gather. The degrid input grid is
normal(0, 1)/N², so the visibilities are O(1) like the reference's
correctness data: check_error's metric grows with the square root of the
values' magnitude, and at the unscaled grid's |vis| ≈ 230 the JAX pallas_v7
(bf16 split products) is itself 2.8e-5 from the f64 oracle, where the port
is 2.3e-6. Observed here with the scaled grid: degrid pipeline 1.6e-6 from
JAX pallas_v7 and 1.3e-7 from the f64 composition.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import idg_tpu.data as jdata
import idg_tpu.ops.api as japi
import idg_tpu.ops.grid as jgrid
import idg_tpu_torch.config as tcfg
import idg_tpu_torch.ops.grid as tgrid
from idg_tpu.config import IDGParams
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops.api import _resolve
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.types import from_numpy_observation, grid_from_pair, grid_to_pair
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
CASES = {
    "tile": IDGParams(grid_size=128, subgrid_size=16, nr_stations=5, nr_timeslots=4,
                      nr_timesteps_subgrid=8, nr_channels=8),
    "sparse": IDGParams(grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
                        nr_timesteps_subgrid=16, nr_channels=8),
}


@dataclasses.dataclass
class Problem:
    case: str                  # a key of CASES
    params: IDGParams          # JAX package's
    tparams: tcfg.IDGParams    # the port's
    obs: object                # JAX observation, block-sorted
    tobs: object               # the port's, same numbers
    oyx: np.ndarray            # i32[S, 2]
    rank: int
    grid_pair: tuple           # f32[P, G, G] × 2, the degrid input

    @property
    def coords(self):
        md = self.obs.metadata
        return np.asarray(md.coord_x), np.asarray(md.coord_y)


@functools.lru_cache(maxsize=None)
def _problem(case: str) -> Problem:
    params = CASES[case]
    g, n = params.grid_size, params.subgrid_size
    obs, _ = jdata.make_observation(params)
    obs, _ = jgrid.sort_observation_blocks(obs, g, n)
    tobs = from_numpy_observation(obs)
    tparams = tcfg.IDGParams(**dataclasses.asdict(params))
    md = obs.metadata
    rng = np.random.default_rng(11)
    grid_pair = tuple((rng.normal(size=(params.nr_correlations, g, g)) / n**2)
                      .astype(np.float32) for _ in range(2))
    return Problem(case, params, tparams, obs, tobs,
                   tgrid.roll_offsets(md.coord_x, md.coord_y, g, n),
                   _resolve("gridder", "cuda_v6", tparams, tobs)[1] or 2, grid_pair)


@pytest.fixture(params=list(CASES))
def problem(request):
    return _problem(request.param)


def _pair(x):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x.real, np.float32), np.ascontiguousarray(x.imag, np.float32)


def _complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _gate(got, want):
    res = check_error(got, want, verbose=False)
    assert res.mean_error <= GATE, res


def _port_pieces(pb):
    stg = stage(pb.tparams, pb.tobs, "cpu")
    return kernels.gridder_cuda_v6_pieces(pb.tparams, stg, torch.from_numpy(pb.oyx), pb.rank)


def _port_subgrids(pb):
    return kernels.gridder_cuda_v6(pb.tparams, stage(pb.tparams, pb.tobs, "cpu"), pb.rank)


# (a) host plans ------------------------------------------------------------

def test_sort_and_range_plan_equal_jax(problem):
    params, g, n = problem.params, problem.params.grid_size, problem.params.subgrid_size
    raw, _ = jdata.make_observation(params)
    md = raw.metadata
    np.testing.assert_array_equal(tgrid.block_sort_order(md.coord_x, md.coord_y, g, n),
                                  jgrid.block_sort_order(md.coord_x, md.coord_y, g, n))
    tsorted, torder = tgrid.sort_observation_blocks(from_numpy_observation(raw), g, n)
    jsorted, jorder = jgrid.sort_observation_blocks(raw, g, n)
    np.testing.assert_array_equal(torder, jorder)
    for f in dataclasses.fields(tsorted.metadata):
        np.testing.assert_array_equal(getattr(tsorted.metadata, f.name),
                                      getattr(jsorted.metadata, f.name))
    order, cx, cy = tgrid.sorted_block_coords(md.coord_x, md.coord_y, g, n)
    np.testing.assert_array_equal(order, jorder)
    tplan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    jplan = jgrid.plan_grid_add_ranges(cx, cy, g, n)
    for name in ("starts", "tstarts", "lens"):
        np.testing.assert_array_equal(getattr(tplan, name), getattr(jplan, name))
        assert getattr(tplan, name).dtype == getattr(jplan, name).dtype
    assert (tplan.w, tplan.nbp, tplan.nby, tplan.nbx) == (jplan.w, jplan.nbp, jplan.nby, jplan.nbx)
    np.testing.assert_array_equal(tplan.home_blocks(), (cy % g // n) * (g // n) + cx % g // n)
    with pytest.raises(ValueError, match="block-sorted"):
        tgrid.plan_grid_add_ranges(cx[::-1], cy[::-1], g, n)


# (b) the fused gridder's pieces -----------------------------------------------

def test_pieces_match_jax_producer_on_the_same_subgrids(problem):
    g, n = problem.params.grid_size, problem.params.subgrid_size
    sub = _port_subgrids(problem)
    oy, ox = problem.oyx[:, 0], problem.oyx[:, 1]
    want = jgrid.fft2_shift_pair(
        jgrid._phase_roll_fourier(_pair(sub), oy, ox, shifted=True), inverse=True)
    oyx = torch.from_numpy(problem.oyx)
    _gate(tgrid.pieces_from_subgrids(sub, oyx), _complex(want))
    # the CUDA epilogue's design: the roll as an exact index permutation of
    # the inverse DFT's output instead of Fourier phases on its input
    rolled = tgrid._roll_tiles(tgrid.fft2_shift(sub, inverse=True), oyx[:, 0], oyx[:, 1])
    _gate(rolled, _complex(want))
    _gate(_port_pieces(problem), _complex(want))


def test_pieces_match_pallas_v6_pieces():
    import jax

    from idg_tpu.ops.pallas import STAGED
    from idg_tpu.ops.pallas.gridder import gridder_pallas_v6_pieces
    from idg_tpu.types import split_observation

    problem = _problem("tile")   # one case: the interpret-mode kernel is the slow side
    stage_fn, _ = STAGED[("gridder", "pallas_v6")]
    stg = jax.jit(lambda p, s: stage_fn(p, s, with_vis=True), static_argnums=0)(
        problem.params, split_observation(problem.obs))
    want = gridder_pallas_v6_pieces(problem.params, stg, problem.oyx, interpret=True,
                                    w_rank=problem.rank)
    _gate(_port_pieces(problem), _complex(want))


# (c) the range grid-add -----------------------------------------------------

def test_grid_add_matches_jax_ranges_and_scatter(problem):
    g = problem.params.grid_size
    cx, cy = problem.coords
    sub = _port_subgrids(problem)
    got = tgrid.subgrids_to_grid_ranges(None, cx, cy, g, tiles=_port_pieces(problem))
    assert got.shape == (4, g, g) and got.dtype == torch.complex64
    want_xla = _complex(jgrid.subgrids_to_grid(_pair(sub), cx, cy, g))
    _gate(got, want_xla)
    _gate(tgrid.subgrids_to_grid(sub, cx, cy, g), want_xla)
    _gate(tgrid.subgrids_to_grid_ranges(sub, cx, cy, g), want_xla)
    if problem.case == "tile":   # the JAX tile path; (h) covers the sparse one
        want_ranges = jgrid.subgrids_to_grid_ranges(_pair(sub), cx, cy, g, apply_fft=True,
                                                    interpret=True)
        _gate(got, _complex(want_ranges))


def test_grid_add_plain_sums_every_run(problem):
    """K4's function, written as the kernel computes it (per block and
    quadrant, the masked sum of the block's run), equals the plain version."""
    g, n = problem.params.grid_size, problem.params.subgrid_size
    cx, cy = problem.coords
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    pieces = _port_pieces(problem)
    oyx = torch.from_numpy(problem.oyx)
    i = torch.arange(n)
    grid = torch.zeros((4, g, g), dtype=torch.complex64)
    for b in range(plan.nb):
        by, bx = divmod(b, plan.nbx)
        for q, (qy, qx) in enumerate(tgrid._QUADRANTS):
            t0, ln = int(plan.tstarts[q, b]), int(plan.lens[q, b])
            for t in range(t0, t0 + ln):
                my = (i >= oyx[t, 0]) == (qy == 0)
                mx = (i >= oyx[t, 1]) == (qx == 0)
                grid[:, by * n:(by + 1) * n, bx * n:(bx + 1) * n] += \
                    pieces[t] * (my[:, None] & mx[None, :])
    _gate(kernels.grid_add_cuda(pieces, oyx, plan, g), grid)


# (d) the range extraction ---------------------------------------------------

def test_extraction_equals_jax_ranges_exactly(problem):
    n = problem.params.subgrid_size
    cx, cy = problem.coords
    got = tgrid.grid_to_subgrids_ranges(grid_from_pair(problem.grid_pair), cx, cy, n,
                                        pieces=True)
    if problem.case == "tile":
        want = jgrid.grid_to_subgrids_ranges(problem.grid_pair, cx, cy, n, apply_fft=True,
                                             pieces=True, interpret=True)
    else:
        # sparse: gather the windows and roll them, in numpy
        g = problem.params.grid_size
        rows = (cy[:, None] % g + np.arange(n)) % g
        cols = (cx[:, None] % g + np.arange(n)) % g
        win = [v[:, rows[:, :, None], cols[:, None, :]].transpose(1, 0, 2, 3)
               for v in problem.grid_pair]
        want = [np.stack([np.roll(w[s], tuple(problem.oyx[s]), axis=(1, 2))
                          for s in range(w.shape[0])]) for w in win]
    re, im = _pair(got)
    np.testing.assert_array_equal(re, np.asarray(want[0]))
    np.testing.assert_array_equal(im, np.asarray(want[1]))


# (e) the fused degridder's input -------------------------------------------

def test_fused_degridder_input_matches_finish_extract(problem):
    g, n = problem.params.grid_size, problem.params.subgrid_size
    cx, cy = problem.coords
    grid = grid_from_pair(problem.grid_pair)
    pieces = tgrid.grid_to_subgrids_ranges(grid, cx, cy, n, pieces=True)
    oyx = torch.from_numpy(problem.oyx)
    want = _complex(jgrid._finish_extract(_pair(pieces), cx, cy, g, n, True))
    got = tgrid._finish_extract(pieces, oyx)
    _gate(got, want)
    # the CUDA prologue's design: un-roll as an index permutation, then the DFT
    _gate(tgrid.fft2_shift(tgrid._roll_tiles(pieces, -oyx[:, 0], -oyx[:, 1])), want)
    _gate(tgrid.grid_to_subgrids_ranges(grid, cx, cy, n), want)
    stg = stage(problem.tparams, problem.tobs, "cpu", with_vis=False)
    fused = kernels.degridder_cuda_v7(problem.tparams, stg, pieces, problem.rank, fuse_oyx=oyx)
    _gate(fused, kernels.degridder_cuda_v7(problem.tparams, stg, got, problem.rank))


# (f), (g) both pipelines against JAX and an f64 numpy composition --------------

def _gridded_pipeline(pb):
    from idg_tpu_torch.ops.api import gridded_pipeline_parts

    pfn, pargs, gfn, version, _ = gridded_pipeline_parts(pb.tparams, pb.tobs, device="cpu")
    assert version == "cuda_v6"
    return gfn(pfn(*pargs))


def _degrid_pipeline(pb):
    from idg_tpu_torch.ops.api import staged_degridder_pieces_chunk_consumers

    cx, cy = pb.coords
    consumers, bounds, version = staged_degridder_pieces_chunk_consumers(
        pb.tparams, pb.tobs, oyx=pb.oyx, device="cpu")
    assert (len(consumers), bounds, version) == (1, [(0, len(cx))], "cuda_v7")
    pieces = tgrid.grid_to_subgrids_ranges(grid_from_pair(pb.grid_pair), cx, cy,
                                           pb.params.subgrid_size, pieces=True)
    return consumers[0](pieces)


def _f64_grid(pb):
    """Oracle subgrids, np.fft in f64 and a periodic np.add.at scatter."""
    g, n = pb.params.grid_size, pb.params.subgrid_size
    cx, cy = pb.coords
    sub = gridder_reference(pb.tparams, pb.tobs).astype(np.complex128)
    img = np.fft.fftshift(np.fft.ifft2(np.fft.fftshift(sub, axes=(-2, -1))), axes=(-2, -1))
    grid = np.zeros((sub.shape[1], g, g), np.complex128)
    rows = (cy[:, None] % g + np.arange(n)) % g
    cols = (cx[:, None] % g + np.arange(n)) % g
    for s in range(sub.shape[0]):
        np.add.at(grid, (slice(None), rows[s][:, None], cols[s][None, :]), img[s])
    return grid


def _f64_vis(pb):
    g, n = pb.params.grid_size, pb.params.subgrid_size
    cx, cy = pb.coords
    grid = _complex(pb.grid_pair)
    rows = (cy[:, None] % g + np.arange(n)) % g
    cols = (cx[:, None] % g + np.arange(n)) % g
    win = grid[:, rows[:, :, None], cols[:, None, :]].transpose(1, 0, 2, 3)
    sub = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(win, axes=(-2, -1))), axes=(-2, -1))
    return degridder_reference(pb.tparams, pb.tobs, sub.astype(np.complex64))


def test_gridded_pipeline_matches_jax():
    problem = _problem("tile")   # the interpret-mode JAX gridder is the slow side
    cx, cy = problem.coords
    got = _gridded_pipeline(problem)
    jsub = japi.run_gridder(problem.params, problem.obs, version="pallas_v6")
    _gate(got, _complex(jgrid.subgrids_to_grid(_pair(jsub), cx, cy, problem.params.grid_size)))


def test_gridded_pipeline_matches_f64(problem):
    got = _gridded_pipeline(problem)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    _gate(got, _f64_grid(problem))


def test_degrid_pipeline_matches_jax():
    problem = _problem("tile")   # the interpret-mode JAX degridder is the slow side
    cx, cy = problem.coords
    jsub = jgrid.grid_to_subgrids(problem.grid_pair, cx, cy, problem.params.subgrid_size)
    want = japi.run_degridder(problem.params, problem.obs, _complex(jsub), version="pallas_v7")
    _gate(_degrid_pipeline(problem), want)


def test_degrid_pipeline_matches_f64(problem):
    got = _degrid_pipeline(problem)
    assert got.shape == (problem.oyx.shape[0], problem.params.nr_timesteps_subgrid,
                         problem.params.nr_channels, 4)
    _gate(got, _f64_vis(problem))


# (h) the range dispatch: sparse and tile-path plans to K4 --------------------------

def test_sparse_plan_runs_on_the_range_grid_add(monkeypatch):
    """The JAX package routes the sparse plan (nbp > 2·S) through masked
    pieces and its piece kernel and the tile-path plan through its tile
    kernel (grid.py:1955-2011); the port takes K4 for both (the one
    expected difference, `test_torch_grid_add.JAX_ROUTE_DIFFERENCES`),
    from uv subgrids and from the fused gridder's pieces (the pipeline),
    and matches JAX's grid on each. On CPU tensors each wrapper runs its
    plain version, which the spies below count."""
    import idg_tpu_torch.ops.cuda.grid as kgrid

    calls = []
    for name in ("grid_add_plain", "grid_add_pieces_plain"):
        def spy(*args, _real=getattr(kgrid, name), _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(kgrid, name, spy)
    kernels.reset_launch_counts()
    for case, route, kernel in (("sparse", "tile", "grid_add_plain"),
                                ("tile", "tile", "grid_add_plain")):
        problem = _problem(case)
        g, n = problem.params.grid_size, problem.params.subgrid_size
        cx, cy = problem.coords
        plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
        assert (plan.nbp > 2 * len(cx)) == (case == "sparse")
        assert tgrid.ranges_route(plan) == route
        sub = _port_subgrids(problem)
        calls.clear()
        got = tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, plan=plan)
        assert calls == [kernel]
        _gate(got, _complex(jgrid.subgrids_to_grid(_pair(sub), cx, cy, g)))
        want = jgrid.subgrids_to_grid_ranges(_pair(sub), cx, cy, g, apply_fft=True,
                                             interpret=True)
        _gate(got, _complex(want))
        calls.clear()
        _gate(_gridded_pipeline(problem), _complex(want))
        assert calls == [kernel]
    assert kernels.grid_add_cuda.launches == kernels.grid_add_pieces_cuda.launches == 0


# wrappers and helpers ----------------------------------------------------------

def test_grid_pair_round_trip(problem):
    grid = grid_from_pair(problem.grid_pair)
    assert grid.dtype == torch.complex64 and grid.shape == problem.grid_pair[0].shape
    for a, b in zip(grid_to_pair(grid), problem.grid_pair):
        np.testing.assert_array_equal(a, b)


def test_dft_factors_equal_jax():
    for n in (16, 32):
        for inverse in (False, True):
            re, im = jgrid._dft_shift_factors(n, inverse)
            w = tgrid.dft_shift_factors(n, inverse)
            np.testing.assert_array_equal(w.real, re)
            np.testing.assert_array_equal(w.imag, im)


@pytest.mark.parametrize("bad", ["dtype", "oyx_shape", "grid_size", "plan", "coords"])
def test_grid_wrappers_reject_bad_input(bad, problem):
    g, n = problem.params.grid_size, problem.params.subgrid_size
    cx, cy = problem.coords
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    pieces = torch.zeros((len(cx), 4, n, n), dtype=torch.complex64)
    oyx = torch.from_numpy(problem.oyx)
    grid = torch.zeros((4, g, g), dtype=torch.complex64)
    coord = torch.from_numpy(cx.astype(np.int32))
    with pytest.raises(ValueError):
        if bad == "dtype":
            kernels.grid_add_cuda(pieces.to(torch.complex128), oyx, plan, g)
        elif bad == "oyx_shape":
            kernels.grid_add_cuda(pieces, oyx[:-1], plan, g)
        elif bad == "grid_size":
            kernels.grid_add_cuda(pieces, oyx, plan, g + n)
        elif bad == "plan":
            kernels.grid_add_cuda(pieces[:-1], oyx[:-1], plan, g)
        else:
            kernels.grid_extract_cuda(grid, coord.to(torch.int64), coord, n)


def test_cpu_tensors_leave_grid_stage_counters_at_zero(problem):
    kernels.reset_launch_counts()
    _gridded_pipeline(problem)
    _degrid_pipeline(problem)
    assert all(k.launches == 0 for k in kernels.KERNELS)
    assert kernels.degridder_cuda_v7.fused_launches == 0


def test_grid_costs_equal_jax():
    from idg_tpu.utils.costs import grid_costs as jcosts
    from idg_tpu_torch.utils.costs import grid_costs as tcosts

    params = CASES["tile"]
    assert tcosts(tcfg.IDGParams(**dataclasses.asdict(params))) == jcosts(params)
    assert tcosts(tcfg.IDGParams()) == jcosts(IDGParams())
