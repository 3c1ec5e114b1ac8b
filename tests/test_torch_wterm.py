"""The non-coplanar gridding pass (benchmark/recipes/grid_wterm.py, the cell
default.grid-wterm) on the CPU: its inputs against the grid recipe's, the
guard's Taylor rank at the cell's full sizes, the port's normal path
against the float64 reference where w needs rank 4 and 5, a planted
w = 0 fault, the port's w-term tallies (utils/trace.py), and K1's TF32
passes a Taylor rank (ops/precision.py:gridder_three_pass_ranks): the
rule, its error budget, and its products emulated against float64."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import catalog, compare, inputs, passes
from idg_tpu_torch.ops.api import (W_TAYLOR_TOL, _rank_for_bound, _resolve, max_mu_n,
                                   required_w_rank)
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.ops.cuda.gridder import axis_phasors
from idg_tpu_torch.ops.precision import (TF32_PASS_ERROR, dot_mixed,
                                         gridder_three_pass_ranks, round_tf32, tf32_passes)
from idg_tpu_torch.types import Metadata, Observation
from idg_tpu_torch.utils import trace

CELL = catalog.load_cell("default.grid-wterm")
RECIPE = catalog.load_recipe("grid_wterm")
GRID = catalog.load_recipe("grid")
# the cell's shapes on a small grid: 6 baselines × 2 timeslots = 12 subgrids
SMALL = dataclasses.replace(CELL.problem, grid_size=256, nr_stations=4, nr_timeslots=2,
                            nr_timesteps_subgrid=16, nr_channels=4)
SEED = 2**33 + 26


def _traffic(declination_deg):
    return dict(CELL.traffic, declination_deg=declination_deg)


def _observation(inp) -> Observation:
    return Observation(uvw=inp.uvw, wavenumbers=inp.wavenumbers,
                       visibilities=inp.visibilities, spheroidal=inp.spheroidal,
                       aterms=inp.aterms, metadata=Metadata(**inp.metadata))


def test_w_follows_the_declination_and_nothing_else_moves():
    """w = −v·cot δ on every track (δ = −27°: w ≈ 1.963·v), and every other
    input the grid recipe's on the same seed, bit for bit."""
    got = RECIPE.make_inputs(SMALL, CELL.traffic, SEED, "cpu")
    base = GRID.make_inputs(SMALL, catalog.load_cell("default.grid").traffic, SEED, "cpu")
    assert CELL.traffic["declination_deg"] == -27.0
    cot = 1.0 / np.tan(np.radians(-27.0))
    want_w = (-base.uvw[..., 1].astype(np.float64) * cot).astype(np.float32)
    np.testing.assert_array_equal(got.uvw[..., 2], want_w)
    assert np.all(base.uvw[..., 2] == 0) and np.abs(got.uvw[..., 2]).max() > 100
    np.testing.assert_array_equal(got.uvw[..., :2], base.uvw[..., :2])
    for name in ("wavenumbers", "spheroidal"):
        np.testing.assert_array_equal(getattr(got, name), getattr(base, name))
    assert got.metadata.keys() == base.metadata.keys()
    for key in base.metadata:
        np.testing.assert_array_equal(got.metadata[key], base.metadata[key])
    assert not np.any(got.metadata["coord_z"])
    assert torch.equal(got.aterms, base.aterms)
    assert torch.equal(got.visibilities, base.visibilities)


def test_the_mix_must_state_the_configurations_w_step():
    with pytest.raises(ValueError, match="w_step"):
        RECIPE.make_inputs(SMALL, dict(CELL.traffic, w_step=0.5), SEED, "cpu")


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 126])
def test_the_guard_resolves_rank_5_at_the_cells_sizes(seed):
    """At the cell's full sizes, from the host inputs alone (no
    visibilities): |μ·n| ≈ 0.169, so rank 5 (0.169⁵/5! ≈ 1.2e-6 < 3e-6,
    where rank 4's 3.4e-5 is not)."""
    p = CELL.problem
    inp, _ = inputs.observation(p, seed, "cpu")
    inp.uvw[..., 2] = RECIPE.w_tracks(inp.uvw, CELL.traffic["declination_deg"])
    obs, params = _observation(inp), passes.params(p)
    assert 0.165 < max_mu_n(params, obs) < 0.172
    assert required_w_rank(params, obs) == 5
    assert _resolve("gridder", "cuda_v6", params, obs) == ("cuda_v6", 5)


# (δ, the guard's rank on SMALL): |μ·n| ≈ 0.039 at −27°, ≈ 0.16 at −7°
RANKS = [(-27.0, 4), (-7.0, 5)]
# K1's TF32 passes a tile there (gridder_three_pass_ranks): rank 4 at 0.039
# takes ranks 2 and 3 in one pass, rank 5 at 0.16 ranks 3 and 4
PASSES = {4: 8, 5: 11}


@pytest.mark.parametrize("declination_deg, rank", RANKS)
def test_normal_path_matches_the_reference_at_escalated_ranks(declination_deg, rank):
    """The recipe's build on the CPU (the guard, the staging, the plain K1
    with its fused iDFT, the range grid-add) against its expected grid, the
    float64 reference, within the cell's limits; and the port's tallies
    after that pass: one gridder call at the resolved rank and the guard's
    |μ·n| bound, both gone after reset()."""
    trace.reset()
    inp = RECIPE.make_inputs(SMALL, _traffic(declination_deg), SEED, "cpu")
    pass_obj = RECIPE.build(SMALL, inp, "cpu")
    obs = _observation(inp)
    assert required_w_rank(passes.params(SMALL), obs) == rank
    got = compare.numbers(pass_obj(), RECIPE.expected(SMALL, inp))
    assert compare.judge(got, CELL.limits), got
    tally = trace.snapshot()["w_term"]
    assert tally["idg.w_rank.gridder"] == {rank: 1}
    assert tally["idg.w_passes.gridder"] == {PASSES[rank]: 1}
    assert tally["idg.w_mu_n.gridder"] == pytest.approx(max_mu_n(passes.params(SMALL), obs))
    trace.reset()
    assert "w_term" not in trace.snapshot()


@pytest.mark.parametrize("declination_deg, rank", RANKS)
def test_program_without_w_reads_outside_both_limits(declination_deg, rank):
    """A planted fault: the program grids the tracks with w = 0 while the
    reference keeps w; both numbers read far outside their limits."""
    inp = RECIPE.make_inputs(SMALL, _traffic(declination_deg), SEED, "cpu")
    flat = dataclasses.replace(inp, uvw=inp.uvw.copy())
    flat.uvw[..., 2] = 0.0
    got = compare.numbers(RECIPE.build(SMALL, flat, "cpu")(), RECIPE.expected(SMALL, inp))
    for name in compare.NAMES:
        assert got[name] > 10 * CELL.limits[name], (rank, got)


def test_tallies_count_each_call_by_rank():
    """count_rank adds one launch to its rank (or pass count), keep_bound
    keeps the newest bound; neither appears in a snapshot until one is
    kept."""
    tracer = trace.Tracer()
    assert "w_term" not in tracer.snapshot()
    for rank, passes_a_tile in ((5, 11), (5, 11), (2, 4)):
        tracer.count_rank("idg.w_rank.gridder", rank)
        tracer.count_rank("idg.w_passes.gridder", passes_a_tile)
    tracer.keep_bound("idg.w_mu_n.gridder", 0.2)
    tracer.keep_bound("idg.w_mu_n.gridder", 0.1689)
    assert tracer.snapshot()["w_term"] == {"idg.w_rank.gridder": {5: 2, 2: 1},
                                           "idg.w_passes.gridder": {11: 2, 4: 1},
                                           "idg.w_mu_n.gridder": 0.1689}
    tracer.reset()
    assert tracer.snapshot() == dict(spans={}, probes={})


@pytest.mark.parametrize("rank", [4, 5])
def test_each_kernel_call_tallies_its_passes(rank):
    """gridder_cuda_v6 and its fused form (their plain versions here) tally
    each call under idg.w_passes.gridder by the passes its staging's bound
    gives, and a staging with an unknown bound (inf) by three a rank."""
    from idg_tpu_torch.ops import cuda as kernels

    declination_deg = dict((r, d) for d, r in RANKS)[rank]
    inp = RECIPE.make_inputs(SMALL, _traffic(declination_deg), SEED, "cpu")
    params = passes.params(SMALL)
    stg = stage(params, _observation(inp), "cpu")
    assert stg.mu_n_bound == max_mu_n(params, _observation(inp))
    oyx = torch.zeros((stg.nr_subgrids, 2), dtype=torch.int32)
    trace.reset()
    kernels.gridder_cuda_v6(params, stg, rank)
    kernels.gridder_cuda_v6_pieces(params, stg, oyx, rank)
    kernels.gridder_cuda_v6(params, dataclasses.replace(stg, mu_n_bound=math.inf), rank)
    tally = trace.snapshot()["w_term"]
    trace.reset()
    assert tally["idg.w_passes.gridder"] == {PASSES[rank]: 2, 3 * rank: 1}
    assert tally["idg.w_rank.gridder"] == {rank: 3}


# (bound, w_rank, three-pass ranks, passes a tile): at rank ≤ 2 rank 0
# alone whatever the bound; above it the cell's 0.1689 at rank 5 ({0, 1, 2}
# three passes, {3, 4} one), δ −45° (0.0861) and δ −60° (0.0497) at rank 4,
# a zero and an unknown bound
RULE = [
    *((bound, w_rank, 1, {1: 3, 2: 4}[w_rank]) for w_rank in (1, 2)
      for bound in (0.0, 1e-3, 0.1)),
    (0.1689, 5, 3, 11),
    (0.0861, 4, 3, 10),
    (0.0497, 4, 2, 8),
    (0.0, 5, 1, 7),
    (math.inf, 5, 5, 15),
]


@pytest.mark.parametrize("bound, w_rank, three_ranks, passes_a_tile", RULE)
def test_three_pass_rule(bound, w_rank, three_ranks, passes_a_tile):
    assert gridder_three_pass_ranks(bound, w_rank) == three_ranks
    assert tf32_passes(three_ranks, w_rank) == passes_a_tile


@pytest.mark.parametrize("bound", np.geomspace(1e-6, 0.359, 24).tolist())
def test_one_pass_ranks_fit_the_guards_tolerance(bound):
    """At the rank the guard returns for `bound`, the ranks in one pass
    err by Σ bound^r / r! · 2^-10 < W_TAYLOR_TOL of the signal; rank 0
    takes three; above rank 2 one more rank in one pass would not fit."""
    w_rank = _rank_for_bound(bound)
    three = gridder_three_pass_ranks(bound, w_rank)
    err = [bound ** r / math.factorial(r) * TF32_PASS_ERROR for r in range(w_rank)]
    assert 1 <= three <= w_rank
    assert sum(err[three:]) < W_TAYLOR_TOL
    if w_rank > 2 and three > 1:
        assert sum(err[three - 1:]) >= W_TAYLOR_TOL


def _emulated_k1(stg, w_rank: int, three_ranks: int | None) -> torch.Tensor:
    """K1's product Σ_r n^r · lhs_rᵀ · W over all of a CPU staging's
    visibilities, c128[S, N(y), N(x)·P]: lhs_r = Φy·(iμ)^r/r! and W = Φx·vis
    formed in float32 as the producers form them, each real product in
    "3xtf32" (r < three_ranks) or hi·hi alone on TF32-rounded operands
    (`round_tf32`); `three_ranks` None takes them all in float64."""
    phx, phy, mu = axis_phasors(stg, 0, stg.nr_subgrids)
    S, V, N = phx.shape
    vis = stg.vis.reshape(S, V, -1)
    w = (phx[..., None] * vis[:, :, None, :]).reshape(S, V, -1)
    n = stg.n
    if three_ranks is None:
        w, phy, mu, n = w.to(torch.complex128), phy.to(torch.complex128), mu.double(), n.double()
    coef = torch.ones_like(phy[..., 0])
    out = 0
    for r in range(w_rank):
        lhs = phy * coef[..., None]
        a_re, a_im = lhs.real.mT.contiguous(), lhs.imag.mT.contiguous()
        b_re, b_im = w.real.contiguous(), w.imag.contiguous()
        if three_ranks is None:
            def prod(x, y):
                return x @ y
        elif r < three_ranks:
            def prod(x, y):
                return dot_mixed(x, y, "3xtf32")
        else:
            def prod(x, y):
                return round_tf32(x) @ round_tf32(y)
        term = torch.complex(prod(a_re, b_re) - prod(a_im, b_im),
                             prod(a_re, b_im) + prod(a_im, b_re)).reshape(S, N, N, -1)
        out = out + (term * (n ** r)[None, :, :, None]).reshape(S, N, -1)
        coef = coef * 1j * (mu * (1.0 / (r + 1)))   # as the producers: by a reciprocal
    return out.to(torch.complex128)


@pytest.mark.parametrize("declination_deg, rank", RANKS)
def test_emulated_three_pass_rule_stays_inside_the_budget(declination_deg, rank):
    """The TF32 products emulated on the CPU (`_emulated_k1`) at the rank the
    guard returns on SMALL, under the rule and with every rank in three
    passes, against float64: the rule's extra error stays below
    W_TAYLOR_TOL and below its model, Σ over the one-pass ranks of
    bound^r / r! · 2^-10, and both read inside the cell's limits; every
    rank in one pass (rank 0 too) reads above W_TAYLOR_TOL."""
    inp = RECIPE.make_inputs(SMALL, _traffic(declination_deg), SEED, "cpu")
    stg = stage(passes.params(SMALL), _observation(inp), "cpu")
    bound = stg.mu_n_bound
    assert _rank_for_bound(bound) == rank
    three = gridder_three_pass_ranks(bound, rank)
    assert tf32_passes(three, rank) == PASSES[rank]
    want = _emulated_k1(stg, rank, None)
    rms = want.abs().square().mean().sqrt()

    def errors(three_ranks):
        diff = (_emulated_k1(stg, rank, three_ranks) - want).abs()
        return float(diff.square().mean().sqrt() / rms), float(diff.max() / rms)

    (rms_rule, max_rule), (rms_three, _) = errors(three), errors(rank)
    model = sum(bound ** r / math.factorial(r) * TF32_PASS_ERROR for r in range(three, rank))
    assert rms_rule - rms_three < min(model, W_TAYLOR_TOL), (rms_rule, rms_three, model)
    assert compare.judge(dict(rms_err=rms_rule, max_err=max_rule), CELL.limits)
    assert errors(0)[0] - rms_three > W_TAYLOR_TOL
