"""The non-coplanar gridding pass (benchmark/recipes/grid_wterm.py, the cell
default.grid-wterm) on the CPU: its inputs against the grid recipe's, the
guard's Taylor rank at the cell's full sizes, the port's normal path
against the float64 reference where w needs rank 4 and 5, a planted
w = 0 fault, and the port's w-term tallies (utils/trace.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import catalog, compare, inputs, passes
from idg_tpu_torch.ops.api import _resolve, max_mu_n, required_w_rank
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
    """count_rank adds one launch to its rank, keep_bound keeps the newest
    bound; neither appears in a snapshot until one is kept."""
    tracer = trace.Tracer()
    assert "w_term" not in tracer.snapshot()
    for rank in (5, 5, 2):
        tracer.count_rank("idg.w_rank.gridder", rank)
    tracer.keep_bound("idg.w_mu_n.gridder", 0.2)
    tracer.keep_bound("idg.w_mu_n.gridder", 0.1689)
    assert tracer.snapshot()["w_term"] == {"idg.w_rank.gridder": {5: 2, 2: 1},
                                           "idg.w_mu_n.gridder": 0.1689}
    tracer.reset()
    assert tracer.snapshot() == dict(spans={}, probes={})
