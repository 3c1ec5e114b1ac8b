"""On a card, at a small size: a sound run is correct with its kernels, the
TF32 control fails the limits the kernels meet, and each planted fault is
not correct. Marked `cuda`; skips without a card."""

import pytest
import torch

from benchmark import control, harness
from benchmark.conftest import tiny_cell
from benchmark.catalog import Problem
from benchmark.test_bench_faults import FAULTS

SMALL = Problem(grid_size=512, subgrid_size=32, nr_stations=8, nr_timeslots=4,
                nr_timesteps_subgrid=64, nr_channels=16, nr_correlations=4,
                image_size=0.01, w_step=0.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["default.grid", "default.degrid"])
def test_kernels_correct_control_not(workload):
    _card()
    cell = tiny_cell(workload, SMALL)
    res = harness.run(workload, 2**35 + 1, 0.5, False, cell=cell, log=lambda line: None)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    for seed in (1, 2, 3):
        row = control.readings(cell, seed, "cuda")
        assert all(row["program"][k] < v / 3 for k, v in cell.limits.items())
        assert any(row["control"][k] > v for k, v in cell.limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["default.grid", "default.degrid"])
def test_planted_fault_on_the_card(workload, fault):
    _card()
    res = harness.run(workload, 2**35 + 2, 0.2, False, cell=tiny_cell(workload, SMALL),
                      hook=FAULTS[fault], log=lambda line: None)
    assert res["correct"] is False
