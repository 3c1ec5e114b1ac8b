"""Shared fixtures of the benchmark's own tests (CPU, tiny problems)."""

import dataclasses

import pytest

from benchmark import catalog

TINY = catalog.Problem(grid_size=128, subgrid_size=16, nr_stations=4, nr_timeslots=3,
                       nr_timesteps_subgrid=8, nr_channels=4, nr_correlations=4,
                       image_size=0.01, w_step=0.0)


def tiny_cell(workload: str, problem=TINY):
    """A cell of BENCHMARK.json with its sizes replaced by a tiny problem."""
    return dataclasses.replace(catalog.load_cell(workload), problem=problem)


@pytest.fixture
def quiet():
    return lambda line: None
