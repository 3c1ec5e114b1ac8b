"""Counts of the sharded pass for the readers metrics/mesh_*.py: each
rank's share of the pass's work, and the bytes an all-reduce of the grid
must move, at a fixed NVLink peak.

The ranks and each one's share come from the rows rank 0 holds (its
metadata): the recipe grid_mesh splits the subgrids into blocks of
ceil(S / ranks).
"""

from __future__ import annotations

import math

from benchmark import costs

# Published NVIDIA H100 SXM figure: NVLink 4, 900 GB/s a card in both
# directions together, so 450 GB/s each way.
NVLINK_BYTES_PER_S = 450e9


def rank0_rows(ctx) -> int:
    return len(ctx.metadata["coord_x"])


def ranks(ctx) -> int:
    """The world's size: S over rank 0's rows, rounded up."""
    return math.ceil(ctx.problem.nr_subgrids / rank0_rows(ctx))


def rank0_gridder_work(ctx) -> costs.Work:
    """costs.gridder_work of the configuration in the share of its
    subgrids that rank 0 grids (a quarter of four even shares)."""
    whole = costs.gridder_work(ctx.problem)
    share = rank0_rows(ctx) / ctx.problem.nr_subgrids
    return costs.Work(round(whole.flops * share), round(whole.bytes * share))


def all_reduce_bytes(problem, n: int) -> float:
    """The least that any all-reduce algorithm of n ranks must send out of
    each rank, and receive into it, for the c64[P, G, G] grid: (n − 1)/n of
    the grid each way."""
    grid = problem.nr_correlations * problem.grid_size ** 2 * costs.COMPLEX_BYTES
    return (n - 1) / n * grid
