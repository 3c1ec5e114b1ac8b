"""Analytic FLOP/byte cost models.

Verbatim formulas from the reference (app/common/common.cpp:100-159), as in
``idg_tpu/utils/costs.py``; every GFLOP/s and GB/s the port reports uses
these, so numbers are directly comparable with the reference's CSVs. The
reference reports degridder runs with the gridder cost model
(app/CUDA/util.cpp:309-444), and so does the port.
"""

from __future__ import annotations

from ..config import IDGParams

FLOAT_BYTES = 4


def flops_gridder(
    nr_channels: int,
    nr_timesteps: int,
    nr_subgrids: int,
    subgrid_size: int,
    nr_correlations: int,
) -> int:
    """app/common/common.cpp:100-120. nr_timesteps = TOTAL timesteps."""
    flops_per_visibility = 5 + 5 + nr_channels * 2 + nr_channels * nr_correlations * 8
    flops_per_subgrid = 6  # shift
    total = nr_timesteps * subgrid_size * subgrid_size * flops_per_visibility
    total += nr_subgrids * subgrid_size * subgrid_size * flops_per_subgrid
    return int(total)


def bytes_gridder(
    nr_channels: int,
    nr_timesteps: int,
    nr_subgrids: int,
    subgrid_size: int,
    nr_correlations: int,
) -> int:
    """app/common/common.cpp:122-159. nr_timesteps = TOTAL timesteps."""
    bytes_per_uvw = 3 * FLOAT_BYTES
    bytes_per_vis = nr_channels * nr_correlations * 2 * FLOAT_BYTES
    bytes_per_pix = 2 * nr_correlations * 2 * FLOAT_BYTES  # read + write
    bytes_per_aterm = 2 * nr_correlations * 2 * FLOAT_BYTES
    bytes_per_spheroidal = FLOAT_BYTES
    total = nr_timesteps * bytes_per_uvw
    total += nr_timesteps * bytes_per_vis
    total += nr_subgrids * subgrid_size * subgrid_size * bytes_per_pix
    total += nr_subgrids * subgrid_size * subgrid_size * bytes_per_aterm
    total += nr_subgrids * subgrid_size * subgrid_size * bytes_per_spheroidal
    return int(total)


def workload_costs(params: IDGParams):
    """(gflops, gbytes, mvis) for one kernel pass at these parameters,
    exactly as the reference's perf harness computes them (app/CUDA/util.cpp:196-202)."""
    gflops = 1e-9 * flops_gridder(
        params.nr_channels,
        params.total_nr_timesteps,
        params.nr_subgrids,
        params.subgrid_size,
        params.nr_correlations,
    )
    gbytes = 1e-9 * bytes_gridder(
        params.nr_channels,
        params.total_nr_timesteps,
        params.nr_subgrids,
        params.subgrid_size,
        params.nr_correlations,
    )
    mvis = 1e-6 * params.total_nr_timesteps * params.nr_channels
    return gflops, gbytes, mvis
