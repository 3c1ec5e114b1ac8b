"""Work counts and fixed peaks for the roofline shares.

The operation count is the reference's own model, frozen here
(ska-sdp-idg-bench app/common/common.cpp:100-120, as
``idg_tpu_torch/utils/costs.py:flops_gridder`` copies it): the reference
reports its degridder with the same model. The subgrid (i)DFT, 2·P·8·N³
operations a subgrid, is added to the span whose function includes it.

Bytes follow one rule: each input byte a span needs is read once and each
output byte written once, whatever the implementation re-reads. The peaks
are fixed, so that a change of a kernel's unit or a fusion of kernels
cannot move its own yardstick.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Published NVIDIA H100 SXM figures, dense: the bf16 tensor-core rate (the
# fastest unit any rung of the port uses, so no float32-accurate
# implementation can read above 100%) and the HBM3 bandwidth.
PEAK_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12

COMPLEX_BYTES = 8
FLOAT_BYTES = 4
METADATA_FIELDS = 8   # time_offset, nr_timesteps, aterm_index, station1, station2, x, y, z


def flops_gridder(nr_channels: int, nr_timesteps: int, nr_subgrids: int,
                  subgrid_size: int, nr_correlations: int) -> int:
    """app/common/common.cpp:100-120. nr_timesteps = TOTAL timesteps."""
    flops_per_visibility = 5 + 5 + nr_channels * 2 + nr_channels * nr_correlations * 8
    flops_per_subgrid = 6  # shift
    total = nr_timesteps * subgrid_size * subgrid_size * flops_per_visibility
    total += nr_subgrids * subgrid_size * subgrid_size * flops_per_subgrid
    return int(total)


def flops_dft(nr_subgrids: int, subgrid_size: int, nr_correlations: int) -> int:
    """The subgrid (i)DFT: two [N, N] x [N, N] complex products a pol."""
    return int(nr_subgrids * 2 * nr_correlations * 8 * subgrid_size ** 3)


@dataclasses.dataclass(frozen=True)
class Work:
    flops: int
    bytes: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def bound_seconds(self) -> float:
        """The least time the chip could take: the larger of operations over
        the peak rate and bytes over the peak bandwidth."""
        return max(self.flops / PEAK_FLOP_PER_S, self.bytes / PEAK_BYTES_PER_S)


def _pieces_bytes(p) -> int:
    return p.nr_subgrids * p.nr_correlations * p.subgrid_size ** 2 * COMPLEX_BYTES


def _observation_bytes(p) -> int:
    """uvw, aterms, spheroidal, wavenumbers and metadata: what the gridder
    and the degridder read besides visibilities and pixels."""
    n2 = p.subgrid_size ** 2
    return (p.nr_subgrids * p.nr_timesteps_subgrid * 3 * FLOAT_BYTES
            + p.nr_timeslots * p.nr_stations * n2 * p.nr_correlations * COMPLEX_BYTES
            + n2 * FLOAT_BYTES
            + p.nr_channels * FLOAT_BYTES
            + p.nr_subgrids * METADATA_FIELDS * FLOAT_BYTES)


def _visibility_bytes(p) -> int:
    return p.nr_visibilities * p.nr_correlations * COMPLEX_BYTES


def _kernel_flops(p) -> int:
    return (flops_gridder(p.nr_channels, p.nr_subgrids * p.nr_timesteps_subgrid,
                          p.nr_subgrids, p.subgrid_size, p.nr_correlations)
            + flops_dft(p.nr_subgrids, p.subgrid_size, p.nr_correlations))


def gridder_work(p) -> Work:
    """Visibilities, uvw, aterms, spheroidal, wavenumbers and metadata in,
    the image-domain pieces out; the gridder's operations and the iDFT."""
    return Work(_kernel_flops(p), _visibility_bytes(p) + _observation_bytes(p) + _pieces_bytes(p))


def degridder_work(p) -> Work:
    """Pieces, uvw, aterms, spheroidal, wavenumbers and metadata in,
    visibilities out; the degridder's operations (the gridder's model) and
    the DFT."""
    return Work(_kernel_flops(p), _pieces_bytes(p) + _observation_bytes(p) + _visibility_bytes(p))


def grid_add_work(p) -> Work:
    """Pieces in, the whole output grid out."""
    grid = p.nr_correlations * p.grid_size ** 2 * COMPLEX_BYTES
    return Work(0, _pieces_bytes(p) + grid)


def window_union_pixels(coord_x, coord_y, grid_size: int, subgrid_size: int) -> int:
    """The number of grid pixels inside the union of the subgrids' N x N
    windows at (coord_y, coord_x), wrapped periodically."""
    g, n = grid_size, subgrid_size
    cx = np.asarray(coord_x, np.int64) % g
    cy = np.asarray(coord_y, np.int64) % g
    mask = np.zeros((g, g), dtype=bool)
    i = np.arange(n)
    for lo in range(0, cx.shape[0], 4096):
        rows = (cy[lo:lo + 4096, None] + i) % g
        cols = (cx[lo:lo + 4096, None] + i) % g
        mask[rows[:, :, None], cols[:, None, :]] = True
    return int(mask.sum())


def grid_extract_work(p, union_pixels: int) -> Work:
    """The grid pixels inside the union of the subgrid windows in (all
    pols), the pieces out."""
    return Work(0, union_pixels * p.nr_correlations * COMPLEX_BYTES + _pieces_bytes(p))


def roofline_pct(work: Work, device_seconds: float) -> float:
    """The work's bound as a percentage of the device seconds it took."""
    return 100.0 * work.bound_seconds() / device_seconds


def flops_pct_of_peak(flops: int, device_seconds: float) -> float:
    """Operations over device seconds as a percentage of the peak rate."""
    return 100.0 * flops / device_seconds / PEAK_FLOP_PER_S
