"""Hand-written CUDA kernels (sources in ``idg_tpu_torch/csrc``), the
counterpart of ``idg_tpu/ops/pallas`` and of the Pallas kernels of
``idg_tpu/ops/grid.py``. Importing registers them; nothing is built until a
kernel is first launched on a CUDA tensor."""

from . import degridder, gridder  # noqa: F401  (registers kernels)
from .degridder import degridder_cuda_v7, degridder_plain
from .grid import (grid_add_cuda, grid_add_merged_cuda, grid_add_merged_plain,
                   grid_add_pieces_cuda, grid_add_pieces_plain, grid_add_plain,
                   grid_add_scatter_cuda, grid_add_scatter_plain, grid_add_slots_cuda,
                   grid_add_slots_plain, grid_extract_cuda, grid_extract_plain)
from .gridder import gridder_cuda_v6, gridder_cuda_v6_pieces, gridder_plain, gridder_v6_pieces_plain

KERNELS = (gridder_cuda_v6, gridder_cuda_v6_pieces, degridder_cuda_v7, grid_add_cuda,
           grid_extract_cuda, grid_add_pieces_cuda, grid_add_merged_cuda,
           grid_add_scatter_cuda, grid_add_slots_cuda)


def reset_launch_counts() -> None:
    for wrapper in KERNELS:
        wrapper.launches = 0
    degridder_cuda_v7.fused_launches = 0
