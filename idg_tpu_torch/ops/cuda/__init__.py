"""Hand-written CUDA kernels (sources in ``idg_tpu_torch/csrc``), the
counterpart of ``idg_tpu/ops/pallas``, of the Pallas kernels of
``idg_tpu/ops/grid.py`` and of ``idg_tpu/ops/vadd.py:vadd_pallas``. Importing
registers them; nothing is built until a kernel is first launched on a CUDA
tensor."""

from . import (degridder, degridder_direct, degridder_polstack,  # noqa: F401  (registers kernels)
               degridder_separable, gridder, gridder_direct, gridder_separable)
from ..vadd import vadd_cuda, vadd_plain
from .degridder import degridder_cuda_v7, degridder_plain
from .degridder_direct import degridder_cuda_v1, degridder_cuda_v2, degridder_direct_plain
from .degridder_polstack import degridder_cuda_v6, degridder_polstack_plain
from .degridder_separable import (degridder_cuda_v3, degridder_cuda_v4, degridder_cuda_v5,
                                  degridder_separable_plain)
from .grid import (grid_add_blocks_per_sm, grid_add_cuda, grid_add_merged_cuda,
                   grid_add_merged_plain, grid_add_pieces_cuda, grid_add_pieces_plain,
                   grid_add_plain, grid_add_scatter_cuda, grid_add_scatter_plain,
                   grid_add_slots_cuda, grid_add_slots_plain, grid_extract_cuda,
                   grid_extract_plain)
from .gridder import gridder_cuda_v6, gridder_cuda_v6_pieces, gridder_plain, gridder_v6_pieces_plain
from .gridder_direct import gridder_cuda_v1, gridder_cuda_v2, gridder_direct_plain
from .gridder_separable import (gridder_cuda_v3, gridder_cuda_v4, gridder_cuda_v5,
                                gridder_separable_plain)

KERNELS = (gridder_cuda_v6, gridder_cuda_v6_pieces, degridder_cuda_v7, grid_add_cuda,
           grid_extract_cuda, grid_add_pieces_cuda, grid_add_merged_cuda,
           grid_add_scatter_cuda, grid_add_slots_cuda, gridder_cuda_v1, gridder_cuda_v2,
           degridder_cuda_v1, degridder_cuda_v2, vadd_cuda, gridder_cuda_v3, gridder_cuda_v4,
           gridder_cuda_v5, degridder_cuda_v3, degridder_cuda_v4, degridder_cuda_v5,
           degridder_cuda_v6)


def reset_launch_counts() -> None:
    for wrapper in KERNELS:
        wrapper.launches = 0
    degridder_cuda_v7.fused_launches = 0
