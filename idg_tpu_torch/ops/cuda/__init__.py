"""Hand-written CUDA kernels (sources in ``idg_tpu_torch/csrc``), the
counterpart of ``idg_tpu/ops/pallas``. Importing registers them; nothing is
built until a kernel is first launched on a CUDA tensor."""

from . import degridder, gridder  # noqa: F401  (registers kernels)
from .degridder import degridder_cuda_v7, degridder_plain
from .gridder import gridder_cuda_v6, gridder_plain

KERNELS = (gridder_cuda_v6, degridder_cuda_v7)


def reset_launch_counts() -> None:
    for wrapper in KERNELS:
        wrapper.launches = 0
