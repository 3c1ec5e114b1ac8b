"""idg_tpu_torch: the PyTorch/CUDA port of the IDG benchmark, for an NVIDIA
H100.

The counterpart of ``idg_tpu`` (JAX on a TPU), which stays the reference:
the same golden data, oracle, comparator and cost models, and hand-written
CUDA C++ kernels (``csrc/``) for the gridder and degridder. Imports torch and
numpy, never jax.
"""

from .config import HarnessConfig, IDGParams
from .data import make_observation, make_perf_observation, make_w_observation
from .types import Metadata, Observation, from_numpy_observation, to_device

__version__ = "0.1.0"

__all__ = [
    "HarnessConfig",
    "IDGParams",
    "Metadata",
    "Observation",
    "from_numpy_observation",
    "make_observation",
    "make_perf_observation",
    "make_w_observation",
    "to_device",
]
