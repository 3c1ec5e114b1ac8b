"""Roofline of a kernel on the card: the one source of the peaks and the
bound that `run`'s perf report (`roofline_pct`) and chip_smoke.py's kernel
table use.

The counterpart of ``idg_tpu/utils/roofline.py``, with the published peaks
of an NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit) per
unit: the FP32 CUDA cores and the bf16 and TF32 tensor cores. A kernel's bound is the
least time the card could take for its work: the larger of its bytes over
the memory rate and its operations over the rate of the unit that does them.
A card below its power limit runs slower under load, so a share of the
bound is quoted beside the card's power limit. Unknown devices omit the
row, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12}

# device-name substrings of the H100 SXM (torch.cuda.get_device_name)
H100_SXM_NAMES = ("H100 80GB HBM3", "H100 SXM")

# the rungs whose products run on the bf16 tensor cores, and those on the
# TF32 tensor cores (K1 and K2, and each at rank 1; the direct rungs K8a and
# K9a); every other rung runs on the FP32 CUDA cores
TENSOR_CORE_VERSIONS = frozenset({
    ("gridder", "cuda_v4"), ("gridder", "cuda_v5"),
    ("degridder", "cuda_v4"), ("degridder", "cuda_v5"), ("degridder", "cuda_v6"),
})
TF32_VERSIONS = frozenset({
    ("gridder", "cuda_v1"), ("gridder", "cuda_v2"),
    ("gridder", "cuda_v6"), ("gridder", "cuda_v7"),
    ("degridder", "cuda_v1"), ("degridder", "cuda_v2"),
    ("degridder", "cuda_v7"), ("degridder", "cuda_v8"),
})


def unit(workload: str, version: str) -> str:
    """The unit a rung's products run on: "bf16", "tf32" or "fp32"."""
    if (workload, version) in TENSOR_CORE_VERSIONS:
        return "bf16"
    return "tf32" if (workload, version) in TF32_VERSIONS else "fp32"


def bound_seconds(flops: float, nbytes: float, unit_name: str = "fp32"):
    """(seconds, "bytes" or "operations"): the least time for `flops`
    operations on `unit_name` and `nbytes` moved to or from device memory."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    flops_s = flops / PEAK_FLOP_PER_S[unit_name]
    return max(bytes_s, flops_s), ("bytes" if bytes_s >= flops_s else "operations")


def roofline_fraction(gflops_achieved: float, gflops_total: float, gbytes_total: float,
                      device_name: str, workload: str, version: str) -> Optional[float]:
    """Achieved FLOP/s over the roofline bound at this kernel's intensity
    (min(peak, intensity · bandwidth), the JAX package's formula) on the
    unit the rung runs on; None on an unknown device or without costs."""
    known = any(key in device_name for key in H100_SXM_NAMES)
    if not known or gbytes_total <= 0 or gflops_total <= 0:
        return None
    peak = PEAK_FLOP_PER_S[unit(workload, version)]
    bound = min(peak, gflops_total / gbytes_total * HBM_BYTES_PER_S)
    return gflops_achieved * 1e9 / bound
