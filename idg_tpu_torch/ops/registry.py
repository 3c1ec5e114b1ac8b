"""Kernel registry: (workload, version) → callable.

The counterpart of ``idg_tpu/ops/registry.py``: every kernel registers under
a workload ("gridder"/"degridder") and a version string ("cuda_v6", ...),
with a one-line description naming its JAX counterpart.

Kernel contract (the 13-arg launch ABI of app/CUDA/util.cpp:233-237), on a
staging from ``ops.common.stage`` that lives on the device the kernel runs on:
  gridder:   fn(params: IDGParams, stg: Staged, w_rank) -> c64[S, P, N, N]
  degridder: fn(params: IDGParams, stg: Staged, subgrids, w_rank) -> c64[S, T, C, P]
The JAX package stages inside jit; here staging is an explicit step, so the
perf harness stages once and times only the kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

_REGISTRY: Dict[Tuple[str, str], "KernelEntry"] = {}

WORKLOADS = ("gridder", "degridder")


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    workload: str
    version: str
    fn: Callable
    description: str
    family: str  # "cuda"
    # Channel-recurrence kernels advance the phasor by a single per-channel
    # delta and are only correct when the wavenumber spacing is uniform
    # (gridder_v8.cu:135-186). `uniform_channels` marks them; `fallback`
    # names the nearest registered rung with no such assumption.
    uniform_channels: bool = False
    fallback: str | None = None
    # Fixed built-in Taylor rank of w-free specializations; None for kernels
    # that take a w_rank argument.
    fixed_w_rank: int | None = None


def register(workload: str, version: str, description: str = "", family: str = "",
             uniform_channels: bool = False, fallback: str | None = None,
             fixed_w_rank: int | None = None):
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}")

    def deco(fn):
        key = (workload, version)
        if key in _REGISTRY:
            raise ValueError(f"duplicate kernel {key}")
        fam = family or version.split("_")[0]
        _REGISTRY[key] = KernelEntry(
            workload, version, fn, description, fam, uniform_channels,
            fallback, fixed_w_rank,
        )
        return fn

    return deco


def get_kernel(workload: str, version: str) -> KernelEntry:
    _ensure_loaded()
    key = (workload, version)
    if key not in _REGISTRY:
        avail = ", ".join(sorted(v for w, v in _REGISTRY if w == workload))
        raise KeyError(f"no kernel {key}; available {workload} versions: {avail}")
    return _REGISTRY[key]


def list_kernels(workload: str | None = None):
    _ensure_loaded()
    return sorted(
        (e for e in _REGISTRY.values() if workload is None or e.workload == workload),
        key=lambda e: (e.workload, e.family, e.version),
    )


def _ensure_loaded():
    """Registration is a side effect of importing the kernel modules."""
    from . import cuda  # noqa: F401
