"""Golden-model comparator.

Same metric and contract as the reference (tests/test_util.hpp:28-105) and
``idg_tpu/utils/compare.py``: squared diffs normalized by the max |real| /
|imag| magnitude of the compared array, averaged over nonzero golden
elements, PASS iff sqrt(r_error + i_error) <= 1e-5; elementwise diagnostics
printed for diffs > 1e-4, capped at 64 lines.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TOLERANCE = 1e-5
PRINT_THRESHOLD = 1e-4
MAX_PRINT_ERRORS = 64


@dataclasses.dataclass(frozen=True)
class CompareResult:
    passed: bool
    mean_error: float
    nnz: int

    def __bool__(self) -> bool:
        return self.passed


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def check_error(
    cmp,
    ref,
    tolerance: float = TOLERANCE,
    verbose: bool = True,
) -> CompareResult:
    """Compare `cmp` (device result) against `ref` (golden), reference metric.

    Argument order follows check_error(A=cmp, B=ref) at tests/test_util.hpp:28.
    Accepts numpy arrays or tensors on any device.
    """
    a = _host(cmp).ravel().astype(np.complex64)
    b = _host(ref).ravel().astype(np.complex64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")

    r_max = max(1.0, float(np.max(np.abs(a.real), initial=0.0)))
    i_max = max(1.0, float(np.max(np.abs(a.imag), initial=0.0)))

    nonzero = np.abs(b) > 0.0
    nnz = int(np.count_nonzero(nonzero))
    r_diff = (b.real.astype(np.float64) - a.real.astype(np.float64)) * nonzero
    i_diff = (b.imag.astype(np.float64) - a.imag.astype(np.float64)) * nonzero

    if verbose:
        bad = (np.abs(r_diff) > PRINT_THRESHOLD) | (np.abs(i_diff) > PRINT_THRESHOLD)
        for idx in np.flatnonzero(bad)[:MAX_PRINT_ERRORS]:
            print(
                f"{idx}: ({a[idx].real:f}, {a[idx].imag:f}) - "
                f"({b[idx].real:f}, {b[idx].imag:f}) = "
                f"({r_diff[idx]:f}, {i_diff[idx]:f})"
            )

    r_error = float(np.sum(r_diff * r_diff) / r_max) / max(1, nnz)
    i_error = float(np.sum(i_diff * i_diff) / i_max) / max(1, nnz)
    mean_error = float(np.sqrt(r_error + i_error))
    passed = mean_error <= tolerance

    if verbose:
        print(">>> Result PASSED" if passed else ">>> Result FAILED")
        print(f">>> Error: {mean_error:g}")
    return CompareResult(passed=passed, mean_error=mean_error, nnz=nnz)


def compare_subgrids(cpu_subgrids, device_subgrids, **kw) -> CompareResult:
    """tests/test_util.hpp:102-105 adapter."""
    return check_error(device_subgrids, cpu_subgrids, **kw)


def compare_visibilities(cpu_visibilities, device_visibilities, **kw) -> CompareResult:
    """tests/test_util.hpp:94-100 adapter."""
    return check_error(device_visibilities, cpu_visibilities, **kw)
