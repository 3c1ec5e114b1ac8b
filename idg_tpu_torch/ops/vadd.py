"""vadd: the memory-bandwidth smoke benchmark, K10 (csrc/vadd.cu) and its
plain version.

The counterpart of ``idg_tpu/ops/vadd.py``: z = x + y over n floats, 3·4·n
bytes moved. `vadd_cuda` dispatches on its inputs' device: the plain
version for CPU tensors, the kernel for CUDA tensors (or raise).
"""

from __future__ import annotations

import torch

DEFAULT_N = 256 * 1024 * 1024  # 1 GiB per operand, the V100 CSVs' scale


def make_vadd_inputs(n: int = DEFAULT_N, device=None):
    """x = arange(n)·1e-6 and y = ones(n), f32, on `device`."""
    x = torch.arange(n, dtype=torch.float32, device=device) * 1e-6
    y = torch.ones(n, dtype=torch.float32, device=device)
    return x, y


def vadd_gbytes(n: int) -> float:
    """3 streams (2 read + 1 write) of f32."""
    return 3 * 4 * n * 1e-9


def vadd_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def vadd_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """z = x + y: the plain version for CPU tensors, K10 for CUDA tensors.
    `vadd_cuda.launches` counts kernel launches."""
    # imported here: ops/cuda imports this module to list vadd_cuda in KERNELS
    from .cuda import build
    from .cuda.gridder import _check_tensor, ptr

    device = x.device
    if x.dim() != 1:
        raise ValueError(f"vadd takes 1-D tensors, got shape {tuple(x.shape)}")
    for name, t in (("x", x), ("y", y)):
        _check_tensor(name, t, torch.float32, x.shape, device)
    if device.type == "cpu":
        return vadd_plain(x, y)
    if device.type != "cuda":
        raise ValueError(f"vadd_cuda runs on cpu or cuda, not {device}")
    z = torch.empty_like(x)
    if x.numel() == 0:
        return z
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_vadd(ptr(x), ptr(y), ptr(z), x.numel(),
                          torch.cuda.current_stream(device).cuda_stream)
    build.check(rc, "vadd_cuda")
    vadd_cuda.launches += 1
    return z


vadd_cuda.launches = 0
