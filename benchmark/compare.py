"""The numbers that decide `correct`: a pass's output against the plain
reference's, over every element.

  rms_err  sqrt(mean |out − ref|²) / sqrt(mean |ref|²)
  max_err  max |out − ref| / sqrt(mean |ref|²)

Each recipe hands over the reference's output in the order in which the
program's output comes.
"""

from __future__ import annotations

import math

import torch

NAMES = ("rms_err", "max_err")
CHUNK = 1 << 24     # elements a step, so float64 temporaries stay small


def numbers(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """{name: value} of `out` (any complex dtype) against `ref`, same shape."""
    if out.shape != ref.shape:
        raise ValueError(f"output shape {tuple(out.shape)} != reference {tuple(ref.shape)}")
    a, b = out.reshape(-1), ref.reshape(-1)
    if a.device != b.device:
        a = a.to(b.device)
    err2 = ref2 = 0.0
    worst = 0.0
    for lo in range(0, b.numel(), CHUNK):
        d = a[lo:lo + CHUNK].to(torch.complex128) - b[lo:lo + CHUNK]
        ad = d.abs()
        err2 += float((ad * ad).sum())
        m = float(ad.max())
        worst = m if (m > worst or math.isnan(m)) else worst
        rb = b[lo:lo + CHUNK].abs()
        ref2 += float((rb * rb).sum())
    scale = math.sqrt(ref2 / b.numel())
    if scale == 0.0:
        raise ValueError("the reference output is all zero")
    return {"rms_err": math.sqrt(err2 / b.numel()) / scale, "max_err": worst / scale}


def judge(values: dict, limits: dict) -> bool:
    """True when every number is within its limit (a NaN is not)."""
    return all(values[k] <= limits[k] for k in NAMES)
