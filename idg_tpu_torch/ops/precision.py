"""Matrix-unit precision policies of the separable and pol-stacked rungs and
the split product they name, in torch ops.

The counterpart of ``idg_tpu/ops/pallas/gridder.py:_dot_mixed`` /
``gridder_precisions``, ``idg_tpu/ops/pallas/common.py:rank_precisions`` and
``idg_tpu/ops/pallas/degridder.py:degridder_precisions``. A mode names how a
float32 product is taken, with hi = bf16(x), lo = bf16(x − hi), both
rounded to nearest even:

  "highest"  float32 throughout
  "3x"       bf16_3x: lh·rh + (lh·rl + ll·rh), each product exact in
             float32; lo·lo is dropped
  "3x2k"     all four split products, lo·lo included, as two products over
             the doubled contraction axis: [lh | ll]·[rh; rl] + [lh | ll]·[rl; rh]
             (the first sums lh·rh + ll·rl, the second lh·rl + ll·rh)
  "default"  lh·rh, one bf16 pass (what the TPU runs for DEFAULT precision;
             JAX on the CPU takes float32 there instead)
  "3xtf32"   the gridder K1's product (csrc/gridder.cu, TF32 `wgmma`), with
             hi = tf32(x), lo = tf32(x − hi) instead: lh·rh + (lh·rl + ll·rh),
             each product exact in float32; lo·lo is dropped

JAX's "3x2" also recovers all four products, by stacking the splits on the
row axis; it is a TPU layout that no rung of the port runs and is not
ported. The bf16 tensor-core kernels take the same split with
``__float2bfloat16_rn`` and run each product into float32 accumulators:
cuda_v4, cuda_v5 and degridder cuda_v6 as bf16 ``wgmma``
(csrc/gridder_sep_bf16.cu, degridder_sep_bf16.cu, degridder_polstack.cu);
K1 and K2 split with ``tf32_rn`` (csrc/wgmma.cuh), the rounding of
`split_tf32`.
"""

from __future__ import annotations

import torch

MODES = ("highest", "3x", "3x2k", "default", "3xtf32")


def rank_precisions(w_rank: int) -> tuple:
    """Pass policy per Taylor rank: bf16_3x for the rank-0 signal and one
    bf16 pass for the rank-1 correction at the default rank 2 (bounded by
    |μ·n| < 2.5e-3 of the signal there); bf16_3x for every rank of a
    guard-escalated rank > 2, where the corrections reach ~0.3."""
    return ("3x", "default") if w_rank <= 2 else ("3x",) * w_rank


# the gridder's policy is the degridder's (idg_tpu/ops/pallas/gridder.py:100)
gridder_precisions = rank_precisions


def degridder_precisions(w_rank: int) -> tuple:
    """Pass policy of the pol-stacked degridder (cuda_v6, as JAX's pallas_v6,
    idg_tpu/ops/pallas/degridder.py:52-57): "3x2k" for the rank-0 signal,
    one bf16 pass for the rank-1 correction at rank ≤ 2, "3x2k" for every
    rank of a guard-escalated rank."""
    return ("3x2k", "default") if w_rank <= 2 else ("3x2k",) * w_rank


def rank_mode(precisions: tuple, r: int) -> str:
    """The mode of rank r: the policy's last entry covers the ranks past it."""
    return precisions[min(r, len(precisions) - 1)]


def split_bf16(x: torch.Tensor):
    """(hi, lo) of a float32 tensor as float32 values exactly representable
    in bf16: hi = bf16(x), lo = bf16(x − hi), round to nearest even."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as K1's `cvt.rna.tf32.f32` rounds: add half of the
    dropped unit to the float's bits, then clear the 13 dropped bits. Torch
    has no TF32 type on the CPU. Finite values below 2^128 only."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) of a float32 tensor as float32 values exactly representable
    in TF32: hi = tf32(x), lo = tf32(x − hi) (`round_tf32`), as K1 splits its
    operands; hi + lo = x to 2^-22 relative."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def dot_mixed(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b (float32, batched over leading axes) taken as `mode` says."""
    if mode == "highest":
        return a @ b
    if mode == "3xtf32":
        ah, al = split_tf32(a)
        bh, bl = split_tf32(b)
        return ah @ bh + (ah @ bl + al @ bh)
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    if mode == "default":
        return ah @ bh
    if mode == "3x":
        return ah @ bh + (ah @ bl + al @ bh)
    if mode == "3x2k":
        a2 = torch.cat([ah, al], dim=-1)
        return a2 @ torch.cat([bh, bl], dim=-2) + a2 @ torch.cat([bl, bh], dim=-2)
    raise ValueError(f"unknown precision mode {mode!r}; the port takes {MODES}")
