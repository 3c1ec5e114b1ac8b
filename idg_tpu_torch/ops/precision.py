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

K1 (gridder cuda_v6) picks its passes per Taylor rank by its own rule,
`gridder_three_pass_ranks`: "3xtf32" for rank 0, hi·hi alone for rank 1
at rank ≤ 2, and above rank 2 hi·hi alone for the highest ranks, the small
terms that the staged rows' |μ·n| bound keeps under the guard's tolerance,
"3xtf32" for the rest.
"""

from __future__ import annotations

import math

import torch

from .api import W_TAYLOR_TOL

MODES = ("highest", "3x", "3x2k", "default", "3xtf32")

# relative error of one TF32 pass, hi·hi: each operand rounded to 10
# explicit bits (`cvt.rna`, at most 2^-11 relative), so 2^-10 a product
TF32_PASS_ERROR = 2.0 ** -10


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


def gridder_three_pass_ranks(bound: float, w_rank: int, tol: float = W_TAYLOR_TOL) -> int:
    """K1's passes per Taylor rank: ranks r below the count returned take
    three TF32 passes ("3xtf32"), the others hi·hi alone. `bound` is an
    upper bound on |μ·n| over the staged rows (inf where none is known).

    At w_rank ≤ 2, whatever the bound: rank 0 three passes, rank 1 hi·hi
    (the guard keeps |μ·n| < 2.45e-3 there, so its error is at most
    2.45e-3 · 2^-10 = 2.4e-6 of the signal). Above rank 2, rank r's term is
    at most bound^r / r! of the signal and hi·hi alone is off by at most
    TF32_PASS_ERROR of it: ranks go to hi·hi alone from the highest down
    while their summed error, Σ bound^r / r! · 2^-10, stays below `tol`
    (the truncation the guard already accepts, ops/api.py:W_TAYLOR_TOL),
    and every rank below the first that does not fit takes three passes.
    Rank 0 always does. So the three-pass ranks are always the lowest ones,
    and K1 takes their count (csrc/gridder.cu:k1_three_passes). At
    |μ·n| = 0.1689 and rank 5 ranks 3 and 4 take one pass: 3, 11 passes a
    tile instead of 15.

    K1's policy alone: the bf16 rungs' `rank_precisions` and
    `degridder_precisions` mirror the JAX package, and K2 keeps its own
    (csrc/wgmma.cuh:three_passes)."""
    if w_rank <= 2:
        return 1
    spent = 0.0
    for r in range(w_rank - 1, 0, -1):
        spent += bound ** r / math.factorial(r) * TF32_PASS_ERROR
        if not spent < tol:
            return r + 1
    return 1


def tf32_passes(three_ranks: int, w_rank: int) -> int:
    """TF32 product passes a tile of K1 at `w_rank` when its first
    `three_ranks` ranks take three passes and the others one."""
    return w_rank + 2 * three_ranks


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
