"""Degridder `cuda_v3` / `cuda_v4` / `cuda_v5`: the separable-phasor kernels
K9b (cuda_v3: csrc/degridder_sep_fp32.cu, cuda_v4: csrc/degridder_sep_bf16.cu)
and K9c (cuda_v5: the recurrence instance of cuda_v4's kernel in
csrc/degridder_sep_bf16.cu), entered through csrc/degridder_separable.cu,
and their plain PyTorch version.

The adjoint of ops/cuda/gridder_separable.py (the math of
idg_tpu/ops/pallas/degridder.py:_kernel_separable):
  B[y, (p,x)] = A1 · (sph·P) · A2ᴴ                                   (prologue)
  D_r[v, (p,x)] = Σ_y conj(Φy[v,y]) · (n^r ⊙ B)[y, (p,x)]           (stage 1, the product)
  vis[v,p] = Σ_r conj((iμ_v)^r / r!) · Σ_x D_r[v,(p,x)] · conj(Φx[v,x])  (stage 2)
Stage 1 runs in the rung's precision mode (ops/precision.py); stage 2 in
float32. The rungs are those of the gridder: cuda_v3 float32 FFMA, cuda_v4
the split bf16 policy on the tensor cores (`wgmma`, producer warps),
cuda_v5 the same kernel with Φ by the channel recurrence in its producers
(uniform channel spacing assumed; the guard falls back to cuda_v4). All
write [S, T, C, P]: v5's c-major order is a loop order.

Each wrapper dispatches on the staging's device: a CPU staging runs the
plain version, a CUDA staging launches the kernel (or raises).
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged, n_powers
from ..precision import dot_mixed, rank_mode
from ..registry import register
from . import build
from .degridder import prepare_degridder
from .gridder import (
    DEFAULT_W_RANK,
    PLAIN_CHUNK,
    _check_staged,
    _check_tensor,
    check_staging,
    full_fp32_matmuls,
    ptr,
    taylor_coefficients,
)
from .gridder_separable import VARIANTS, plain_precisions, separable_phasors


def degridder_separable_plain(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                              w_rank: int, precisions, recurrence: bool):
    """The kernels' function in torch ops, chunked over subgrids: the
    prologue, then per rank the packed stage-1 product
    [B_re | B_im]ᵀ [2NP, N] × [Φy_re | Φy_im] [N, 2V] in the rank's mode
    (degridder.py:279-285), the float32 Φx* contraction and the conjugate
    Taylor coefficient. Returns c64[S, T, C, P]."""
    full_fp32_matmuls(stg.device)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    NP = N * P
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=stg.device)
    npack = [p.repeat(1, P) for p in n_powers(stg.n, w_rank)]       # [N(y), (p,x)]
    for lo in range(0, S, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, S)
        s = hi - lo
        b = prepare_degridder(stg, lo, hi, subgrids[lo:hi]).transpose(2, 3).reshape(s, N, NP)
        phx, phy, mu = separable_phasors(stg, lo, hi, recurrence)
        V = mu.shape[1]
        phy2 = torch.cat([phy.real, phy.imag], dim=1).transpose(1, 2)   # [s, N(y), 2V]
        vis = 0
        for r, coef in enumerate(taylor_coefficients(mu, w_rank)):
            br = b * npack[r]
            b2t = torch.cat([br.real, br.imag], dim=2).transpose(1, 2)  # [s, 2NP, N(y)]
            prod = dot_mixed(b2t, phy2, rank_mode(precisions, r))       # [s, 2NP, 2V]
            d = torch.complex(prod[:, :NP, :V] + prod[:, NP:, V:],
                              prod[:, NP:, :V] - prod[:, :NP, V:])
            d = d.reshape(s, P, N, V)
            vr = (d * phx.transpose(1, 2).conj()[:, None]).sum(dim=2)    # [s, P, V]
            vis = vis + vr * coef.conj()[:, None, :]
        vis = vis.transpose(1, 2)                                        # [s, V, P]
        if recurrence:
            out[lo:hi] = vis.reshape(s, C, T, P).transpose(1, 2)
        else:
            out[lo:hi] = vis.reshape(s, T, C, P)
    return out


def _degridder_separable(wrapper, version: str, params: IDGParams, stg: Staged,
                         subgrids: torch.Tensor, w_rank: int):
    """Dispatch of the three wrappers: the plain version on a CPU staging,
    K9b / K9c on a CUDA staging, counted on `wrapper.launches`."""
    name = wrapper.__name__
    _check_staged(params, stg, w_rank)
    device = stg.device
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    _check_tensor("subgrids", subgrids, torch.complex64, (S, P, N, N), device)
    variant = VARIANTS[version]
    if device.type == "cpu":
        return degridder_separable_plain(params, stg, subgrids, w_rank,
                                         plain_precisions(version, w_rank),
                                         variant == VARIANTS["cuda_v5"])
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=False)
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_degridder_separable(
            ptr(stg.uvw), ptr(stg.mu), ptr(stg.wavenumbers), ptr(stg.po_x),
            ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n), ptr(stg.sph),
            ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(subgrids), ptr(out),
            S, T, C, N, stg.aterms.shape[1], w_rank, variant,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, name)
    wrapper.launches += 1
    return out


@register(
    "degridder", "cuda_v3",
    "CUDA C++ separable phasor: per rank one packed Φy*·B product (FP32 FFMA, "
    "register-tiled, two ranks a pass) + FP32 Φx* contraction; counterpart of pallas_v3",
    family="cuda",
)
def degridder_cuda_v3(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                      w_rank: int = DEFAULT_W_RANK):
    """Separable degridder, float32 products (plain version on the CPU, K9b
    on a card). Returns c64[S, T, C, P]; `degridder_cuda_v3.launches` counts
    launches."""
    return _degridder_separable(degridder_cuda_v3, "cuda_v3", params, stg, subgrids, w_rank)


@register(
    "degridder", "cuda_v4",
    "v3 with stage 1 on the tensor cores: bf16 wgmma with producer warps, "
    "rank-0 bf16_3x, rank-1 single-pass bf16; counterpart of pallas_v4",
    family="cuda",
)
def degridder_cuda_v4(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                      w_rank: int = DEFAULT_W_RANK):
    """Separable degridder, split bf16 stage-1 products on the tensor cores
    (plain version on the CPU, K9b on a card). `degridder_cuda_v4.launches`
    counts launches."""
    return _degridder_separable(degridder_cuda_v4, "cuda_v4", params, stg, subgrids, w_rank)


@register(
    "degridder", "cuda_v5",
    "v4's bf16 wgmma kernel with the channel-recurrence phasors in its producer "
    "warps (exact resync every 16 channels), c-major; counterpart of pallas_v5",
    family="cuda", uniform_channels=True, fallback="cuda_v4",
)
def degridder_cuda_v5(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                      w_rank: int = DEFAULT_W_RANK):
    """`degridder_cuda_v4` with Φ by the channel recurrence (K9c; uniform
    channel spacing assumed, the API guard falls back to cuda_v4
    otherwise). `degridder_cuda_v5.launches` counts launches."""
    return _degridder_separable(degridder_cuda_v5, "cuda_v5", params, stg, subgrids, w_rank)


degridder_cuda_v3.launches = 0
degridder_cuda_v4.launches = 0
degridder_cuda_v5.launches = 0
