"""Degridder `cuda_v6`: the pol-stacked x-first kernel K9d
(csrc/degridder_polstack.cu, split bf16 on `wgmma`) and its plain PyTorch
version.

The function of idg_tpu/ops/pallas/degridder.py:_kernel_polstack (pallas_v6):
  B_p[y, x] = A1 · (sph·P) · A2ᴴ                                        (prologue)
  D_r = lhs_r · rhs: lhs_r [4N, 2N] = pol-stacked [B_re·n^r | B_im·n^r],
        rhs [2N, 2V] = [[Φx_re, −Φx_im], [Φx_im, Φx_re]] (Φx as [x, v]),
        so D_r = [Re | Im] of B·conj(Φx)ᵀ per pol                       (the product)
  vis[v, p] = Σ_r conj((iμ_v)^r / r!) · Σ_y conj(Φy[v, y]) · D_r,p[y, v]  (stage 2)
The product runs in the rank's mode of ops/precision.py:degridder_precisions
("3x2k" for the signal), stage 2 in float32. Φx and Φy come from the channel
recurrence with its exact resync every 16 channels, c-major (v = c·T + t):
the rung assumes uniform channel spacing, and the guard falls back to
cuda_v4 otherwise.

The wrapper dispatches on the staging's device: a CPU staging runs the
plain version, a CUDA staging launches the kernel (or raises).
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged, n_powers
from ..precision import degridder_precisions, dot_mixed, rank_mode
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
from .gridder_direct import wavenumbers_and_step
from .gridder_separable import separable_phasors


def degridder_polstack_plain(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                             w_rank: int):
    """The kernel's function in torch ops, chunked over subgrids: the
    prologue, the recurrence's Φ planes, then per rank the pol-stacked
    product lhs_r · rhs in the rank's mode of degridder_precisions(w_rank)
    and the float32 Φy* reduction, times the conjugate Taylor coefficient.
    Returns c64[S, T, C, P]."""
    full_fp32_matmuls(stg.device)
    precisions = degridder_precisions(w_rank)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    V = T * C
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=stg.device)
    powers = n_powers(stg.n, w_rank)                                   # [N(y), N(x)]
    for lo in range(0, S, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, S)
        s = hi - lo
        b = prepare_degridder(stg, lo, hi, subgrids[lo:hi]).permute(0, 3, 1, 2)  # [s,P,y,x]
        phx, phy, mu = separable_phasors(stg, lo, hi, True)             # [s, V, N], μ [s, V]
        phx = phx.transpose(1, 2)                                       # [s, N(x), V]
        rhs = torch.cat([torch.cat([phx.real, -phx.imag], dim=2),
                         torch.cat([phx.imag, phx.real], dim=2)], dim=1)  # [s, 2N, 2V]
        phy_re = phy.real.transpose(1, 2)[:, None]                      # [s, 1, N(y), V]
        phy_im = phy.imag.transpose(1, 2)[:, None]
        vis = 0
        for r, coef in enumerate(taylor_coefficients(mu, w_rank)):
            br = b * powers[r]
            lhs = torch.cat([br.real, br.imag], dim=3).reshape(s, P * N, 2 * N)
            prod = dot_mixed(lhs, rhs, rank_mode(precisions, r)).reshape(s, P, N, 2 * V)
            dr, di = prod[..., :V], prod[..., V:]
            sr = (dr * phy_re + di * phy_im).sum(dim=2)                # [s, P, V]
            si = (di * phy_re - dr * phy_im).sum(dim=2)
            vis = vis + torch.complex(sr, si) * coef.conj()[:, None]
        out[lo:hi] = vis.reshape(s, P, C, T).permute(0, 3, 2, 1)
    return out


@register(
    "degridder", "cuda_v6",
    "CUDA C++ pol-stacked x-first adjoint: per rank one [4N,2N]x[2N,2V] product "
    "on the tensor cores (bf16 wgmma, rank-0 3x2k), channel-recurrence Φ, "
    "c-major; counterpart of pallas_v6",
    family="cuda", uniform_channels=True, fallback="cuda_v4",
)
def degridder_cuda_v6(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                      w_rank: int = DEFAULT_W_RANK):
    """Pol-stacked degridder (plain version on the CPU, K9d on a card):
    uniform channel spacing assumed (the API guard falls back to cuda_v4
    otherwise). Returns c64[S, T, C, P]; `degridder_cuda_v6.launches` counts
    launches."""
    _check_staged(params, stg, w_rank)
    device = stg.device
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    _check_tensor("subgrids", subgrids, torch.complex64, (S, P, N, N), device)
    if device.type == "cpu":
        return degridder_polstack_plain(params, stg, subgrids, w_rank)
    if device.type != "cuda":
        raise ValueError(f"degridder_cuda_v6 runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=False)
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    lib = build.library()
    k_dk = wavenumbers_and_step(stg.wavenumbers)
    with torch.cuda.device(device):
        rc = lib.idg_degridder_polstack(
            ptr(stg.uvw), ptr(stg.mu), ptr(k_dk), ptr(stg.po_x),
            ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n), ptr(stg.sph),
            ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(subgrids), ptr(out),
            S, T, C, N, stg.aterms.shape[1], w_rank,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "degridder_cuda_v6")
    degridder_cuda_v6.launches += 1
    return out


degridder_cuda_v6.launches = 0
