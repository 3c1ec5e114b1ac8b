"""Degridder `cuda_v7`: the hand-written CUDA kernel (csrc/degridder.cu)
and its plain PyTorch version.

`degridder_cuda_v7` dispatches on the device of the staging it is given: a
CPU staging runs `degridder_plain`, a CUDA staging launches the kernel (or
raises). There is no fallback between the two.
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged, n_powers
from ..registry import register
from . import build
from .gridder import (
    DEFAULT_W_RANK,
    PLAIN_CHUNK,
    _check_staged,
    _check_tensor,
    _station_jones,
    axis_phasors,
    check_staging,
    full_fp32_matmuls,
    ptr,
    taylor_coefficients,
)


def jones_degridder(pix: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor):
    """A1·P·A2ᴴ per pixel (math.hpp:79-92); [..., 4] in xx,xy,yx,yy order."""
    p = pix.reshape(*pix.shape[:-1], 2, 2)
    j1 = a1.reshape(*a1.shape[:-1], 2, 2)
    j2 = a2.reshape(*a2.shape[:-1], 2, 2)
    return (j1 @ p @ j2.conj().transpose(-1, -2)).reshape(pix.shape)


def degridder_plain(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                    w_rank: int = DEFAULT_W_RANK):
    """The kernel's function in complex64 torch ops, chunked over subgrids:
    taper + A1·P·A2ᴴ, then per rank r the Φy* contraction of the n^r-weighted
    pixels, the Φx* contraction, and the conjugate Taylor coefficient
    (the form of idg_tpu/ops/xla/separable.py:109-139). Returns
    c64[S, T, C, P]."""
    full_fp32_matmuls(stg.device)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    P = params.nr_correlations
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=stg.device)
    powers = n_powers(stg.n, w_rank)
    for lo in range(0, S, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, S)
        a1, a2 = _station_jones(stg, lo, hi)
        pix = subgrids[lo:hi].permute(0, 2, 3, 1) * stg.sph[None, :, :, None]
        pix = jones_degridder(pix, a1, a2)                           # [s, y, x, p]
        phx, phy, mu = axis_phasors(stg, lo, hi)
        vis = torch.zeros((hi - lo, T * C, P), dtype=torch.complex64, device=stg.device)
        for r, coef in enumerate(taylor_coefficients(mu, w_rank)):
            pr = pix * powers[r][None, :, :, None]
            rr = torch.einsum("svy,syxp->svxp", phy.conj(), pr)
            vr = torch.einsum("svx,svxp->svp", phx.conj(), rr)
            vis = vis + vr * coef.conj()[:, :, None]
        out[lo:hi] = vis.reshape(hi - lo, T, C, P)
    return out


@register(
    "degridder", "cuda_v7",
    "CUDA C++ FP32 separable-phasor degridder (one block per subgrid, "
    "threads own visibilities, rank-w Taylor of e^{-iμn}); counterpart of "
    "pallas_v7",
    family="cuda", uniform_channels=False,
)
def degridder_cuda_v7(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                      w_rank: int = DEFAULT_W_RANK):
    """Degridder on a staging and c64[S, P, N, N] subgrids on the same
    device: the plain version on the CPU, the CUDA kernel on a card.
    Returns c64[S, T, C, P]. `degridder_cuda_v7.launches` counts kernel
    launches."""
    _check_staged(params, stg, w_rank)
    device = stg.device
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    _check_tensor("subgrids", subgrids, torch.complex64, (S, P, N, N), device)
    if device.type == "cpu":
        return degridder_plain(params, stg, subgrids, w_rank)
    if device.type != "cuda":
        raise ValueError(f"degridder_cuda_v7 runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=False)
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_degridder_v7(
            ptr(stg.uvw), ptr(stg.mu), ptr(stg.wavenumbers), ptr(stg.po_x),
            ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n), ptr(stg.sph),
            ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(subgrids), ptr(out),
            S, T, C, N, stg.aterms.shape[1], w_rank,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "degridder_cuda_v7")
    degridder_cuda_v7.launches += 1
    return out


degridder_cuda_v7.launches = 0
