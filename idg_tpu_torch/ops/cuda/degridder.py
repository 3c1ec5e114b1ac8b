"""Degridder `cuda_v7`: the hand-written CUDA kernel K2 (csrc/degridder.cu,
the pol-stacked product on the TF32 tensor cores, turned around at N = 32
up to rank 2) and its plain PyTorch version, on uv subgrids or, with `fuse_oyx`, on the
range extraction's block-rolled pieces (the fused grid-stage prologue).

`degridder_cuda_v7` dispatches on the device of the staging it is given: a
CPU staging runs the plain version, a CUDA staging launches the kernel (or
raises). There is no fallback between the two.
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ...utils import trace
from ..common import Staged, n_powers
from ..grid import _finish_extract, dft_split_factors_on
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


def prepare_degridder(stg: Staged, lo: int, hi: int, subgrids: torch.Tensor) -> torch.Tensor:
    """The taper and A1·P·A2ᴴ on the subgrids c64[s, P, N, N] of subgrids
    [lo, hi); returns the pixels c64[s, N(y), N(x), P]
    (idg_tpu/ops/common.py:prepare_degridder_pixels)."""
    a1, a2 = _station_jones(stg, lo, hi)
    pix = subgrids.permute(0, 2, 3, 1) * stg.sph[None, :, :, None]
    return jones_degridder(pix, a1, a2)


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
        pix = prepare_degridder(stg, lo, hi, subgrids[lo:hi])       # [s, y, x, p]
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
    "CUDA C++ pol-stacked separable-phasor degridder, the product on the TF32 "
    "tensor cores (wgmma, three passes; exact per-channel sincos, rank-w "
    "Taylor of e^{-iμn}); counterpart of pallas_v7",
    family="cuda", uniform_channels=False,
)
@trace.span("idg.degridder")
def degridder_cuda_v7(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                      w_rank: int = DEFAULT_W_RANK, fuse_oyx: torch.Tensor | None = None):
    """Degridder on a staging and c64[S, P, N, N] subgrids on the same
    device: the plain version on the CPU, the CUDA kernel on a card.
    Returns c64[S, T, C, P].

    With `fuse_oyx` (i32[S, 2] per-subgrid rolls, ops/grid.py:roll_offsets),
    `subgrids` are the range extraction's block-rolled pieces and the kernel
    runs the fused forward-DFT prologue: the result is that of the
    non-fused kernel on ops/grid.py:_finish_extract(pieces, fuse_oyx).

    `degridder_cuda_v7.launches` counts kernel launches, and
    `degridder_cuda_v7.fused_launches` those of the fused form. While a
    profiler records, one launch of the fused form in
    utils/trace.py:PROBE_EVERY runs probed (utils/trace.py:probe)."""
    _check_staged(params, stg, w_rank)
    device = stg.device
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    _check_tensor("subgrids", subgrids, torch.complex64, (S, P, N, N), device)
    fused = fuse_oyx is not None
    if fused:
        _check_tensor("fuse_oyx", fuse_oyx, torch.int32, (S, 2), device)
    if device.type == "cpu":
        if fused:
            subgrids = _finish_extract(subgrids, fuse_oyx)
        return degridder_plain(params, stg, subgrids, w_rank)
    if device.type != "cuda":
        raise ValueError(f"degridder_cuda_v7 runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=False)
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    lib = build.library()
    common = (ptr(stg.uvw), ptr(stg.mu), ptr(stg.wavenumbers), ptr(stg.po_x),
              ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n), ptr(stg.sph),
              ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
              ptr(stg.station2), ptr(subgrids))
    sizes = (S, T, C, N, stg.aterms.shape[1], w_rank)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if fused:
            wr = dft_split_factors_on(N, False, device)
            probe = trace.probe("degridder_cuda_v7_fused", device)
            rc = lib.idg_degridder_v7_fused(*common, ptr(fuse_oyx), ptr(wr), ptr(out),
                                            None if probe is None else ptr(probe),
                                            *sizes, stream)
        else:
            rc = lib.idg_degridder_v7(*common, ptr(out), *sizes, stream)
    build.check(rc, "degridder_cuda_v7")
    degridder_cuda_v7.launches += 1
    degridder_cuda_v7.fused_launches += fused
    return out


degridder_cuda_v7.launches = 0
degridder_cuda_v7.fused_launches = 0


@register(
    "degridder", "cuda_v8",
    "w-free specialization: cuda_v7 at rank 1 (drops the w-term correction; "
    "exact for w==0 data); counterpart of pallas_v8",
    family="cuda", fallback="cuda_v4", fixed_w_rank=1,
)
def degridder_cuda_v8(params: IDGParams, stg: Staged, subgrids: torch.Tensor):
    """K2 at Taylor rank 1, non-fused; exact for w ≡ 0 observations. On
    w ≠ 0 data the API guard falls back to cuda_v4 at the rank the
    observation needs, as JAX's pallas_v8 falls back to pallas_v4. Its
    launches count on `degridder_cuda_v7`."""
    return degridder_cuda_v7(params, stg, subgrids, 1)
