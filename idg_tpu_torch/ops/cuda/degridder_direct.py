"""Degridder `cuda_v1` / `cuda_v2`: the direct full-phase kernel K9a
(csrc/degridder_direct.cu) and its plain PyTorch version.

The adjoint of ops/cuda/gridder_direct.py (degridder_reference.cu:39-115):
  pix'[y,x,p] = A1 · (sph·P) · A2ᴴ                            (prologue)
  vis[t,c,p] = Σ_{y,x} pix'[y,x,p] · e^{i·(pi[t,y,x]·k_c − po[y,x])}
with pi = u·l + v·m + w·n and po = po_x + po_y + w_off·n, exact at any w.
`cuda_v1` evaluates every phasor exactly; `cuda_v2` advances it
over the channels by repeated complex multiplies with e^{i·pi·Δk}, assuming
uniform channel spacing. The kernel gives each thread a group of
CHANNEL_GROUP channels of one timestep, so the recurrence restarts with an
exact sincos at each group's first channel (JAX's pallas_v2 starts once, at
channel 0); the plain version does the same. The kernel takes the complex
MAC on the TF32 tensor cores in three passes ("3xtf32"); the plain version
contracts in float32.

`degridder_cuda_v1` / `degridder_cuda_v2` dispatch on the staging's device:
plain version on the CPU, the kernel on a card (or raise).
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged
from ..registry import register
from . import build
from .degridder import prepare_degridder
from .gridder import (
    PLAIN_CHUNK,
    _check_staged,
    _check_tensor,
    check_staging,
    full_fp32_matmuls,
    ptr,
)
from .gridder_direct import channel_step, direct_geometry, expi, gridder_phase

CHANNEL_GROUP = 8   # channels per thread in K9a (kChanGroup in csrc/degridder_direct.cu)


def degridder_direct_plain(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                           recurrence: bool):
    """The kernel's function in complex64 torch ops, chunked over subgrids:
    taper + A1·P·A2ᴴ, then the phasor of every (visibility, pixel),
    materialized and contracted with the pixels. With `recurrence`, each
    group of CHANNEL_GROUP channels starts from an exact phasor and steps by
    one complex multiply per channel, as the kernel does. Returns
    c64[S, T, C, P]."""
    full_fp32_matmuls(stg.device)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    k = stg.wavenumbers
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=stg.device)
    for lo in range(0, S, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, S)
        pix = prepare_degridder(stg, lo, hi, subgrids[lo:hi]).reshape(hi - lo, N * N, P)
        pi, po = direct_geometry(stg, lo, hi)                       # [s,T,NN], [s,1,NN]
        if recurrence:
            d = expi(pi * channel_step(k))
            for c0 in range(0, C, CHANNEL_GROUP):
                c1 = min(c0 + CHANNEL_GROUP, C)
                ph = expi(-gridder_phase(pi, k[c0], po))
                for c in range(c0, c1):
                    out[lo:hi, :, c] = torch.einsum("stq,sqp->stp", ph, pix)
                    if c + 1 < c1:
                        ph = ph * d
        else:
            ph = expi(-gridder_phase(pi[:, :, None], k[:, None], po[:, :, None]))  # [s,T,C,NN]
            out[lo:hi] = torch.einsum("stcq,sqp->stcp", ph, pix)
    return out


def _degridder_direct(wrapper, params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                      recurrence: bool):
    """Dispatch of both wrappers: plain version on a CPU staging, K9a on a
    CUDA staging, counted on `wrapper.launches`."""
    name = wrapper.__name__
    _check_staged(params, stg, None)
    device = stg.device
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    _check_tensor("subgrids", subgrids, torch.complex64, (S, P, N, N), device)
    if device.type == "cpu":
        return degridder_direct_plain(params, stg, subgrids, recurrence)
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=False)
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_degridder_direct(
            ptr(stg.uvw), ptr(stg.wavenumbers), ptr(stg.w_off), ptr(stg.po_x),
            ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n), ptr(stg.sph),
            ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(subgrids), ptr(out),
            S, T, C, N, stg.aterms.shape[1], int(recurrence),
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, name)
    wrapper.launches += 1
    return out


@register(
    "degridder", "cuda_v1",
    "CUDA C++ direct degridder: taper+Jones prologue, an exact phasor per "
    "(t,c,pixel) (2π-reduced, SFU), complex MAC on TF32 mma.sync (3 passes), "
    "exact at any w; counterpart of pallas_v1",
    family="cuda",
)
def degridder_cuda_v1(params: IDGParams, stg: Staged, subgrids: torch.Tensor):
    """Direct degridder on a staging and c64[S, P, N, N] subgrids on the same
    device (plain version on the CPU, K9a on a card). Returns c64[S, T, C, P];
    `degridder_cuda_v1.launches` counts launches."""
    return _degridder_direct(degridder_cuda_v1, params, stg, subgrids, False)


@register(
    "degridder", "cuda_v2",
    "CUDA C++ direct degridder with the channel recurrence: 2 exact phasors "
    "per (t,pixel) and channel group, one complex multiply per channel, "
    "complex MAC on TF32 mma.sync (3 passes); counterpart of pallas_v2",
    family="cuda", uniform_channels=True, fallback="cuda_v1",
)
def degridder_cuda_v2(params: IDGParams, stg: Staged, subgrids: torch.Tensor):
    """`degridder_cuda_v1` with the channel recurrence (uniform channel
    spacing assumed; the API guard falls back to cuda_v1 otherwise).
    `degridder_cuda_v2.launches` counts launches."""
    return _degridder_direct(degridder_cuda_v2, params, stg, subgrids, True)


degridder_cuda_v1.launches = 0
degridder_cuda_v2.launches = 0
