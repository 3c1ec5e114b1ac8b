"""Gridder `cuda_v1` / `cuda_v2`: the direct full-phase kernel K8a
(csrc/gridder_direct.cu) and its plain PyTorch version.

The direct gridder computes the reference kernel's math
(gridder_reference.cu:40-107) with no Taylor of the w term, so it is exact
at any w:
  phase[t,c,y,x] = po[y,x] − (u_t·l_x + v_t·m_y + w_t·n_yx)·k_c,
  po = po_x[x] + po_y[y] + w_off·n[y,x]
  pix[y,x,p] = Σ_{t,c} vis[t,c,p] · e^{i·phase}
then Jones A1ᴴ·P·A2 and the taper. `cuda_v1` evaluates every phasor exactly
(the kernel: reduced by 2π, then the SFU). `cuda_v2` advances the phasor over the channels by repeated
complex multiplies with e^{−i·pi·Δk}, Δk = k[1] − k[0], and restarts it from
an exact sincos every CHANNEL_GROUP channels (JAX's pallas_v2 starts once, at
channel 0, and drifts past the 1e-5 gate at C = 256); it assumes uniform
channel spacing. The kernel takes the complex MAC as a product on the TF32
tensor cores in three passes ("3xtf32", ops/precision.py), float32 quality;
the plain version below contracts in float32.

Each wrapper dispatches on the device of the staging it is given: a CPU
staging runs the plain version, a CUDA staging launches the kernel (or
raises). There is no fallback between the two.
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged
from ..registry import register
from . import build
from .gridder import (
    PLAIN_CHUNK,
    _check_staged,
    check_staging,
    finish_gridder,
    full_fp32_matmuls,
    ptr,
)

CHANNEL_GROUP = 8   # exact restarts of K8a's recurrence (kChanGroup in csrc/gridder_direct.cu)


def expi(phase: torch.Tensor) -> torch.Tensor:
    """e^{i·phase}, complex64."""
    return torch.polar(torch.ones_like(phase), phase)


def channel_step(k: torch.Tensor) -> torch.Tensor:
    """Δk = k[1] − k[0] in f32 (0 for one channel), the recurrence's step."""
    return k[1] - k[0] if k.shape[0] > 1 else torch.zeros((), dtype=k.dtype, device=k.device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in float32 with one rounding, as a fused multiply-add: the
    product of two float32 values is exact in float64, so the float64 sum
    rounded to float32 is the FMA's result (but for a double rounding at a
    tie)."""
    return (a.double() * b.double() + c.double()).float()


def direct_geometry(stg: Staged, lo: int, hi: int):
    """The phase index pi[s, t, y·N+x] = u·l_x + v·m_y + w·n_yx and the phase
    offset po[s, 1, y·N+x] = po_x + po_y + w_off·n for subgrids [lo, hi), f32,
    with the roundings of idg_tpu/ops/pallas/gridder.py:_gridder_direct and
    _kernel_direct as XLA compiles them: pi = fma(w, n, fma(u, l, v·m)),
    po = fma(w_off, n, po_x + po_y). The phase is one more FMA,
    `gridder_phase` (the degridder's is its negation)."""
    s = hi - lo
    uvw = stg.uvw[lo:hi]
    u, v, w = (uvw[:, :, i, None, None] for i in range(3))
    pi = fma32(w, stg.n, fma32(u, stg.l, v * stg.m[:, None]))
    po = fma32(stg.w_off[lo:hi, None, None], stg.n,
               stg.po_x[lo:hi, None, :] + stg.po_y[lo:hi, :, None])
    return pi.reshape(s, uvw.shape[1], -1), po.reshape(s, 1, -1)


def gridder_phase(pi: torch.Tensor, k: torch.Tensor, po: torch.Tensor) -> torch.Tensor:
    """The gridder's float32 phase po − pi·k as XLA fuses it, fma(−pi, k, po);
    the degridder's pi·k − po = fma(pi, k, −po) is its exact negation."""
    return fma32(-pi, k, po)


def gridder_direct_plain(params: IDGParams, stg: Staged, recurrence: bool):
    """The kernel's function in complex64 torch ops, chunked over subgrids:
    the phasor of every (visibility, pixel), materialized, contracted with
    the visibilities over (t, c); then Jones A1ᴴ·P·A2 and the taper. With
    `recurrence`, each group of CHANNEL_GROUP channels starts from an exact
    phasor and steps by one complex multiply per channel, as the kernel does.
    Returns c64[S, P, N, N]."""
    full_fp32_matmuls(stg.device)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    k = stg.wavenumbers
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=stg.device)
    for lo in range(0, S, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, S)
        pi, po = direct_geometry(stg, lo, hi)                       # [s,T,NN], [s,1,NN]
        vis = stg.vis[lo:hi]                                        # [s,T,C,P]
        if recurrence:
            d = expi(-(pi * channel_step(k)))
            pix = 0
            for c0 in range(0, C, CHANNEL_GROUP):
                c1 = min(c0 + CHANNEL_GROUP, C)
                ph = expi(gridder_phase(pi, k[c0], po))
                for c in range(c0, c1):
                    pix = pix + torch.einsum("stp,stq->sqp", vis[:, :, c], ph)
                    if c + 1 < c1:
                        ph = ph * d
        else:
            ph = expi(gridder_phase(pi[:, :, None], k[:, None], po[:, :, None]))  # [s,T,C,NN]
            pix = torch.einsum("stcp,stcq->sqp", vis, ph)
        out[lo:hi] = finish_gridder(stg, lo, hi, pix.reshape(hi - lo, N, N, P))
    return out


def _gridder_direct(wrapper, params: IDGParams, stg: Staged, recurrence: bool):
    """Dispatch of both wrappers: plain version on a CPU staging, K8a on a
    CUDA staging, counted on `wrapper.launches`."""
    name = wrapper.__name__
    _check_staged(params, stg, None)
    device = stg.device
    if device.type == "cpu":
        return gridder_direct_plain(params, stg, recurrence)
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=True)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_gridder_direct(
            ptr(stg.uvw), ptr(stg.vis), ptr(stg.wavenumbers), ptr(stg.w_off),
            ptr(stg.po_x), ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n),
            ptr(stg.sph), ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(out),
            S, T, C, N, stg.aterms.shape[1], int(recurrence),
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, name)
    wrapper.launches += 1
    return out


@register(
    "gridder", "cuda_v1",
    "CUDA C++ direct gridder: an exact phasor per (t,c,pixel) (2π-reduced, SFU), "
    "complex MAC on TF32 mma.sync (3 passes), exact at any w; counterpart of "
    "pallas_v1",
    family="cuda",
)
def gridder_cuda_v1(params: IDGParams, stg: Staged):
    """Direct gridder on a staging (plain version on the CPU, K8a on a card).
    Returns c64[S, P, N, N]; `gridder_cuda_v1.launches` counts launches."""
    return _gridder_direct(gridder_cuda_v1, params, stg, False)


@register(
    "gridder", "cuda_v2",
    "CUDA C++ direct gridder with the channel recurrence: exact phasors every "
    "8 channels, one complex multiply per channel, complex MAC on TF32 "
    "mma.sync (3 passes); counterpart of pallas_v2",
    family="cuda", uniform_channels=True, fallback="cuda_v1",
)
def gridder_cuda_v2(params: IDGParams, stg: Staged):
    """`gridder_cuda_v1` with the channel recurrence (uniform channel spacing
    assumed; the API guard falls back to cuda_v1 otherwise).
    `gridder_cuda_v2.launches` counts launches."""
    return _gridder_direct(gridder_cuda_v2, params, stg, True)


gridder_cuda_v1.launches = 0
gridder_cuda_v2.launches = 0
