"""Degridder rungs of the compiler ladder, the counterpart of
``idg_tpu/ops/xla/degridder.py`` (its rungs at :101-141), in complex64
torch ops on the staging's device. The adjoint of ops/torch_ladder/gridder.py
(degridder_reference.cpp:6-129): the taper and A1·P·A2ᴴ on the subgrids,
then each visibility as the sum over pixels of the phasor e^{i(pi·k − po)}
times the prepared pixels.

  torch_reference  one subgrid at a time, the full phasor materialized
                   (xla/degridder.py:70-73)
  torch_v1         the same over batches of subgrids
  torch_v2         the pixel sum as one [T·C, N²] × [N², P] product per
                   subgrid (xla/degridder.py:75-84)
  torch_v3         the channel recurrence (xla/degridder.py:87-98), restarted
                   from an exact phasor every CHANNEL_GROUP channels and
                   stepped by the uniform fit's Δk, as the gridder's; it
                   assumes uniform channel spacing
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged, phase_index, phase_offset_exact
from ..cuda.degridder import prepare_degridder
from ..cuda.gridder import full_fp32_matmuls
from ..cuda.gridder_direct import CHANNEL_GROUP, expi
from ..registry import register
from .gridder import BATCH_SIZE, fitted_channel_step


def degridder_mapped(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                     batch_size: int, body) -> torch.Tensor:
    """Run `body` over batches of `batch_size` subgrids on their prepared
    pixels (xla/degridder.py:_degridder_mapped). body(uvw [s,T,3], pixels
    [s,N,N,P], po [s,N,N], k, l, m, n) -> c64[s, T, C, P]. Returns
    c64[S, T, C, P]."""
    full_fp32_matmuls(stg.device)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    P = params.nr_correlations
    po = phase_offset_exact(params, stg)
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=stg.device)
    for lo in range(0, S, batch_size):
        hi = min(lo + batch_size, S)
        pix = prepare_degridder(stg, lo, hi, subgrids[lo:hi])
        out[lo:hi] = body(stg.uvw[lo:hi], pix, po[lo:hi], stg.wavenumbers,
                          stg.l, stg.m, stg.n)
    return out


def phasor(uvw, po, k, l, m, n) -> torch.Tensor:
    """The degridder phasor e^{i(pi·k − po)}, c64[s, T, C, N, N]."""
    pi = phase_index(uvw, l, m, n)                                   # [s,T,N,N]
    return expi(pi[:, :, None] * k[:, None, None] - po[:, None, None])


def body_full_phase(uvw, pix, po, k, l, m, n) -> torch.Tensor:
    return torch.einsum("stcyx,syxp->stcp", phasor(uvw, po, k, l, m, n), pix)


def body_matmul(uvw, pix, po, k, l, m, n) -> torch.Tensor:
    s, N, P = po.shape[0], po.shape[-1], pix.shape[-1]
    T, C = uvw.shape[1], k.shape[0]
    ph = phasor(uvw, po, k, l, m, n).reshape(s, T * C, N * N)       # [s, T·C, N²]
    vis = torch.matmul(ph, pix.reshape(s, N * N, P))                 # [s, T·C, P]
    return vis.reshape(s, T, C, P)


def body_channel_recurrence(uvw, pix, po, k, l, m, n) -> torch.Tensor:
    C = k.shape[0]
    pi = phase_index(uvw, l, m, n)
    delta = expi(pi * fitted_channel_step(k))
    vis = []
    for c0 in range(0, C, CHANNEL_GROUP):
        c1 = min(c0 + CHANNEL_GROUP, C)
        ph = expi(pi * k[c0] - po[:, None])
        for c in range(c0, c1):
            vis.append(torch.einsum("styx,syxp->stp", ph, pix))
            if c + 1 < c1:
                ph = ph * delta
    return torch.stack(vis, dim=2)                                   # [s, T, C, P]


@register("degridder", "torch_reference",
          "naive: one subgrid at a time, full phase materialization; counterpart of "
          "xla_reference", family="torch")
def degridder_torch_reference(params: IDGParams, stg: Staged, subgrids: torch.Tensor):
    return degridder_mapped(params, stg, subgrids, 1, body_full_phase)


@register("degridder", "torch_v1",
          "subgrid-batched full phase materialization; counterpart of xla_v1",
          family="torch")
def degridder_torch_v1(params: IDGParams, stg: Staged, subgrids: torch.Tensor):
    return degridder_mapped(params, stg, subgrids, BATCH_SIZE, body_full_phase)


@register("degridder", "torch_v2",
          "pixel sum as [TC,N²]×[N²,P] complex matrix products; counterpart of xla_v2",
          family="torch")
def degridder_torch_v2(params: IDGParams, stg: Staged, subgrids: torch.Tensor):
    return degridder_mapped(params, stg, subgrids, BATCH_SIZE, body_matmul)


@register("degridder", "torch_v3",
          "channel-recurrence phasor, exact restart every 8 channels; counterpart of "
          "xla_v3", family="torch", uniform_channels=True, fallback="torch_v2")
def degridder_torch_v3(params: IDGParams, stg: Staged, subgrids: torch.Tensor):
    return degridder_mapped(params, stg, subgrids, BATCH_SIZE, body_channel_recurrence)
