"""Gridder rungs of the compiler ladder, the counterpart of
``idg_tpu/ops/xla/gridder.py`` (its rungs at :123-164), in complex64 torch
ops on the staging's device:

  torch_reference  one subgrid at a time, the full [T, C, N, N] phasor
                   materialized and contracted by einsum (xla/gridder.py:83-87)
  torch_v1         the same over batches of subgrids
  torch_v2         the multiply-accumulate as one [N², T·C] × [T·C, P] product
                   per subgrid (xla/gridder.py:89-98)
  torch_v3         the channel recurrence: the phasor of channel c + 1 is that
                   of channel c times e^{−i·pi·Δk} (xla/gridder.py:100-120),
                   restarted from an exact phasor every CHANNEL_GROUP channels
                   as gridder cuda_v2 is, with Δk the uniform fit's step
                   (`fitted_channel_step`); it assumes uniform channel spacing.
                   JAX's xla_v3 starts once and steps by k[1] − k[0], and
                   drifts (7.9e-6 from the oracle on the correctness problem)

Every rung forms the phase as JAX's does: the offset from one integer
remainder plus w_off·n (`phase_offset_exact`), minus phase_index·k. The
rungs are exact in w and take no Taylor rank. JAX's split-complex pairs
(ops/complexpair.py, the TPU's lack of complex on the MXU) are complex64
here, and the products stay float32 on the card (no TF32).
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged, phase_index, phase_offset_exact
from ..cuda.gridder import finish_gridder, full_fp32_matmuls
from ..cuda.gridder_direct import CHANNEL_GROUP, expi
from ..registry import register

BATCH_SIZE = 16   # subgrids a step of torch_v1 / v2 / v3 (the xla rungs' lax.map batch)


def fitted_channel_step(k: torch.Tensor) -> torch.Tensor:
    """Δk of the uniform fit through the first and the last wavenumber,
    (k[C−1] − k[0]) / (C − 1) in f32 (0 for one channel): the fit
    `ops/common.py:uniform_channel_spacing` holds the wavenumbers to.
    k[1] − k[0] carries both ends' float32 roundings, up to an ulp of k, and
    the recurrence multiplies that by up to CHANNEL_GROUP − 1 steps: on the
    correctness problem the gridder's error is 4.3e-6 with it and 2.3e-6
    with the fitted step (torch_v2: 2.2e-6)."""
    C = k.shape[0]
    if C < 2:
        return torch.zeros((), dtype=k.dtype, device=k.device)
    return (k[-1] - k[0]) / (C - 1)


def gridder_mapped(params: IDGParams, stg: Staged, batch_size: int, body) -> torch.Tensor:
    """Run `body` over batches of `batch_size` subgrids (JAX's lax.map over
    subgrids, xla/gridder.py:_gridder_mapped), then Jones and the taper.
    body(uvw [s,T,3], vis [s,T,C,P], po [s,N,N], k, l, m, n) -> pixels
    c64[s, N, N, P]. Returns c64[S, P, N, N]."""
    full_fp32_matmuls(stg.device)
    S, N, P = stg.nr_subgrids, params.subgrid_size, params.nr_correlations
    po = phase_offset_exact(params, stg)
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=stg.device)
    for lo in range(0, S, batch_size):
        hi = min(lo + batch_size, S)
        pix = body(stg.uvw[lo:hi], stg.vis[lo:hi], po[lo:hi], stg.wavenumbers,
                   stg.l, stg.m, stg.n)
        out[lo:hi] = finish_gridder(stg, lo, hi, pix)
    return out


def phasor(uvw, po, k, l, m, n) -> torch.Tensor:
    """The full gridder phasor e^{i(po − pi·k)}, c64[s, T, C, N, N]."""
    pi = phase_index(uvw, l, m, n)                                   # [s,T,N,N]
    return expi(po[:, None, None] - pi[:, :, None] * k[:, None, None])


def body_full_phase(uvw, vis, po, k, l, m, n) -> torch.Tensor:
    """Materialize the phasor, contract it (the naive formulation)."""
    return torch.einsum("stcyx,stcp->syxp", phasor(uvw, po, k, l, m, n), vis)


def body_matmul(uvw, vis, po, k, l, m, n) -> torch.Tensor:
    """The MAC as [N², T·C] × [T·C, P] products, one per subgrid."""
    s, N, P = po.shape[0], po.shape[-1], vis.shape[-1]
    ph = phasor(uvw, po, k, l, m, n).reshape(s, -1, N * N)           # [s, T·C, N²]
    pix = torch.matmul(ph.transpose(1, 2), vis.reshape(s, -1, P))    # [s, N², P]
    return pix.reshape(s, N, N, P)


def body_channel_recurrence(uvw, vis, po, k, l, m, n) -> torch.Tensor:
    """Two sincos per (pixel, time) and group of CHANNEL_GROUP channels; each
    channel advances the phasor by one complex multiply."""
    C = k.shape[0]
    pi = phase_index(uvw, l, m, n)                                   # [s,T,N,N]
    delta = expi(-pi * fitted_channel_step(k))
    pix = 0
    for c0 in range(0, C, CHANNEL_GROUP):
        c1 = min(c0 + CHANNEL_GROUP, C)
        ph = expi(po[:, None] - pi * k[c0])
        for c in range(c0, c1):
            pix = pix + torch.einsum("styx,stp->syxp", ph, vis[:, :, c])
            if c + 1 < c1:
                ph = ph * delta
    return pix


@register("gridder", "torch_reference",
          "naive: one subgrid at a time, full phase materialization; counterpart of "
          "xla_reference", family="torch")
def gridder_torch_reference(params: IDGParams, stg: Staged):
    return gridder_mapped(params, stg, 1, body_full_phase)


@register("gridder", "torch_v1",
          "subgrid-batched full phase materialization; counterpart of xla_v1",
          family="torch")
def gridder_torch_v1(params: IDGParams, stg: Staged):
    return gridder_mapped(params, stg, BATCH_SIZE, body_full_phase)


@register("gridder", "torch_v2",
          "MAC as [N²,TC]×[TC,P] complex matrix products; counterpart of xla_v2",
          family="torch")
def gridder_torch_v2(params: IDGParams, stg: Staged):
    return gridder_mapped(params, stg, BATCH_SIZE, body_matmul)


@register("gridder", "torch_v3",
          "channel-recurrence phasor, exact restart every 8 channels; counterpart of "
          "xla_v3", family="torch", uniform_channels=True, fallback="torch_v2")
def gridder_torch_v3(params: IDGParams, stg: Staged):
    return gridder_mapped(params, stg, BATCH_SIZE, body_channel_recurrence)
