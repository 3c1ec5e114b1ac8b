"""`torch_v4` of both workloads, the counterpart of
``idg_tpu/ops/xla/separable.py:142-225`` (xla_v4): the separable phasor
Φx[v,x]·Φy[v,y] and a rank-w Taylor of e^{iμn}, so that each rank is one
complex product per subgrid and the sincos count is O(V·N), not O(V·N²).
The form is xla_v4's (its _gridder_subgrid and _degridder_subgrid,
:79-139): the gridder's [N(x), V] × [V, N(y)·P] product per rank, the
degridder's [V, N(y)] × [N(y), N(x)·P] product and the elementwise Φx*
sum, in complex64 torch ops over batches of BATCH_SIZE subgrids. The
products stay float32 on the card (no TF32). JAX's `precision=` knob (the
MXU's bf16 "default" pass) has no counterpart. `w_rank` goes through the
API guard's escalation (ops/api.py:_resolve), as xla_v4's does.
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged, n_powers
from ..cuda.degridder import prepare_degridder
from ..cuda.gridder import (DEFAULT_W_RANK, axis_phasors, finish_gridder,
                            full_fp32_matmuls, taylor_coefficients)
from ..registry import register

BATCH_SIZE = 32   # subgrids a step (xla_v4's lax.map batch)


@register("gridder", "torch_v4",
          "separable phasor Φx·Φy + rank-w Taylor: [N,V]×[V,N·P] complex products, "
          "O(V·N) sincos; counterpart of xla_v4", family="torch")
def gridder_torch_v4(params: IDGParams, stg: Staged, w_rank: int = DEFAULT_W_RANK):
    full_fp32_matmuls(stg.device)
    S, N, P = stg.nr_subgrids, params.subgrid_size, params.nr_correlations
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=stg.device)
    powers = n_powers(stg.n, w_rank)
    for lo in range(0, S, BATCH_SIZE):
        hi = min(lo + BATCH_SIZE, S)
        s = hi - lo
        phx, phy, mu = axis_phasors(stg, lo, hi)                    # [s,V,N], μ [s,V]
        vis = stg.vis[lo:hi].reshape(s, -1, P)                      # [s, V, P]
        lhs = phx.transpose(1, 2)                                   # [s, N(x), V]
        pix = 0
        for r, coef in enumerate(taylor_coefficients(mu, w_rank)):
            # W[v, y·p] = Φy[v,y] ⊛ ṽ_r[v,p]
            w = phy[:, :, :, None] * (vis * coef[:, :, None])[:, :, None, :]
            term = torch.matmul(lhs, w.reshape(s, -1, N * P))       # [s, x, y·p]
            term = term.reshape(s, N, N, P).transpose(1, 2)         # [s, y, x, p]
            pix = pix + term * powers[r][None, :, :, None]
        out[lo:hi] = finish_gridder(stg, lo, hi, pix)
    return out


@register("degridder", "torch_v4",
          "separable phasor adjoint: [V,N]×[N,N·P] complex products, O(V·N) sincos; "
          "counterpart of xla_v4", family="torch")
def degridder_torch_v4(params: IDGParams, stg: Staged, subgrids: torch.Tensor,
                       w_rank: int = DEFAULT_W_RANK):
    full_fp32_matmuls(stg.device)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    out = torch.empty((S, T, C, P), dtype=torch.complex64, device=stg.device)
    powers = n_powers(stg.n, w_rank)
    for lo in range(0, S, BATCH_SIZE):
        hi = min(lo + BATCH_SIZE, S)
        s = hi - lo
        pix = prepare_degridder(stg, lo, hi, subgrids[lo:hi])       # [s, y, x, p]
        phx, phy, mu = axis_phasors(stg, lo, hi)
        phy_conj = phy.conj()                                       # [s, V, N(y)]
        vis = 0
        for r, coef in enumerate(taylor_coefficients(mu, w_rank)):
            p_r = (pix * powers[r][None, :, :, None]).reshape(s, N, N * P)
            # R[v, x·p] = Σ_y conj(Φy)[v,y] · (n^r ⊙ pixels)[y, x·p]
            rr = torch.matmul(phy_conj, p_r).reshape(s, -1, N, P)   # [s, V, x, p]
            # vis_r[v, p] = Σ_x conj(Φx)[v,x] · R[v,x,p]
            vr = (phx.conj()[:, :, :, None] * rr).sum(dim=2)        # [s, V, P]
            vis = vis + vr * coef.conj()[:, :, None]                # (−iμ)^r/r!
        out[lo:hi] = vis.reshape(s, T, C, P)
    return out
