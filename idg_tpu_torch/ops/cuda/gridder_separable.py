"""Gridder `cuda_v3` / `cuda_v4` / `cuda_v5`: the separable-phasor kernels
K8b (cuda_v3: csrc/gridder_sep_fp32.cu, cuda_v4: csrc/gridder_sep_bf16.cu)
and K8c (cuda_v5: the recurrence instance of cuda_v4's kernel in
csrc/gridder_sep_bf16.cu), entered through csrc/gridder_separable.cu, and
their plain PyTorch version.

Per subgrid and Taylor rank r the gridder is one complex matrix product,
  pix_r[y, (p,x)] = Σ_v Φy[v,y] · W_r[v,(p,x)],   W_r = Φx[v,x] · vis[v,p] · (iμ_v)^r / r!
then pix = Σ_r n^r ⊙ pix_r, Jones A1ᴴ·P·A2 and the taper (the math of
idg_tpu/ops/pallas/gridder.py:_kernel_separable). The rungs differ in how
the product is taken and how Φ is made:

  cuda_v3  float32 products ("highest") in FFMA on the CUDA cores, Φ by one
           exact sincos per entry
  cuda_v4  the precision policy of ops/precision.py:gridder_precisions
           (bf16_3x for the signal, one bf16 pass for the rank-1
           correction at rank ≤ 2) on the tensor cores (`wgmma`); exact Φ
  cuda_v5  cuda_v4's kernel and policy (`wgmma`, producer warps), with Φ
           made in the producers by the channel recurrence: the channel-0
           plane and one complex multiply per channel by the Δk plane, with
           an exact resync from k0 + c·Δk at every c % 16 == 0, c > 0. It
           assumes uniform channel spacing (the guard falls back to cuda_v4).

v3/v4 order the visibilities t-major (v = t·C + c), v5 c-major
(v = c·T + t), as JAX's kernels do; the order changes only the summation
order, and the output layout is the same.

Each wrapper dispatches on the staging's device: a CPU staging runs the
plain version, a CUDA staging launches the kernel (or raises).
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ..common import Staged, n_powers
from ..precision import dot_mixed, gridder_precisions, rank_mode
from ..registry import register
from . import build
from .gridder import (
    DEFAULT_W_RANK,
    PLAIN_CHUNK,
    _check_staged,
    axis_phasors,
    check_staging,
    finish_gridder,
    full_fp32_matmuls,
    ptr,
    taylor_coefficients,
)
from .gridder_direct import channel_step, expi

RESYNC = 16   # the recurrence restarts exactly at every channel c % RESYNC == 0, c > 0
# the kernels' `variant` argument: (tensor-core bf16 split products, channel recurrence)
VARIANTS = {"cuda_v3": 0, "cuda_v4": 1, "cuda_v5": 2}


def recurrence_planes(po: torch.Tensor, coord: torch.Tensor, axis: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """One axis's phasor planes made as JAX's _kernel_sep_recur makes them:
    e^{i(po − axis·(coord·k0))} at channel 0, then one complex multiply per
    channel by e^{−i·axis·(coord·Δk)}, and an exact restart from
    kc = k0 + c·Δk at every c % RESYNC == 0, c > 0. po f32[s, N], coord
    f32[s, T] (u or v), axis f32[N] (l or m); returns c64[s, C·T, N],
    c-major."""
    s, T = coord.shape
    C = k.shape[0]
    k0, dk = k[0], channel_step(k)
    co = coord[:, :, None]

    def exact(kc):
        return expi(po[:, None, :] - axis * (co * kc))

    cur, delta = exact(k0), expi(-(axis * (co * dk)))
    planes = []
    for c in range(C):
        if c and c % RESYNC == 0:
            cur = exact(k0 + c * dk)
        planes.append(cur)
        if c + 1 < C:
            cur = cur * delta
    return torch.stack(planes, dim=1).reshape(s, C * T, -1)


def separable_phasors(stg: Staged, lo: int, hi: int, recurrence: bool):
    """Φx[s,v,x], Φy[s,v,y] (c64) and μ[s,v] for subgrids [lo, hi), in the
    rung's visibility order: t-major and exact, or c-major by the channel
    recurrence. `visibility_order` puts a [s, T, C, ...] array in the same
    order."""
    if not recurrence:
        return axis_phasors(stg, lo, hi)
    uvw = stg.uvw[lo:hi]
    k = stg.wavenumbers
    phx = recurrence_planes(stg.po_x[lo:hi], uvw[:, :, 0], stg.l, k)
    phy = recurrence_planes(stg.po_y[lo:hi], uvw[:, :, 1], stg.m, k)
    return phx, phy, visibility_order(stg.mu[lo:hi], True)


def visibility_order(a: torch.Tensor, recurrence: bool) -> torch.Tensor:
    """[s, T, C, ...] → [s, V, ...], t-major, or c-major for the recurrence."""
    if recurrence:
        a = a.transpose(1, 2)
    return a.reshape(a.shape[0], -1, *a.shape[3:])


def packed_product(phy: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Σ_v Φy[s,v,y] · W[s,v,j] as JAX's packed real product
    [Φyᵀ_re; Φyᵀ_im] [2N, V] × [W_re | W_im] [V, 2J] in `mode`
    (gridder.py:489-494). Returns c64[s, N(y), J]."""
    n, j = phy.shape[2], w.shape[2]
    lhs = torch.cat([phy.real, phy.imag], dim=2).transpose(1, 2)
    prod = dot_mixed(lhs, torch.cat([w.real, w.imag], dim=2), mode)
    return torch.complex(prod[:, :n, :j] - prod[:, n:, j:], prod[:, :n, j:] + prod[:, n:, :j])


def gridder_separable_plain(params: IDGParams, stg: Staged, w_rank: int, precisions,
                            recurrence: bool):
    """The kernels' function in torch ops, chunked over subgrids: per rank r
    the packed product of Φy with W_r = Φx ⊙ vis·(iμ)^r/r! in the rank's
    precision mode, weighted by n^r; then Jones A1ᴴ·P·A2 and the taper.
    Returns c64[S, P, N, N]."""
    full_fp32_matmuls(stg.device)
    S, N, P = stg.nr_subgrids, params.subgrid_size, params.nr_correlations
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=stg.device)
    powers = n_powers(stg.n, w_rank)
    for lo in range(0, S, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, S)
        phx, phy, mu = separable_phasors(stg, lo, hi, recurrence)
        vis = visibility_order(stg.vis[lo:hi], recurrence)            # [s, V, P]
        pix = 0
        for r, coef in enumerate(taylor_coefficients(mu, w_rank)):
            w = phx[:, :, None, :] * (vis * coef[:, :, None])[:, :, :, None]  # [s,V,p,x]
            term = packed_product(phy, w.reshape(hi - lo, -1, P * N), rank_mode(precisions, r))
            pix = pix + term.reshape(hi - lo, N, P, N) * powers[r][None, :, None, :]
        out[lo:hi] = finish_gridder(stg, lo, hi, pix.transpose(2, 3))
    return out


def plain_precisions(version: str, w_rank: int):
    """The precision policy of a rung at rank w_rank."""
    return ("highest",) if version == "cuda_v3" else gridder_precisions(w_rank)


def _gridder_separable(wrapper, version: str, params: IDGParams, stg: Staged, w_rank: int):
    """Dispatch of the three wrappers: the plain version on a CPU staging,
    K8b / K8c on a CUDA staging, counted on `wrapper.launches`."""
    name = wrapper.__name__
    _check_staged(params, stg, w_rank)
    device = stg.device
    variant = VARIANTS[version]
    if device.type == "cpu":
        return gridder_separable_plain(params, stg, w_rank, plain_precisions(version, w_rank),
                                       variant == VARIANTS["cuda_v5"])
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
        rc = lib.idg_gridder_separable(
            ptr(stg.uvw), ptr(stg.vis), ptr(stg.mu), ptr(stg.wavenumbers),
            ptr(stg.po_x), ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n),
            ptr(stg.sph), ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(out),
            S, T, C, N, stg.aterms.shape[1], w_rank, variant,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, name)
    wrapper.launches += 1
    return out


@register(
    "gridder", "cuda_v3",
    "CUDA C++ separable phasor: per rank one packed Φyᵀ·(Φx⊙vis) product in "
    "FP32 FFMA, register-tiled, two ranks a pass, exact sincos; counterpart of pallas_v3",
    family="cuda",
)
def gridder_cuda_v3(params: IDGParams, stg: Staged, w_rank: int = DEFAULT_W_RANK):
    """Separable gridder, float32 products (plain version on the CPU, K8b on
    a card). Returns c64[S, P, N, N]; `gridder_cuda_v3.launches` counts
    launches."""
    return _gridder_separable(gridder_cuda_v3, "cuda_v3", params, stg, w_rank)


@register(
    "gridder", "cuda_v4",
    "v3 on the tensor cores: bf16 wgmma with producer warps, rank-0 bf16_3x, "
    "rank-1 correction single-pass bf16; counterpart of pallas_v4",
    family="cuda",
)
def gridder_cuda_v4(params: IDGParams, stg: Staged, w_rank: int = DEFAULT_W_RANK):
    """Separable gridder, split bf16 products on the tensor cores (plain
    version on the CPU, K8b on a card). `gridder_cuda_v4.launches` counts
    launches."""
    return _gridder_separable(gridder_cuda_v4, "cuda_v4", params, stg, w_rank)


@register(
    "gridder", "cuda_v5",
    "v4's bf16 wgmma kernel with the channel-recurrence phasors in its producer "
    "warps (exact resync every 16 channels), c-major; counterpart of pallas_v5",
    family="cuda", uniform_channels=True, fallback="cuda_v4",
)
def gridder_cuda_v5(params: IDGParams, stg: Staged, w_rank: int = DEFAULT_W_RANK):
    """`gridder_cuda_v4` with Φ by the channel recurrence (K8c; uniform
    channel spacing assumed, the API guard falls back to cuda_v4
    otherwise). `gridder_cuda_v5.launches` counts launches."""
    return _gridder_separable(gridder_cuda_v5, "cuda_v5", params, stg, w_rank)


gridder_cuda_v3.launches = 0
gridder_cuda_v4.launches = 0
gridder_cuda_v5.launches = 0
