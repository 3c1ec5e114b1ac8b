"""Gridder `cuda_v6`: the hand-written CUDA kernel K1 (csrc/gridder.cu, the
separable product on the TF32 tensor cores, precision mode "3xtf32" of
ops/precision.py or hi·hi alone, a Taylor rank at a time as
ops/precision.py:gridder_three_pass_ranks picks) and its plain PyTorch
version (float32 throughout, the kernel's reference), in two forms: uv subgrids
(`gridder_cuda_v6`) and, with the fused grid-stage epilogue, block-rolled
image-domain pieces (`gridder_cuda_v6_pieces`).

Each wrapper dispatches on the device of the staging it is given: a CPU
staging runs the plain version, a CUDA staging launches the kernel (or
raises). There is no fallback between the two.
"""

from __future__ import annotations

import torch

from ...config import IDGParams
from ...utils import trace
from ..common import MAX_W_RANK, Staged, n_powers
from ..grid import dft_split_factors_on, pieces_from_subgrids
from ..precision import gridder_three_pass_ranks, tf32_passes
from ..registry import register
from . import build

DEFAULT_W_RANK = 2
SUBGRID_SIZES = (16, 32)   # the N the kernels are compiled for
PLAIN_CHUNK = 32           # subgrids per plain-version step (bounds temporaries)
RANK_COUNTER = "idg.w_rank.gridder"   # K1's launches by Taylor rank (utils/trace.py)
PASS_COUNTER = "idg.w_passes.gridder"   # and by TF32 product passes a tile


def taylor_coefficients(mu: torch.Tensor, w_rank: int):
    """(iμ)^r / r! for r < w_rank, complex64 over μ's shape."""
    coef = torch.ones_like(mu, dtype=torch.complex64)
    coefs = [coef]
    for r in range(1, w_rank):
        coef = coef * (1j * mu / r)
        coefs.append(coef)
    return coefs


def full_fp32_matmuls(device: torch.device) -> None:
    """On the card, keep the plain version's products out of TF32 (three
    decimal digits), so it is a float32 reference for the kernel."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def axis_phasors(stg: Staged, lo: int, hi: int):
    """Φx[s,v,x], Φy[s,v,y] (complex64) and μ[s,v] for subgrids [lo, hi),
    v = t·C + c (the math of idg_tpu/ops/xla/separable.py:66-76)."""
    uvw = stg.uvw[lo:hi]
    k = stg.wavenumbers
    s = uvw.shape[0]
    uk = (uvw[:, :, 0, None] * k).reshape(s, -1)
    vk = (uvw[:, :, 1, None] * k).reshape(s, -1)
    ph_x = stg.po_x[lo:hi, None, :] - uk[:, :, None] * stg.l
    ph_y = stg.po_y[lo:hi, None, :] - vk[:, :, None] * stg.m
    phx = torch.polar(torch.ones_like(ph_x), ph_x)
    phy = torch.polar(torch.ones_like(ph_y), ph_y)
    return phx, phy, stg.mu[lo:hi].reshape(s, -1)


def jones_gridder(pix: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor):
    """A1ᴴ·P·A2 per pixel (math.hpp:64-77); [..., 4] in xx,xy,yx,yy order."""
    p = pix.reshape(*pix.shape[:-1], 2, 2)
    j1 = a1.reshape(*a1.shape[:-1], 2, 2)
    j2 = a2.reshape(*a2.shape[:-1], 2, 2)
    return (j1.conj().transpose(-1, -2) @ p @ j2).reshape(pix.shape)


def _station_jones(stg: Staged, lo: int, hi: int):
    aidx = stg.aterm_index[lo:hi].long()
    a1 = stg.aterms[aidx, stg.station1[lo:hi].long()]   # [s, N, N, P]
    a2 = stg.aterms[aidx, stg.station2[lo:hi].long()]
    return a1, a2


def finish_gridder(stg: Staged, lo: int, hi: int, pix: torch.Tensor) -> torch.Tensor:
    """Jones A1ᴴ·P·A2 and the taper on the accumulated pixels c64[s, N(y),
    N(x), P] of subgrids [lo, hi); returns them pol-major, c64[s, P, N, N]
    (idg_tpu/ops/common.py:finish_gridder)."""
    a1, a2 = _station_jones(stg, lo, hi)
    pix = jones_gridder(pix, a1, a2) * stg.sph[None, :, :, None]
    return pix.permute(0, 3, 1, 2)


def gridder_plain(params: IDGParams, stg: Staged, w_rank: int = DEFAULT_W_RANK):
    """The kernel's function in complex64 torch ops, chunked over subgrids:
    per rank r, W[v,y,p] = Φy ⊛ (vis·(iμ)^r/r!) contracted with Φx over v,
    weighted by n^r (the form of idg_tpu/ops/xla/separable.py:79-106), then
    Jones A1ᴴ·P·A2 and the taper. Returns c64[S, P, N, N]."""
    full_fp32_matmuls(stg.device)
    S, N, P = stg.nr_subgrids, params.subgrid_size, params.nr_correlations
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=stg.device)
    powers = n_powers(stg.n, w_rank)
    for lo in range(0, S, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, S)
        phx, phy, mu = axis_phasors(stg, lo, hi)
        vis = stg.vis[lo:hi].reshape(hi - lo, -1, P)               # [s, V, P]
        pix = torch.zeros((hi - lo, N, N, P), dtype=torch.complex64, device=stg.device)
        for r, coef in enumerate(taylor_coefficients(mu, w_rank)):
            w = phy[:, :, :, None] * (vis * coef[:, :, None])[:, :, None, :]  # [s,V,y,p]
            term = torch.einsum("svx,svyp->syxp", phx, w)
            pix = pix + term * powers[r][None, :, :, None]
        out[lo:hi] = finish_gridder(stg, lo, hi, pix)
    return out


def _check_staged(params: IDGParams, stg: Staged, w_rank: int | None) -> None:
    """The sizes the kernels are built for; w_rank None for the direct kernels,
    which take none."""
    N = params.subgrid_size
    if N not in SUBGRID_SIZES:
        raise ValueError(f"subgrid_size {N} not supported; the kernels take {SUBGRID_SIZES}")
    if params.nr_correlations != 4:
        raise ValueError("the kernels take 4 correlations (xx, xy, yx, yy)")
    if w_rank is not None and not 1 <= w_rank <= MAX_W_RANK:
        raise ValueError(f"w_rank {w_rank} outside [1, {MAX_W_RANK}]")


def _check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_staging(params: IDGParams, stg: Staged, with_vis: bool) -> None:
    """Device, dtype, shape and contiguity of every field a kernel reads."""
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    ts, st = stg.aterms.shape[:2]
    f32, i32, c64 = torch.float32, torch.int32, torch.complex64
    specs = [
        ("uvw", f32, (S, T, 3)), ("mu", f32, (S, T, C)), ("w_off", f32, (S,)),
        ("wavenumbers", f32, (C,)),
        ("po_x", f32, (S, N)), ("po_y", f32, (S, N)), ("l", f32, (N,)), ("m", f32, (N,)),
        ("n", f32, (N, N)), ("sph", f32, (N, N)), ("aterms", c64, (ts, st, N, N, P)),
        ("aterm_index", i32, (S,)), ("station1", i32, (S,)), ("station2", i32, (S,)),
    ]
    if with_vis:
        if stg.vis is None:
            raise ValueError("the gridder needs a staging with visibilities")
        specs.append(("vis", c64, (S, T, C, P)))
    for name, dtype, shape in specs:
        _check_tensor(name, getattr(stg, name), dtype, shape, stg.device)


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a tensor; complex tensors as interleaved float2."""
    return (torch.view_as_real(t) if t.is_complex() else t).data_ptr()


def _count(w_rank: int, three_ranks: int) -> None:
    """One K1 launch (or plain call) under RANK_COUNTER by its Taylor rank
    and under PASS_COUNTER by its TF32 passes a tile."""
    trace.count_rank(RANK_COUNTER, w_rank)
    trace.count_rank(PASS_COUNTER, tf32_passes(three_ranks, w_rank))


@register(
    "gridder", "cuda_v6",
    "CUDA C++ separable-phasor gridder, the product on the TF32 tensor cores "
    "(wgmma, three passes, hi·hi alone for small Taylor terms; exact per-channel "
    "sincos, rank-w Taylor of e^{iμn}); "
    "counterpart of pallas_v6",
    family="cuda", uniform_channels=False,
)
def gridder_cuda_v6(params: IDGParams, stg: Staged, w_rank: int = DEFAULT_W_RANK):
    """Gridder on a staging: the plain version for a CPU staging, the CUDA
    kernel for a CUDA staging. Returns c64[S, P, N, N] on the staging's
    device. Each Taylor rank takes three TF32 passes or one, as the
    staging's |μ·n| bound lets ops/precision.py:gridder_three_pass_ranks
    choose. `gridder_cuda_v6.launches` counts kernel launches, and
    RANK_COUNTER and PASS_COUNTER each launch (or plain call) by its Taylor
    rank and by its passes a tile."""
    _check_staged(params, stg, w_rank)
    device = stg.device
    three_ranks = gridder_three_pass_ranks(stg.mu_n_bound, w_rank)
    if device.type == "cpu":
        _count(w_rank, three_ranks)
        return gridder_plain(params, stg, w_rank)
    if device.type != "cuda":
        raise ValueError(f"gridder_cuda_v6 runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=True)
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_gridder_v6(
            ptr(stg.uvw), ptr(stg.vis), ptr(stg.mu), ptr(stg.wavenumbers),
            ptr(stg.po_x), ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n),
            ptr(stg.sph), ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(out),
            S, T, C, N, stg.aterms.shape[1], w_rank, three_ranks,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "gridder_cuda_v6")
    gridder_cuda_v6.launches += 1
    _count(w_rank, three_ranks)
    return out


gridder_cuda_v6.launches = 0


@register(
    "gridder", "cuda_v7",
    "w-free specialization: cuda_v6 at rank 1 (drops the w-term correction; "
    "exact for w==0 data); counterpart of pallas_v7",
    family="cuda", fallback="cuda_v4", fixed_w_rank=1,
)
def gridder_cuda_v7(params: IDGParams, stg: Staged):
    """K1 at Taylor rank 1, non-fused; exact for w ≡ 0 observations (every
    in-tree generator). On w ≠ 0 data the API guard falls back to cuda_v4 at
    the rank the observation needs, as JAX's pallas_v7 falls back to
    pallas_v4. K1 has no channel recurrence, so the rung is not marked
    uniform_channels. Its launches count on `gridder_cuda_v6`."""
    return gridder_cuda_v6(params, stg, 1)


def gridder_v6_pieces_plain(params: IDGParams, stg: Staged, oyx: torch.Tensor,
                            w_rank: int = DEFAULT_W_RANK):
    """The fused kernel's function in torch ops: `gridder_plain`, then the
    roll as Fourier phases and the folded-shift inverse DFT as matmuls
    (ops/grid.py:pieces_from_subgrids). Returns c64[S, P, N, N]."""
    return pieces_from_subgrids(gridder_plain(params, stg, w_rank), oyx)


@trace.span("idg.gridder")
def gridder_cuda_v6_pieces(params: IDGParams, stg: Staged, oyx: torch.Tensor,
                           w_rank: int = DEFAULT_W_RANK):
    """`gridder_cuda_v6` with the grid stage's producer fused into the
    epilogue (the counterpart of gridder_pallas_v6_pieces): returns the
    block-rolled image-domain pieces c64[S, P, N, N] that
    ops/grid.py:subgrids_to_grid_ranges(tiles=...) adds into the grid.
    `oyx` is the i32[S, 2] per-subgrid roll (ops/grid.py:roll_offsets) on
    the staging's device. `gridder_cuda_v6_pieces.launches` counts kernel
    launches, and RANK_COUNTER (`idg.w_rank.gridder`) and PASS_COUNTER
    (`idg.w_passes.gridder`) each launch (or plain call) by its Taylor rank
    and by its TF32 passes a tile. While a profiler records, one launch in
    utils/trace.py:PROBE_EVERY runs probed (utils/trace.py:probe)."""
    _check_staged(params, stg, w_rank)
    device = stg.device
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    _check_tensor("oyx", oyx, torch.int32, (S, 2), device)
    three_ranks = gridder_three_pass_ranks(stg.mu_n_bound, w_rank)
    if device.type == "cpu":
        _count(w_rank, three_ranks)
        return gridder_v6_pieces_plain(params, stg, oyx, w_rank)
    if device.type != "cuda":
        raise ValueError(f"gridder_cuda_v6_pieces runs on cpu or cuda, not {device}")
    check_staging(params, stg, with_vis=True)
    out = torch.empty((S, P, N, N), dtype=torch.complex64, device=device)
    if S == 0:
        return out
    wr = dft_split_factors_on(N, True, device)
    probe = trace.probe("gridder_cuda_v6_pieces", device)
    lib = build.library()
    with torch.cuda.device(device):
        rc = lib.idg_gridder_v6_pieces(
            ptr(stg.uvw), ptr(stg.vis), ptr(stg.mu), ptr(stg.wavenumbers),
            ptr(stg.po_x), ptr(stg.po_y), ptr(stg.l), ptr(stg.m), ptr(stg.n),
            ptr(stg.sph), ptr(stg.aterms), ptr(stg.aterm_index), ptr(stg.station1),
            ptr(stg.station2), ptr(oyx), ptr(wr), ptr(out),
            None if probe is None else ptr(probe),
            S, T, C, N, stg.aterms.shape[1], w_rank, three_ranks,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "gridder_cuda_v6_pieces")
    gridder_cuda_v6_pieces.launches += 1
    _count(w_rank, three_ranks)
    return out


gridder_cuda_v6_pieces.launches = 0
