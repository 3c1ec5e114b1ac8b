"""Shared kernel-side math and the staging the two CUDA kernels read.

The counterpart of ``idg_tpu/ops/common.py`` and of the part of
``idg_tpu/ops/pallas/common.py:stage`` that the gridder and degridder
kernels need, in torch on an explicit device.

Numerical design (kept from the JAX package): the phase
  phase = phase_offset − phase_index·k
has a large subgrid-constant part, phase_offset = u_off·l + v_off·m + w_off·n,
that reaches ~1.6e3 rad. But
  u_off·l_x = 2π · ix · (x + 0.5 − N/2) / N,   ix = coord_x + N/2 − G/2 ∈ ℤ
so its u/v part is reduced mod 2π exactly in integer arithmetic, split per
axis (`phase_offset_parts`), and every f32 sincos argument stays small
(|phase_index·k| ≲ 35 rad at the reference's scales).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import IDGParams
from ..types import Metadata, Observation

TWO_PI = 2.0 * math.pi
MAX_W_RANK = 6   # highest Taylor rank of e^{iμn} the kernels take


def lmn_grids(subgrid_size: int, image_size: float, device=None):
    """l[N] (x axis), m[N] (y axis), n[N(y), N(x)] in f32 (math.hpp:9-24)."""
    xy = torch.arange(subgrid_size, dtype=torch.float32, device=device)
    l = (xy + 0.5 - subgrid_size // 2) * np.float32(image_size / subgrid_size)
    m = l.clone()
    tmp = l[None, :] ** 2 + m[:, None] ** 2
    n = torch.where(
        tmp > 1.0,
        torch.ones_like(tmp),
        tmp / (1.0 + torch.sqrt(torch.clamp(1.0 - tmp, min=0.0))),
    )
    return l, m, n


def canonical_time_offsets(metadata: Metadata, nr_timesteps: int) -> bool:
    """True iff time_offset[s] == s·T, the layout every in-tree generator
    produces (init.cpp:134-159). Host-side check on numpy metadata; lets
    staging skip the flat-time gather."""
    off = np.asarray(metadata.time_offset)
    if off.ndim != 1:
        return False
    return bool(
        np.array_equal(off, np.arange(off.shape[0], dtype=np.int64) * nr_timesteps)
    )


def gather_time(flat: torch.Tensor, time_offset: torch.Tensor, nr_timesteps: int):
    """[S, T, ...] gather of a flat time axis via metadata offsets
    (gridder_reference.cpp:55-58 ``uvw[time_offset + time]``)."""
    idx = time_offset.to(torch.int64)[:, None] + torch.arange(
        nr_timesteps, dtype=torch.int64, device=flat.device
    )
    return flat[idx]


def phase_offset_parts(params: IDGParams, metadata: Metadata):
    """Separable split of the exact phase offset: po ≡ po_x[s,x] + po_y[s,y]
    (mod 2π), each part reduced mod 2π in integer arithmetic, f32[S, N]
    each. e^{i·po} = e^{i·po_x}·e^{i·po_y} wherever the mod falls, so the
    factorization is exact. The w_step part rides in μ (`w_offset_scalar`)
    for the separable kernels, and in w_off·n for the direct ones."""
    N, G = params.subgrid_size, params.grid_size
    ix = metadata.coord_x.to(torch.int64) + (N // 2 - G // 2)
    iy = metadata.coord_y.to(torch.int64) + (N // 2 - G // 2)
    span = 2 * torch.arange(N, dtype=torch.int64, device=ix.device) - (N - 1)
    qx = torch.remainder(ix[:, None] * span[None, :], 2 * N)
    qy = torch.remainder(iy[:, None] * span[None, :], 2 * N)
    scale = np.float32(math.pi / N)
    return qx.to(torch.float32) * scale, qy.to(torch.float32) * scale


def phase_offset_exact(params: IDGParams, metadata):
    """Subgrid-constant phase offset u_off·l + v_off·m + w_off·n, f32[S, N, N]
    (y, x), for the full-phase formulations (idg_tpu/ops/common.py:46-68):
    its u/v part from ONE integer remainder (ix·span_x + iy·span_y) mod 2N,
    then + w_off·n, un-reduced (reducing w_off before multiplying by the
    non-integer n would shift the phase by 2πk·n). `metadata` is anything
    with coord_x, coord_y and coord_z tensors: a torch Metadata, or a
    Staged. The sum of the per-axis parts (`phase_offset_parts`) is the
    same angle mod 2π with other float32 roundings."""
    N, G = params.subgrid_size, params.grid_size
    ix = metadata.coord_x.to(torch.int64) + (N // 2 - G // 2)
    iy = metadata.coord_y.to(torch.int64) + (N // 2 - G // 2)
    span = 2 * torch.arange(N, dtype=torch.int64, device=ix.device) - (N - 1)
    q = ix[:, None, None] * span[None, None, :] + iy[:, None, None] * span[None, :, None]
    po = torch.remainder(q, 2 * N).to(torch.float32) * np.float32(math.pi / N)
    if params.w_step != 0.0:
        _, _, n = lmn_grids(N, params.image_size, ix.device)
        po = po + w_offset_scalar(params, metadata)[:, None, None] * n
    return po


def phase_index(uvw: torch.Tensor, l: torch.Tensor, m: torch.Tensor, n: torch.Tensor):
    """phase_index[..., T, N, N] = u·l + v·m + w·n from uvw[..., T, 3]
    (gridder_reference.cpp:61; idg_tpu/ops/common.py:102-109)."""
    return (uvw[..., 0, None, None] * l
            + uvw[..., 1, None, None] * m[:, None]
            + uvw[..., 2, None, None] * n)


def w_offset_scalar(params: IDGParams, metadata: Metadata):
    """Per-subgrid w offset 2π·w_step·(z+0.5) (gridder_reference.cpp:38),
    f32[S]. Zero at the reference's compile-time W_STEP=0."""
    return np.float32(TWO_PI * params.w_step) * (
        metadata.coord_z.to(torch.float32) + 0.5
    )


def n_powers(n: torch.Tensor, w_rank: int):
    """[1, n, n², …] prefactors of the e^{iμ·n} Taylor ranks; the 1/r! lives
    in the per-visibility coefficient."""
    powers = [torch.ones_like(n)]
    for _ in range(1, w_rank):
        powers.append(powers[-1] * n)
    return powers


def uniform_channel_spacing(wavenumbers) -> bool:
    """True if the wavenumbers are uniformly spaced up to f32 quantization:
    deviations up to 4 ulp(max|k|) from the best uniform fit pass, real
    non-uniform spacing does not (host-side check)."""
    k = np.asarray(wavenumbers, dtype=np.float64).ravel()
    if k.size < 3:
        return True
    c = np.arange(k.size, dtype=np.float64)
    dbar = (k[-1] - k[0]) / (k.size - 1)
    dev = float(np.abs(k - (k[0] + c * dbar)).max())
    ulp = float(np.spacing(np.float32(np.abs(k).max())))
    return dev <= 4.0 * ulp


@dataclasses.dataclass(frozen=True)
class Staged:
    """What the gridder and degridder kernels read, on one device.

    V = T·C visibilities per subgrid in t-major order (v = t·C + c), the
    natural order of the [S, T, C, P] visibility array.
    """

    uvw: torch.Tensor            # f32[S, T, 3]
    vis: torch.Tensor | None     # c64[S, T, C, P] (gridder input only)
    mu: torch.Tensor             # f32[S, T, C]  μ = w_off − w·k_c
    w_off: torch.Tensor          # f32[S]  2π·w_step·(z+0.5) (the direct kernels' w_off·n)
    wavenumbers: torch.Tensor    # f32[C]
    po_x: torch.Tensor           # f32[S, N]
    po_y: torch.Tensor           # f32[S, N]
    l: torch.Tensor              # f32[N]
    m: torch.Tensor              # f32[N]
    n: torch.Tensor              # f32[N, N] (n[y, x])
    sph: torch.Tensor            # f32[N, N]
    aterms: torch.Tensor         # c64[ts, st, N, N, P]
    aterm_index: torch.Tensor    # i32[S]
    station1: torch.Tensor       # i32[S]
    station2: torch.Tensor       # i32[S]
    coord_x: torch.Tensor        # i32[S] (the full-phase formulations' `phase_offset_exact`)
    coord_y: torch.Tensor        # i32[S]
    coord_z: torch.Tensor        # i32[S]

    @property
    def device(self) -> torch.device:
        return self.uvw.device

    @property
    def nr_subgrids(self) -> int:
        return self.uvw.shape[0]


def _check_indices(params: IDGParams, obs: Observation) -> None:
    """Host-side bounds check of the metadata the kernels index with: a
    CUDA kernel does not check, so a bad index would read out of bounds."""
    md = obs.metadata
    ts, st = obs.aterms.shape[:2]
    rows = obs.uvw.reshape(-1, 3).shape[0]
    checks = (
        ("aterm_index", md.aterm_index, ts),
        ("station1", md.station1, st),
        ("station2", md.station2, st),
        ("time_offset", md.time_offset, rows - params.nr_timesteps_subgrid + 1),
    )
    for name, arr, hi in checks:
        arr = np.asarray(arr)
        if arr.size and (arr.min() < 0 or arr.max() >= hi):
            raise ValueError(f"metadata {name} out of range [0, {hi})")


def stage(params: IDGParams, obs: Observation, device, with_vis: bool = True) -> Staged:
    """Stage an observation on `device` for the kernels. Its metadata is
    host numpy; its arrays are host numpy or tensors, those already on
    `device` in their dtype taken without a copy (the sharded builders'
    rank-local rows, parallel/sharded.py).

    Gathers the per-subgrid time windows (skipped when the layout is
    canonical), forms μ = w_off − w·k and the exact phase-offset parts.
    `with_vis=False` leaves the visibilities behind: the degridder has no
    visibility input, and at the default problem they are 1.6 GB."""
    _check_indices(params, obs)
    device = torch.device(device)
    md = obs.metadata
    T, C, P = params.nr_timesteps_subgrid, params.nr_channels, params.nr_correlations
    S = md.nr_subgrids
    tmd = Metadata(**{
        f.name: torch.as_tensor(np.asarray(getattr(md, f.name)), dtype=torch.int32,
                                device=device)
        for f in dataclasses.fields(Metadata)
    })
    uvw_flat = torch.as_tensor(obs.uvw, dtype=torch.float32, device=device).reshape(-1, 3)
    vis_flat = None
    if with_vis:
        vis_flat = torch.as_tensor(
            obs.visibilities, dtype=torch.complex64, device=device
        ).reshape(-1, C, P)
    if canonical_time_offsets(md, T):
        uvw = uvw_flat.reshape(-1, T, 3)[:S]
        vis = vis_flat.reshape(-1, T, C, P)[:S] if with_vis else None
    else:
        uvw = gather_time(uvw_flat, tmd.time_offset, T)
        vis = gather_time(vis_flat, tmd.time_offset, T) if with_vis else None
    k = torch.as_tensor(obs.wavenumbers, dtype=torch.float32, device=device)
    w_off = w_offset_scalar(params, tmd)
    mu = w_off[:, None, None] - uvw[:, :, 2, None] * k[None, None, :]
    po_x, po_y = phase_offset_parts(params, tmd)
    l, m, n = lmn_grids(params.subgrid_size, params.image_size, device)
    return Staged(
        uvw=uvw.contiguous(),
        vis=vis.contiguous() if with_vis else None,
        mu=mu.contiguous(),
        w_off=w_off,
        wavenumbers=k,
        po_x=po_x.contiguous(),
        po_y=po_y.contiguous(),
        l=l,
        m=m,
        n=n.contiguous(),
        sph=torch.as_tensor(obs.spheroidal, dtype=torch.float32, device=device),
        aterms=torch.as_tensor(obs.aterms, dtype=torch.complex64, device=device),
        aterm_index=tmd.aterm_index,
        station1=tmd.station1,
        station2=tmd.station2,
        coord_x=tmd.coord_x,
        coord_y=tmd.coord_y,
        coord_z=tmd.coord_z,
    )


def slice_staged(stg: Staged, lo: int, hi: int) -> Staged:
    """The subgrids [lo, hi) of a staging (shared planes pass through)."""
    per_subgrid = ("uvw", "vis", "mu", "w_off", "po_x", "po_y",
                   "aterm_index", "station1", "station2", "coord_x", "coord_y", "coord_z")
    return dataclasses.replace(stg, **{
        name: getattr(stg, name)[lo:hi].contiguous()
        for name in per_subgrid if getattr(stg, name) is not None
    })
