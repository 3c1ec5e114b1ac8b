"""The plain reference of a whole pass, in float64 PyTorch.

Gridding: visibilities → subgrids (the phasor sum of the upstream's CPU
gridder, app/CPU/kernels/gridder_reference.cpp, with its Jones correction
A1ᴴ·P·A2 and taper) → image-domain tiles (fftshift, inverse DFT with 1/N
an axis, fftshift) → periodic scatter-add at each subgrid's corner into
c128[P, G, G]. Degridding is the adjoint: periodic gather of each window,
fftshift, forward DFT, fftshift, taper and A1·P·A2ᴴ, and the phasor sum of
app/CPU/kernels/degridder_reference.cpp → c128[S, T, C, P] in the
subgrids' generated order.

It reads only the benchmark's inputs and works out everything else itself
(direction cosines, phase offsets, DFT matrices, placements). It imports
nothing of the program. `rounding` rounds the operands of every product
(the phasor contraction and both DFT products); the control passes
`tf32` to compute the same passes from TF32 operands.
"""

from __future__ import annotations

import math

import torch

F64, C128 = torch.float64, torch.complex128
PHASOR_BYTES = 1 << 30     # complex128 phasors a block of subgrids may hold


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with each real part rounded to TF32 (10 mantissa bits, nearest,
    ties away from zero, as cvt.rna), in x's dtype."""
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    bits = x.to(torch.float32).view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def lmn(n: int, image_size: float, device):
    """l[x], m[y] and n[y, x] of the subgrid's pixels (app/common/math.hpp)."""
    xy = torch.arange(n, dtype=F64, device=device)
    l = (xy + 0.5 - n // 2) * image_size / n
    m = l
    tmp = l[None, :] ** 2 + m[:, None] ** 2
    nn = torch.where(tmp > 1.0, torch.ones_like(tmp),
                     tmp / (1.0 + torch.sqrt(torch.clamp(1.0 - tmp, min=0.0))))
    return l, m, nn


def dft_matrix(n: int, inverse: bool, device) -> torch.Tensor:
    """c128[n, n], symmetric; the inverse carries 1/n."""
    j = torch.arange(n, dtype=F64, device=device)
    sign = 1.0 if inverse else -1.0
    w = torch.polar(torch.ones(n, n, dtype=F64, device=device),
                    sign * 2.0 * math.pi * torch.outer(j, j) / n)
    return w / n if inverse else w


def shifted_dft(x: torch.Tensor, inverse: bool, rounding) -> torch.Tensor:
    """fftshift → 2-D (inverse) DFT → fftshift over the last two axes, as
    two products with the DFT matrix."""
    n = x.shape[-1]
    w = rounding(dft_matrix(n, inverse, x.device))
    x = torch.roll(x, (n // 2, n // 2), (-2, -1))
    x = torch.matmul(rounding(torch.matmul(w, rounding(x))), w)
    return torch.roll(x, (n // 2, n // 2), (-2, -1))


def _window_index(cy: torch.Tensor, cx: torch.Tensor, n: int, g: int) -> torch.Tensor:
    """i64[s, N, N] flat [G·G] index of each subgrid's window, wrapped."""
    i = torch.arange(n, device=cy.device)
    rows = (cy[:, None] + i) % g
    cols = (cx[:, None] + i) % g
    return rows[:, :, None] * g + cols[:, None, :]


def _jones(aterms: torch.Tensor, md: dict, lo: int, hi: int):
    """The two stations' Jones matrices, c128[s, N, N, 2, 2]."""
    dev = aterms.device
    aidx = torch.as_tensor(md["aterm_index"][lo:hi], dtype=torch.int64, device=dev)
    s1 = torch.as_tensor(md["station1"][lo:hi], dtype=torch.int64, device=dev)
    s2 = torch.as_tensor(md["station2"][lo:hi], dtype=torch.int64, device=dev)
    a1 = aterms[aidx, s1].to(C128)
    a2 = aterms[aidx, s2].to(C128)
    return a1.reshape(*a1.shape[:-1], 2, 2), a2.reshape(*a2.shape[:-1], 2, 2)


class _Geometry:
    """Per-problem constants on the device."""

    def __init__(self, problem, inputs, device):
        p = problem
        self.p = p
        self.n, self.g = p.subgrid_size, p.grid_size
        self.l, self.m, self.nn = lmn(self.n, p.image_size, device)
        self.k = torch.as_tensor(inputs.wavenumbers, device=device).to(F64)
        self.sph = torch.as_tensor(inputs.spheroidal, device=device).to(F64)
        self.uvw = torch.as_tensor(inputs.uvw, device=device).to(F64)
        md = inputs.metadata
        self.md = md
        self.cx = torch.as_tensor(md["coord_x"], dtype=torch.int64, device=device)
        self.cy = torch.as_tensor(md["coord_y"], dtype=torch.int64, device=device)
        self.cz = torch.as_tensor(md["coord_z"], dtype=torch.int64, device=device)
        self.t0 = torch.as_tensor(md["time_offset"], dtype=torch.int64, device=device)
        per = p.nr_timesteps_subgrid * p.nr_channels * self.n * self.n * 16
        self.block = max(1, PHASOR_BYTES // per)

    def phase(self, lo: int, hi: int) -> torch.Tensor:
        """f64[s, T, C, N, N]: offset − index·k (the gridder's sign)."""
        n, g, p = self.n, self.g, self.p
        t = p.nr_timesteps_subgrid
        rows = self.t0[lo:hi, None] + torch.arange(t, device=self.t0.device)
        uvw = self.uvw.reshape(-1, 3)[rows]                            # [s, T, 3]
        index = (uvw[..., 0, None, None] * self.l
                 + uvw[..., 1, None, None] * self.m[:, None]
                 + uvw[..., 2, None, None] * self.nn)                   # [s, T, N, N]
        scale = 2.0 * math.pi / p.image_size
        u_off = (self.cx[lo:hi] + n // 2 - g // 2).to(F64) * scale
        v_off = (self.cy[lo:hi] + n // 2 - g // 2).to(F64) * scale
        w_off = 2.0 * math.pi * p.w_step * (self.cz[lo:hi].to(F64) + 0.5)
        offset = (u_off[:, None, None] * self.l + v_off[:, None, None] * self.m[:, None]
                  + w_off[:, None, None] * self.nn)                     # [s, N, N]
        return offset[:, None, None] - index[:, :, None] * self.k[:, None, None]


def grid_pass(problem, inputs, rounding=identity) -> torch.Tensor:
    """c128[P, G, G]: the gridding pass over every subgrid."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = inputs.aterms.device
    geo = _Geometry(problem, inputs, dev)
    p, n, g = problem.nr_correlations, geo.n, geo.g
    t, c = problem.nr_timesteps_subgrid, problem.nr_channels
    grid = torch.zeros((p, g * g), dtype=C128, device=dev)
    vis_all = inputs.visibilities
    for lo in range(0, problem.nr_subgrids, geo.block):
        hi = min(lo + geo.block, problem.nr_subgrids)
        s = hi - lo
        phasor = torch.polar(torch.ones((), dtype=F64, device=dev), geo.phase(lo, hi))
        vis = vis_all[lo:hi].to(C128).reshape(s, t * c, p).transpose(1, 2)
        pix = torch.bmm(rounding(vis), rounding(phasor.reshape(s, t * c, n * n)))
        del phasor
        pix = pix.permute(0, 2, 1).reshape(s, n, n, 2, 2)            # [s, y, x, 2, 2]
        a1, a2 = _jones(inputs.aterms, geo.md, lo, hi)
        pix = a1.conj().transpose(-1, -2) @ pix @ a2
        sub = pix.reshape(s, n, n, p).permute(0, 3, 1, 2) * geo.sph   # [s, P, N, N]
        tiles = shifted_dft(sub, True, rounding)
        idx = _window_index(geo.cy[lo:hi], geo.cx[lo:hi], n, g).reshape(-1)
        for pol in range(p):
            torch.view_as_real(grid[pol]).index_add_(
                0, idx, torch.view_as_real(tiles[:, pol].reshape(-1)))
    return grid.reshape(p, g, g)


def degrid_pass(problem, inputs, rounding=identity) -> torch.Tensor:
    """c128[S, T, C, P]: the degridding pass, subgrids in generated order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = inputs.aterms.device
    geo = _Geometry(problem, inputs, dev)
    p, n, g = problem.nr_correlations, geo.n, geo.g
    t, c = problem.nr_timesteps_subgrid, problem.nr_channels
    flat = inputs.grid.reshape(p, g * g)
    out = torch.empty((problem.nr_subgrids, t, c, p), dtype=C128, device=dev)
    for lo in range(0, problem.nr_subgrids, geo.block):
        hi = min(lo + geo.block, problem.nr_subgrids)
        s = hi - lo
        idx = _window_index(geo.cy[lo:hi], geo.cx[lo:hi], n, g)
        tiles = flat[:, idx].permute(1, 0, 2, 3).to(C128)              # [s, P, N, N]
        sub = shifted_dft(tiles, False, rounding) * geo.sph
        pix = sub.permute(0, 2, 3, 1).reshape(s, n, n, 2, 2)
        a1, a2 = _jones(inputs.aterms, geo.md, lo, hi)
        pix = (a1 @ pix @ a2.conj().transpose(-1, -2)).reshape(s, n * n, p)
        phasor = torch.polar(torch.ones((), dtype=F64, device=dev), -geo.phase(lo, hi))
        vis = torch.bmm(rounding(phasor.reshape(s, t * c, n * n)), rounding(pix))
        out[lo:hi] = vis.reshape(s, t, c, p)
    return out

