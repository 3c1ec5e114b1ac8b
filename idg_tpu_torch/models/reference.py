"""Golden-model gridder/degridder (vectorized NumPy, float64).

The counterpart of ``idg_tpu/models/reference.py`` and the oracle for every
kernel of the port, mirroring the reference's OpenMP CPU kernels
(app/CPU/kernels/gridder_reference.cpp:6-114,
app/CPU/kernels/degridder_reference.cpp:6-129) in float64. Every kernel is
compared against it at the reference's 1e-5 normalized-RMS gate
(tests/test_util.hpp:84).

Math (gridder; degridder is the exact adjoint):
  pixel[y,x,pol] = Σ_t Σ_c vis[t,c,pol] · e^{i(phase_offset[y,x] − phase_index[y,x,t]·k_c)}
  then Jones correction A1ᴴ·P·A2 and spheroidal taper.
"""

from __future__ import annotations

import numpy as np

from ..config import IDGParams
from ..data import lmn_f64 as _lmn
from ..data import uvw_offsets_f64 as _uvw_offsets
from ..types import Metadata, Observation


def _gather_time_axis(arr_flat: np.ndarray, time_offset: np.ndarray, T: int):
    """[S,T,...] view of the flat time axis via metadata time offsets."""
    idx = time_offset[:, None].astype(np.int64) + np.arange(T)[None, :]
    return arr_flat[idx]


def _jones(aterms: np.ndarray, metadata: Metadata):
    """Per-subgrid station Jones matrices as [S, N, N, 2, 2] complex128."""
    aidx = np.asarray(metadata.aterm_index)
    a1 = aterms[aidx, np.asarray(metadata.station1)].astype(np.complex128)
    a2 = aterms[aidx, np.asarray(metadata.station2)].astype(np.complex128)
    s = a1.shape[:-1]
    return a1.reshape(*s, 2, 2), a2.reshape(*s, 2, 2)


def gridder_reference(
    params: IDGParams, obs: Observation, chunk: int = 64
) -> np.ndarray:
    """Golden gridder. Returns c64[S, P, N, N]."""
    md = obs.metadata
    S = md.nr_subgrids
    T = params.nr_timesteps_subgrid
    N = params.subgrid_size
    k = np.asarray(obs.wavenumbers, dtype=np.float64)                 # [C]
    l, m, n = _lmn(N, params.image_size)
    u_off, v_off, w_off = _uvw_offsets(params, md)
    uvw = _gather_time_axis(
        np.asarray(obs.uvw, np.float64).reshape(-1, 3), np.asarray(md.time_offset), T
    )                                                                  # [S,T,3]
    vis = _gather_time_axis(
        np.asarray(obs.visibilities, np.complex128).reshape(
            -1, params.nr_channels, params.nr_correlations
        ),
        np.asarray(md.time_offset),
        T,
    )                                                                  # [S,T,C,P]
    a1, a2 = _jones(np.asarray(obs.aterms), md)                        # [S,N,N,2,2]
    sph = np.asarray(obs.spheroidal, np.float64)                       # [N,N]

    out = np.empty((S, params.nr_correlations, N, N), dtype=np.complex64)
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        sl = slice(s0, s1)
        # phase_index[s,t,y,x] = u·l + v·m + w·n
        pi = (
            uvw[sl, :, 0, None, None] * l[None, None, None, :]
            + uvw[sl, :, 1, None, None] * m[None, None, :, None]
            + uvw[sl, :, 2, None, None] * n[None, None, :, :]
        )                                                              # [s,T,N,N]
        po = (
            u_off[sl, None, None] * l[None, None, :]
            + v_off[sl, None, None] * m[None, :, None]
            + w_off[sl, None, None] * n[None, :, :]
        )                                                              # [s,N,N]
        # phase[s,t,c,y,x] = po − pi·k_c ; pixels = Σ_{t,c} vis·e^{i phase}
        phase = po[:, None, None] - pi[:, :, None] * k[None, None, :, None, None]
        phasor = np.exp(1j * phase)                                    # [s,T,C,N,N]
        pixels = np.einsum("stcp,stcyx->syxp", vis[sl], phasor)        # [s,N,N,P]
        pixels = pixels.reshape(*pixels.shape[:-1], 2, 2)
        # A1ᴴ · P · A2, then taper (math.hpp:64-77)
        corrected = np.conj(np.swapaxes(a1[sl], -1, -2)) @ pixels @ a2[sl]
        corrected = corrected.reshape(*corrected.shape[:-2], 4) * sph[None, :, :, None]
        out[sl] = np.moveaxis(corrected, -1, 1).astype(np.complex64)
    return out


def degridder_reference(
    params: IDGParams, obs: Observation, subgrids: np.ndarray, chunk: int = 64
) -> np.ndarray:
    """Golden degridder (adjoint of the gridder). Returns c64[S, T, C, P]."""
    md = obs.metadata
    S = md.nr_subgrids
    T = params.nr_timesteps_subgrid
    N = params.subgrid_size
    C = params.nr_channels
    k = np.asarray(obs.wavenumbers, dtype=np.float64)
    l, m, n = _lmn(N, params.image_size)
    u_off, v_off, w_off = _uvw_offsets(params, md)
    uvw = _gather_time_axis(
        np.asarray(obs.uvw, np.float64).reshape(-1, 3), np.asarray(md.time_offset), T
    )
    a1, a2 = _jones(np.asarray(obs.aterms), md)
    sph = np.asarray(obs.spheroidal, np.float64)

    out = np.empty((S, T, C, params.nr_correlations), dtype=np.complex64)
    sub = np.asarray(subgrids, np.complex128)
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        sl = slice(s0, s1)
        # taper + Jones: P' = A1 · (sph·P) · A2ᴴ (degridder_reference.cpp:35-74)
        pixels = np.moveaxis(sub[sl], 1, -1) * sph[None, :, :, None]   # [s,N,N,P]
        pixels = pixels.reshape(*pixels.shape[:-1], 2, 2)
        corrected = a1[sl] @ pixels @ np.conj(np.swapaxes(a2[sl], -1, -2))
        corrected = corrected.reshape(*corrected.shape[:-2], 4)        # [s,N,N,P]
        pi = (
            uvw[sl, :, 0, None, None] * l[None, None, None, :]
            + uvw[sl, :, 1, None, None] * m[None, None, :, None]
            + uvw[sl, :, 2, None, None] * n[None, None, :, :]
        )
        po = (
            u_off[sl, None, None] * l[None, None, :]
            + v_off[sl, None, None] * m[None, :, None]
            + w_off[sl, None, None] * n[None, :, :]
        )
        # phase[s,t,c,y,x] = pi·k_c − po (degridder_reference.cpp:100-113)
        phase = pi[:, :, None] * k[None, None, :, None, None] - po[:, None, None]
        phasor = np.exp(1j * phase)
        out[sl] = np.einsum("syxp,stcyx->stcp", corrected, phasor).astype(np.complex64)
    return out
