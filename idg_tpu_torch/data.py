"""Deterministic synthetic-observation generators.

The counterpart of ``idg_tpu/data.py``, bit-identical with it: the same
formulas and the same glibc rand() draw order as the reference
(app/common/init.cpp:4-222), seeded like ``srand(0)``
(tests/gridder_common.cpp:88). numpy only; `types.to_device` moves the
result to a device.

Layout note: the reference's correctness harness allocates uvw/visibilities
with **nr_subgrids** rows of T timesteps (tests/gridder_common.cpp:72-74) and
metadata time_offsets that index that flat layout as ``s*T``
(init.cpp:134-159). Axis 0 of uvw/visibilities is the subgrid axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import (
    FREQUENCY_INCREMENT,
    IDGParams,
    SPEED_OF_LIGHT,
    START_FREQUENCY,
)
from .crand import CRand
from .types import Metadata, Observation


def compute_l(x, subgrid_size: int, image_size: float):
    """Direction cosine of pixel column x (app/common/math.hpp:9-13)."""
    return (x + 0.5 - (subgrid_size // 2)) * image_size / subgrid_size


def compute_m(y, subgrid_size: int, image_size: float):
    return compute_l(y, subgrid_size, image_size)


def compute_n(l, m):
    """Stable n = 1 - sqrt(1 - l² - m²) (app/common/math.hpp:16-22)."""
    tmp = l * l + m * m
    return np.where(tmp > 1.0, 1.0, tmp / (1.0 + np.sqrt(np.maximum(0.0, 1.0 - tmp))))


def initialize_uvw(rng: CRand, grid_size: int, nr_rows: int, nr_timesteps: int) -> np.ndarray:
    """Elliptical uv tracks, w=0 (init.cpp:4-25). Returns f32[nr_rows, T, 3]."""
    half = grid_size // 2
    radii = half + rng.uniform_array(2 * nr_rows).reshape(nr_rows, 2) * half
    time = np.arange(nr_timesteps, dtype=np.float64)
    angle = (time + 0.5) / (np.float32(360.0) / nr_timesteps)
    uvw = np.zeros((nr_rows, nr_timesteps, 3), dtype=np.float64)
    uvw[:, :, 0] = radii[:, 0:1] * np.cos(angle * np.pi)[None, :]
    uvw[:, :, 1] = radii[:, 1:2] * np.sin(angle * np.pi)[None, :]
    return uvw.astype(np.float32)


def initialize_frequencies(nr_channels: int) -> np.ndarray:
    """150 MHz + 0.7 MHz/channel (init.cpp:27-36)."""
    return (START_FREQUENCY + FREQUENCY_INCREMENT * np.arange(nr_channels)).astype(np.float32)


def initialize_wavenumbers(frequencies: np.ndarray) -> np.ndarray:
    """k = 2π f / c (init.cpp:38-46)."""
    return (2.0 * np.pi * frequencies.astype(np.float64) / SPEED_OF_LIGHT).astype(np.float32)


def initialize_visibilities(
    grid_size: int, image_size: float, frequencies: np.ndarray, uvw: np.ndarray
) -> np.ndarray:
    """Analytic point source at (0.6, 0.7)·grid offsets (init.cpp:48-79).

    Returns c64[rows, T, C, 4] with the per-pol 1.01/1.02/1.03/1.04 scaling.
    """
    l = 0.6 * grid_size * image_size / grid_size
    m = 0.7 * grid_size * image_size / grid_size
    freq = frequencies.astype(np.float64) / SPEED_OF_LIGHT
    u = freq[None, None, :] * uvw[:, :, 0:1].astype(np.float64)
    v = freq[None, None, :] * uvw[:, :, 1:2].astype(np.float64)
    value = np.exp(-2j * np.pi * (u * l + v * m))
    pol_scale = np.array([1.01, 1.02, 1.03, 1.04], dtype=np.float64)
    return (value[..., None] * pol_scale).astype(np.complex64)


def initialize_baselines(nr_stations: int, nr_baselines: int) -> np.ndarray:
    """All station pairs (s1 < s2), row-major (init.cpp:81-95). i32[B, 2]."""
    pairs = [
        (s1, s2)
        for s1 in range(nr_stations)
        for s2 in range(s1 + 1, nr_stations)
    ][:nr_baselines]
    return np.asarray(pairs, dtype=np.int32).reshape(nr_baselines, 2)


def initialize_spheroidal(subgrid_size: int) -> np.ndarray:
    """Separable |x|·|y| taper (init.cpp:97-107). f32[N, N]."""
    t = np.abs(-1.0 + np.arange(subgrid_size, dtype=np.float64) * 2.0 / subgrid_size)
    return (t[:, None] * t[None, :]).astype(np.float32)


def initialize_aterms(
    rng: CRand, spheroidal: np.ndarray, nr_timeslots: int, nr_stations: int
) -> np.ndarray:
    """Spheroidal-scaled random Jones terms (init.cpp:109-132).

    Returns c64[nr_timeslots, nr_stations, N, N, 4] in xx,xy,yx,yy order.
    """
    n = spheroidal.shape[0]
    count = nr_timeslots * nr_stations * n * n
    scale = 0.8 + rng.uniform_array(count).reshape(nr_timeslots, nr_stations, n, n) * 0.4
    value = spheroidal[None, None, :, :].astype(np.float64) * scale
    aterms = np.empty((nr_timeslots, nr_stations, n, n, 4), dtype=np.complex64)
    aterms[..., 0] = value + 0.1 - 0.1j
    aterms[..., 1] = value - 0.2 + 0.1j
    aterms[..., 2] = value - 0.2 + 0.1j
    aterms[..., 3] = value + 0.1 - 0.1j
    return aterms


def initialize_metadata(
    rng: CRand,
    grid_size: int,
    nr_timeslots: int,
    nr_timesteps_subgrid: int,
    baselines: np.ndarray,
) -> Metadata:
    """Per-subgrid metadata with random subgrid coordinates (init.cpp:134-159)."""
    nr_baselines = baselines.shape[0]
    nr_subgrids = nr_baselines * nr_timeslots
    coords = rng.uniform_array(2 * nr_subgrids).reshape(nr_subgrids, 2) * grid_size
    coords = coords.astype(np.int32)  # C truncation toward zero (values >= 0)
    bl_idx = np.repeat(np.arange(nr_baselines, dtype=np.int32), nr_timeslots)
    ts_idx = np.tile(np.arange(nr_timeslots, dtype=np.int32), nr_baselines)
    time_offset = (
        bl_idx.astype(np.int64) * nr_timeslots * nr_timesteps_subgrid
        + ts_idx.astype(np.int64) * nr_timesteps_subgrid
    ).astype(np.int32)
    zeros = np.zeros(nr_subgrids, dtype=np.int32)
    return Metadata(
        time_offset=time_offset,
        nr_timesteps=np.full(nr_subgrids, nr_timesteps_subgrid, dtype=np.int32),
        aterm_index=zeros,
        station1=baselines[bl_idx, 0],
        station2=baselines[bl_idx, 1],
        coord_x=coords[:, 0],
        coord_y=coords[:, 1],
        coord_z=zeros,
    )


def initialize_subgrids(
    nr_subgrids: int, nr_correlations: int, subgrid_size: int
) -> np.ndarray:
    """Deterministic ramp pattern (init.cpp:161-180). c64[S, P, N, N]."""
    y, x = np.meshgrid(
        np.arange(subgrid_size), np.arange(subgrid_size), indexing="ij"
    )
    real = (y * subgrid_size + x + 1) / (100.0 * subgrid_size * subgrid_size)
    imag = np.arange(nr_correlations, dtype=np.float64) / 10.0
    sub = real[None, :, :] + 1j * imag[:, None, None]
    return np.broadcast_to(sub, (nr_subgrids, nr_correlations, subgrid_size, subgrid_size)).astype(np.complex64)


def uvw_offsets_f64(params: IDGParams, metadata: Metadata):
    """Per-subgrid u/v/w offsets in f64 (init.cpp:182-199 /
    gridder_reference.cpp:33-38): the subgrid-constant phase shared with the
    golden oracle (models/reference.py)."""
    n, g = params.subgrid_size, params.grid_size
    scale = 2.0 * np.pi / params.image_size
    u = (np.asarray(metadata.coord_x, np.float64) + n // 2 - g // 2) * scale
    v = (np.asarray(metadata.coord_y, np.float64) + n // 2 - g // 2) * scale
    w = 2.0 * np.pi * params.w_step * (
        np.asarray(metadata.coord_z, np.float64) + 0.5
    )
    return u, v, w


def lmn_f64(subgrid_size: int, image_size: float):
    """Per-pixel direction cosines in f64 (init.cpp:201-222 /
    math.hpp:9-24): (l[N], m[N], n[N(y), N(x)])."""
    xy = np.arange(subgrid_size, dtype=np.float64)
    l = compute_l(xy, subgrid_size, image_size)
    m = compute_m(xy, subgrid_size, image_size)
    n = compute_n(l[None, :], m[:, None])
    return l, m, n


def make_observation(params: IDGParams, seed: int = 0, include_subgrids: bool = False):
    """Build a full synthetic observation with the reference's srand(0) draw
    order (tests/gridder_common.cpp:88-101): uvw, frequencies, wavenumbers,
    visibilities, baselines, spheroidal, aterms, metadata.

    Returns (Observation, subgrids_or_None).
    """
    rng = CRand(seed)
    S, T = params.nr_subgrids, params.nr_timesteps_subgrid
    uvw = initialize_uvw(rng, params.grid_size, S, T)
    frequencies = initialize_frequencies(params.nr_channels)
    wavenumbers = initialize_wavenumbers(frequencies)
    visibilities = initialize_visibilities(
        params.grid_size, params.image_size, frequencies, uvw
    )
    baselines = initialize_baselines(params.nr_stations, params.nr_baselines)
    spheroidal = initialize_spheroidal(params.subgrid_size)
    aterms = initialize_aterms(
        rng, spheroidal, params.nr_timeslots, params.nr_stations
    )
    metadata = initialize_metadata(
        rng, params.grid_size, params.nr_timeslots, T, baselines
    )
    obs = Observation(
        uvw=uvw,
        wavenumbers=wavenumbers,
        visibilities=visibilities,
        spheroidal=spheroidal,
        aterms=aterms,
        metadata=metadata,
    )
    subgrids = None
    if include_subgrids:
        subgrids = initialize_subgrids(S, params.nr_correlations, params.subgrid_size)
    return obs, subgrids


def make_w_observation(
    params: IDGParams,
    seed: int = 0,
    w_scale: float | None = None,
    include_subgrids: bool = False,
):
    """Nonzero-w synthetic observation with w-plane metadata.

    The reference carries w through w_offset = w_step·(z+0.5)
    (init.cpp:182-199; gridder_reference.cpp:32-39) but every in-tree
    generator leaves w ≡ 0 and z ≡ 0. This generator exercises that path:

    - uvw w tracks: smooth per-row arcs with amplitude ``w_scale`` (default
      4% of the grid half-width);
    - coord_z: per-subgrid w-plane index chosen so w_off ≈ mean(w·k), which
      keeps the residual μ = w_off − w·k small;
    - w_step: if params.w_step == 0, a step spanning the w range in ~4
      planes is chosen and a replaced params is returned.

    Returns (params, Observation, subgrids_or_None). The w tracks take no
    extra rand() draws, so everything else stays draw-for-draw identical
    with `make_observation`.
    """
    obs, subgrids = make_observation(params, seed, include_subgrids)
    S, T = params.nr_subgrids, params.nr_timesteps_subgrid
    if w_scale is None:
        w_scale = 0.04 * (params.grid_size / 2.0)

    uvw = np.array(obs.uvw, dtype=np.float64, copy=True)
    rows = np.arange(S, dtype=np.float64)
    amp = w_scale * (2.0 * ((rows * 0.37 + 0.11) % 1.0) - 1.0)   # [-w_scale, w_scale)
    t = (np.arange(T, dtype=np.float64) + 0.5) / T
    uvw[:, :, 2] = amp[:, None] * np.sin(np.pi * t)[None, :]

    k = np.asarray(obs.wavenumbers, np.float64)
    k_mean = float(k.mean())
    # target w_off per subgrid = mean over its timesteps of w·k̄
    md = obs.metadata
    idx = np.asarray(md.time_offset, np.int64)[:, None] + np.arange(T)[None, :]
    w_flat = uvw[:, :, 2].reshape(-1)
    w_mean = w_flat[idx].mean(axis=1)                             # [S]
    w_off_target = w_mean * k_mean                                 # radians

    w_step = params.w_step
    if w_step == 0.0:
        span = max(float(np.abs(w_off_target).max()), 1e-30) / (2.0 * np.pi)
        w_step = 2.0 * span / 4.0                                  # ~4 planes
        params = dataclasses.replace(params, w_step=float(w_step))
    z = np.round(w_off_target / (2.0 * np.pi * w_step) - 0.5).astype(np.int32)

    obs = dataclasses.replace(
        obs,
        uvw=uvw.astype(np.float32),
        metadata=dataclasses.replace(md, coord_z=z),
    )
    return params, obs, subgrids


def make_perf_observation(params: IDGParams, seed: int = 0) -> Observation:
    """Performance-mode inputs.

    The reference times kernels on *uninitialized device memory* except for
    metadata (app/CUDA/util.cpp:204-231). Defined values are used here, as
    cheap deterministic fills with realistic magnitudes; metadata is
    generated with the same draws the reference makes in perf mode
    (initialize_baselines + initialize_metadata only).
    """
    rng = CRand(seed)
    baselines = initialize_baselines(params.nr_stations, params.nr_baselines)
    metadata = initialize_metadata(
        rng, params.grid_size, params.nr_timeslots, params.nr_timesteps_subgrid, baselines
    )
    S, T, C, P = (
        params.nr_subgrids,
        params.nr_timesteps_subgrid,
        params.nr_channels,
        params.nr_correlations,
    )
    # Cheap structured fills: uv on a coarse ellipse.
    t = np.arange(T, dtype=np.float32) / T
    uvw = np.zeros((S, T, 3), dtype=np.float32)
    radius = (params.grid_size // 2) * (1.0 + ((np.arange(S) % 97) / 97.0)).astype(np.float32)
    uvw[:, :, 0] = radius[:, None] * np.cos(2 * np.pi * t)[None, :]
    uvw[:, :, 1] = radius[:, None] * np.sin(2 * np.pi * t)[None, :]
    frequencies = initialize_frequencies(C)
    wavenumbers = initialize_wavenumbers(frequencies)
    # period-251 phase pattern tiled from one small tile (no S·T·C·P-sized
    # index or phase temporaries)
    total = S * T * C * P
    base = np.arange(251, dtype=np.float32) * np.float32(0.025)
    base_c = (np.cos(base) + 1j * np.sin(base)).astype(np.complex64)
    visibilities = np.tile(base_c, -(-total // 251))[:total].reshape(S, T, C, P)
    spheroidal = initialize_spheroidal(params.subgrid_size)
    n = params.subgrid_size
    aterms = np.ones(
        (params.nr_timeslots, params.nr_stations, n, n, P), dtype=np.complex64
    )
    aterms[..., 1] = 0.25 + 0.1j
    aterms[..., 2] = 0.25 - 0.1j
    return Observation(
        uvw=uvw,
        wavenumbers=wavenumbers,
        visibilities=visibilities,
        spheroidal=spheroidal,
        aterms=aterms,
        metadata=metadata,
    )
