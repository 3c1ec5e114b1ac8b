"""The one input generator: a configuration's sizes and a seed make every
input of a pass, on the host where the port's set-up reads them there and
on the device in a few large draws where they are large.

The formulas are the upstream generator's (ska-sdp-idg-bench
app/common/init.cpp): elliptical uv tracks (:4-25), 150 MHz + 0.7 MHz a
channel (:27-46), all station pairs (:81-95), the |x|·|y| spheroidal
(:97-107), spheroidal-scaled random Jones terms (:109-132), a random
subgrid corner per (baseline, timeslot) (:134-159). The draws are numpy's
and torch's, from the seed: the seed moves the tracks, the corners (and so
the grid plan), the Jones terms and the visibilities or the input grid,
never a size.

w = 0 on every track, as the upstream generator has. A recipe
(recipes/<name>.py) takes the observation and draws its own payload from
the same generators: `visibilities` or `model_grid` here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0
START_FREQUENCY = 150.0e6
FREQUENCY_INCREMENT = 0.7e6
SEED_MASK = (1 << 64) - 1


@dataclasses.dataclass
class Inputs:
    """Every input of a pass, in the subgrids' generated order. Host arrays
    are numpy; `visibilities`, `grid` and `aterms` are tensors on the run's
    device."""

    uvw: np.ndarray              # f32[S, T, 3]
    wavenumbers: np.ndarray      # f32[C]
    spheroidal: np.ndarray       # f32[N, N]
    aterms: torch.Tensor         # c64[timeslots, stations, N, N, 4]
    metadata: dict               # name -> i32[S]
    visibilities: torch.Tensor | None = None   # c64[S, T, C, P] (the grid recipe)
    grid: torch.Tensor | None = None           # c64[P, G, G] (the degrid recipe)


def seed_generators(seed: int, device) -> tuple:
    """(numpy Generator, torch Generator on `device`) from one seed of any
    size or sign."""
    s = int(seed) & SEED_MASK
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    return np.random.default_rng(s), gen


def wavenumbers(nr_channels: int) -> np.ndarray:
    f = START_FREQUENCY + FREQUENCY_INCREMENT * np.arange(nr_channels, dtype=np.float64)
    return (2.0 * np.pi * f / SPEED_OF_LIGHT).astype(np.float32)


def spheroidal(n: int) -> np.ndarray:
    t = np.abs(-1.0 + np.arange(n, dtype=np.float64) * 2.0 / n)
    return (t[:, None] * t[None, :]).astype(np.float32)


def metadata(problem, rng: np.random.Generator) -> dict:
    """One subgrid per (baseline, timeslot), baseline-major; time offsets
    canonical (s·T); the Jones terms of the subgrid's timeslot; a random
    corner in [0, G)² (windows past the edge wrap)."""
    st, ts, t = problem.nr_stations, problem.nr_timeslots, problem.nr_timesteps_subgrid
    s1, s2 = np.triu_indices(st, k=1)
    b = s1.shape[0]
    bl = np.repeat(np.arange(b), ts)
    slot = np.tile(np.arange(ts), b)
    s = b * ts
    corners = (rng.random((s, 2)) * problem.grid_size).astype(np.int32)
    zeros = np.zeros(s, np.int32)
    return dict(
        time_offset=(np.arange(s, dtype=np.int64) * t).astype(np.int32),
        nr_timesteps=np.full(s, t, np.int32),
        aterm_index=slot.astype(np.int32),
        station1=s1[bl].astype(np.int32),
        station2=s2[bl].astype(np.int32),
        coord_x=corners[:, 0],
        coord_y=corners[:, 1],
        coord_z=zeros,
    )


def uvw_tracks(problem, rng: np.random.Generator) -> np.ndarray:
    """f32[S, T, 3]: per subgrid an ellipse with random radii in
    [G/2, G) (init.cpp:4-25's angles), w = 0."""
    s, t, g = problem.nr_subgrids, problem.nr_timesteps_subgrid, problem.grid_size
    radii = g / 2 + rng.random((s, 2)) * (g / 2)
    angle = (np.arange(t) + 0.5) / (360.0 / t) * np.pi
    uvw = np.zeros((s, t, 3), np.float64)
    uvw[:, :, 0] = radii[:, :1] * np.cos(angle)
    uvw[:, :, 1] = radii[:, 1:] * np.sin(angle)
    return uvw.astype(np.float32)


def aterms(problem, sph: np.ndarray, gen: torch.Generator, device) -> torch.Tensor:
    """c64[timeslots, stations, N, N, 4]: sph·U(0.8, 1.2) plus the upstream's
    per-pol constants (init.cpp:109-132)."""
    ts, st, n = problem.nr_timeslots, problem.nr_stations, problem.subgrid_size
    scale = torch.rand((ts, st, n, n, 1), generator=gen, device=device) * 0.4 + 0.8
    value = torch.as_tensor(sph, device=device)[:, :, None] * scale
    offset = torch.tensor([0.1 - 0.1j, -0.2 + 0.1j, -0.2 + 0.1j, 0.1 - 0.1j],
                          dtype=torch.complex64, device=device)
    return value.to(torch.complex64) + offset


def observation(problem, seed: int, device) -> tuple:
    """(Inputs without a payload, torch Generator to draw it from): the
    metadata, uv tracks and Jones terms of one cell from the seed."""
    device = torch.device(device)
    rng, gen = seed_generators(seed, device)
    md = metadata(problem, rng)
    uvw = uvw_tracks(problem, rng)
    sph = spheroidal(problem.subgrid_size)
    inputs = Inputs(uvw=uvw, wavenumbers=wavenumbers(problem.nr_channels), spheroidal=sph,
                    aterms=aterms(problem, sph, gen, device), metadata=md)
    return inputs, gen


def visibilities(problem, gen: torch.Generator, device) -> torch.Tensor:
    """c64[S, T, C, P] standard complex normal."""
    shape = (problem.nr_subgrids, problem.nr_timesteps_subgrid, problem.nr_channels,
             problem.nr_correlations)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.complex64)


def model_grid(problem, gen: torch.Generator, device) -> torch.Tensor:
    """c64[P, G, G] standard complex normal."""
    g = problem.grid_size
    return torch.randn((problem.nr_correlations, g, g), generator=gen, device=device,
                       dtype=torch.complex64)
