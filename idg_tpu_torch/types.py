"""Core data model: structure-of-arrays observation bundles.

The counterpart of ``idg_tpu/types.py``. Fields hold numpy arrays on the host
or torch tensors on a device (`to_device`). Complex data stays complex64:
the kernels take it as interleaved float2, the reference's own CUDA layout.

Shape conventions (S=nr_subgrids, T=nr_timesteps_subgrid, C=nr_channels,
P=nr_correlations=4, N=subgrid_size; axis 0 of uvw/visibilities is the
subgrid axis, as in the reference's correctness harness):
  uvw            f32[S, T, 3]
  wavenumbers    f32[C]
  visibilities   c64[S, T, C, P]
  spheroidal     f32[N, N]
  aterms         c64[nr_timeslots, nr_stations, N, N, P]   (P = xx,xy,yx,yy)
  subgrids       c64[S, P, N, N]
  metadata       SoA int32 arrays of length S
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

_METADATA_FIELDS = (
    "time_offset", "nr_timesteps", "aterm_index", "station1", "station2",
    "coord_x", "coord_y", "coord_z",
)


@dataclasses.dataclass(frozen=True)
class Metadata:
    """Per-subgrid bookkeeping, SoA (reference AoS: types.hpp:19-26).

    time_offset indexes the flattened time axis of uvw/visibilities, like
    the reference's ``m.baseline_offset - baseline_offset_1 + m.time_offset``
    (app/CPU/kernels/gridder_reference.cpp:23-24).
    """

    time_offset: Any   # i32[S]
    nr_timesteps: Any  # i32[S] (uniform == T in all in-tree setups)
    aterm_index: Any   # i32[S]
    station1: Any      # i32[S]
    station2: Any      # i32[S]
    coord_x: Any       # i32[S]
    coord_y: Any       # i32[S]
    coord_z: Any       # i32[S] (z of the subgrid coordinate; 0 in-tree)

    @property
    def nr_subgrids(self) -> int:
        return int(self.time_offset.shape[0])


@dataclasses.dataclass(frozen=True)
class Observation:
    """One synthetic observation: every input of the gridder/degridder ABI
    (the 13-arg kernel signature, app/CUDA/util.cpp:233-237), minus the
    static scalars which live in IDGParams."""

    uvw: Any           # f32[S, T, 3]
    wavenumbers: Any   # f32[C]
    visibilities: Any  # c64[S, T, C, P]
    spheroidal: Any    # f32[N, N]
    aterms: Any        # c64[ts, stations, N, N, P]
    metadata: Metadata


def from_numpy_observation(obs) -> Observation:
    """The port's Observation from any observation with the same fields
    holding array-likes, such as ``idg_tpu.types.Observation``: the step
    that carries identical inputs from the JAX package into the port."""
    md = obs.metadata
    return Observation(
        uvw=np.asarray(obs.uvw, np.float32),
        wavenumbers=np.asarray(obs.wavenumbers, np.float32),
        visibilities=np.asarray(obs.visibilities, np.complex64),
        spheroidal=np.asarray(obs.spheroidal, np.float32),
        aterms=np.asarray(obs.aterms, np.complex64),
        metadata=Metadata(
            **{f: np.asarray(getattr(md, f), np.int32) for f in _METADATA_FIELDS}
        ),
    )


def to_device(obs: Observation, device) -> Observation:
    """Observation with every field as a tensor on `device`."""
    md = obs.metadata
    return Observation(
        uvw=torch.as_tensor(obs.uvw, dtype=torch.float32, device=device),
        wavenumbers=torch.as_tensor(obs.wavenumbers, dtype=torch.float32, device=device),
        visibilities=torch.as_tensor(obs.visibilities, dtype=torch.complex64, device=device),
        spheroidal=torch.as_tensor(obs.spheroidal, dtype=torch.float32, device=device),
        aterms=torch.as_tensor(obs.aterms, dtype=torch.complex64, device=device),
        metadata=Metadata(
            **{
                f: torch.as_tensor(getattr(md, f), dtype=torch.int32, device=device)
                for f in _METADATA_FIELDS
            }
        ),
    )
