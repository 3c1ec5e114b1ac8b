"""Multi-process distribution on torch.distributed: the world's start-up,
hierarchical (host × chip) meshes, staged reductions and the rank-local
slicing of a global observation. The counterpart of
``idg_tpu/parallel/distributed.py``.

One process per rank, each on one device. NCCL carries CUDA tensors, gloo
CPU tensors (the tier-1 tests spawn gloo worlds on the CPU). A world comes
from a launcher's environment, from explicit arguments, or, with neither,
is a world of one, so that every command runs with or without `torchrun`:

    torchrun --standalone --nproc-per-node 2 -m idg_tpu_torch scaling ...

    from idg_tpu_torch.parallel import distributed as pdist
    dev = pdist.init_distributed(device="cpu")   # env: RANK, WORLD_SIZE, ...
    mesh = pdist.make_hier_mesh()                 # dims ("host", "chip")
    local, s_pad = pdist.distribute_observation(params, obs, mesh)

Every rank passes the same global observation (synthetic data is cheap to
make everywhere); `distribute_observation` keeps only the rank's rows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import IDGParams
from ..types import Observation
from .mesh import default_device_type


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device="cuda") -> torch.device:
    """Start this process's rank of the world and return its device.

    The world is, in this order: the arguments (`init_method`, default
    ``env://``, with `world_size` and `rank`); the variables a launcher such
    as `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT); or,
    with neither, a world of one on an in-process store. The backend is NCCL
    for a CUDA device and gloo otherwise, unless `backend` names one (gloo
    on CUDA tensors: several ranks sharing one card). A CUDA rank takes the
    card LOCAL_RANK modulo the visible count. A backend that fails to start
    raises; nothing falls back to another. Idempotent: a second call returns
    the device and leaves the world as it is."""
    from ..ops.api import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        torch.cuda.init()   # the DeviceMesh keeps a device that is set and initialized
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if world_size is None and init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    return dev


def make_hier_mesh(chips_per_host: int | None = None,
                   axis_names: tuple[str, str] = ("host", "chip"),
                   device_type: str | None = None) -> DeviceMesh:
    """2-D (host × chip) mesh over every rank, row-major: rank r sits at
    (r // chips_per_host, r % chips_per_host). `chips_per_host` defaults to
    the launcher's LOCAL_WORLD_SIZE (ranks on this host, the NVLink/network
    boundary), else the world size (1 × n)."""
    world = dist.get_world_size()
    if chips_per_host is None:
        chips_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % chips_per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {chips_per_host}")
    return init_device_mesh(device_type or default_device_type(),
                            (world // chips_per_host, chips_per_host),
                            mesh_dim_names=axis_names)


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """All mesh dimensions: the subgrid batch shards over their product."""
    return tuple(mesh.mesh_dim_names)


def flat_axis_index(mesh: DeviceMesh, axes: tuple[str, ...] | None = None) -> int | None:
    """This rank's row-major coordinate over `axes` (default: all of the
    mesh's dimensions), or None when the rank is outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    names = data_axes(mesh)
    idx = 0
    for name in axes or names:
        dim = names.index(name)
        idx = idx * mesh.size(dim) + coord[dim]
    return idx


def _real(x: torch.Tensor) -> torch.Tensor:
    """A real view of `x` for the collectives (complex through view_as_real)."""
    return torch.view_as_real(x) if x.is_complex() else x


def hierarchical_psum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum `x` over the mesh in place, inner dimension first: each host's
    chips reduce over NVLink, then one pre-reduced copy a host crosses the
    network (psum over "chip", then over "host"). For a 1-D mesh this is one
    all-reduce. Returns `x`."""
    for name in reversed(data_axes(mesh)):
        dist.all_reduce(_real(x), group=mesh.get_group(name))
    return x


def _local_rows(mesh: DeviceMesh, s_pad: int) -> tuple[int, int]:
    """This rank's contiguous [lo, hi) rows of an axis-0-sharded [s_pad, ...]
    array. Raises for a rank outside the mesh, which holds no shard."""
    idx = flat_axis_index(mesh)
    if idx is None:
        raise ValueError("this rank is outside the mesh and holds no shard of it")
    sl = s_pad // mesh.size()
    return idx * sl, (idx + 1) * sl


def _local_slice(arr, lo: int, hi: int, s: int) -> np.ndarray:
    """Rows [lo, hi) of an unpadded global host array of s rows: the rows
    past s are zeros, made for this shard alone (padding the whole global
    array first would hold twice the visibility volume on every rank).
    C-contiguous, as the kernels take their inputs."""
    arr = np.asarray(arr)
    local = arr[lo:min(hi, s)]
    if hi > s:
        pad = np.zeros((hi - max(lo, s),) + arr.shape[1:], arr.dtype)
        local = np.concatenate([local, pad]) if local.size else pad
    return np.ascontiguousarray(local)


def distribute_observation(params: IDGParams, obs: Observation, mesh: DeviceMesh):
    """This rank's rows of a GLOBAL host observation: (local Observation,
    padded S). The subgrid axis is padded to a multiple of the mesh size;
    the small metadata is padded globally (the padded tail needs its
    canonical time offsets) and then sliced, the per-subgrid arrays are
    sliced and only the tail shard is zero-padded. Time offsets stay
    global: the sharded builders rebase them to the rank's rows
    (`sharded._localize_time_offset`). Host numpy in, host numpy out."""
    from .sharded import _obs_specs, _pad_observation

    s = obs.metadata.nr_subgrids
    md, s_pad = _pad_observation(params, obs.metadata, mesh.size())
    lo, hi = _local_rows(mesh, s_pad)
    local_md = type(md)(**{f.name: np.asarray(getattr(md, f.name))[lo:hi]
                           for f in dataclasses.fields(md)})
    fields = {name: _local_slice(getattr(obs, name), lo, hi, s) for name in _obs_specs()}
    return dataclasses.replace(obs, metadata=local_md, **fields), s_pad


def distribute_subgrids(subgrids, mesh: DeviceMesh, s_pad: int) -> np.ndarray:
    """This rank's rows of the global c64[S, P, N, N] subgrids, padded to
    s_pad rows: the degridder-input companion of distribute_observation
    (the JAX package's distribute_subgrid_pair, on complex subgrids)."""
    lo, hi = _local_rows(mesh, s_pad)
    return _local_slice(np.asarray(subgrids, np.complex64), lo, hi, np.shape(subgrids)[0])


def mesh_max(mesh: DeviceMesh, device) -> Callable[[float], float]:
    """agree(x) -> the maximum of x over the mesh's ranks: an all-reduce of
    one value (the timing's per-window agreement, utils/timing.py:
    time_kernel's `agree`). Every rank of the mesh must call it as often as
    the others."""
    names = data_axes(mesh)

    def agree(x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64, device=device)
        for name in names:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(name))
        return float(t.item())

    return agree
