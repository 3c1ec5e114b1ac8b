"""Device meshes over torch.distributed ranks, and the shard-axis padding
helpers: the counterpart of ``idg_tpu/parallel/mesh.py``.

JAX runs one process over N devices; the port runs one process per rank,
each on its own device, so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks, its dimensions
named as JAX's axes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def default_device_type() -> str:
    """The device type of the initialized world: "cuda" under NCCL, "cpu"
    under gloo (a gloo world on CUDA tensors names "cuda" itself)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device_type: str | None = None) -> DeviceMesh:
    """1-D mesh over the first `n_devices` ranks (default: all), as JAX's
    takes the first N devices. The single mesh axis shards the subgrid
    batch, the reference's grid of thread-blocks (`s = blockIdx.x`,
    app/CUDA/kernels/gridder_reference.cu:14) lifted across devices.

    Every rank of the world must call this (making the mesh's group is a
    collective of the world); a rank outside the first `n_devices` gets the
    mesh with no coordinate (`distributed.flat_axis_index` is None) and
    waits for the others at a barrier of the world. Starts a world of one
    (`distributed.init_distributed`) when none is initialized."""
    if not dist.is_initialized():
        from .distributed import init_distributed

        init_distributed(device=device_type or "cuda")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices but the world has {world} ranks")
    return DeviceMesh(device_type or default_device_type(), torch.arange(n),
                      mesh_dim_names=(axis_name,))


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def pad_axis0(arr, target: int) -> np.ndarray:
    """Zero-pad axis 0 of `arr` to length `target` (host-side NumPy)."""
    arr = np.asarray(arr)
    if arr.shape[0] == target:
        return arr
    pad = [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)
