"""Multi-device distribution layer on torch.distributed.

The reference is single-GPU (device 0 hardcoded, app/CUDA/util.cpp:19); its
only parallelism is one thread-block per subgrid. The JAX package shards
that axis, the subgrid batch, over a `jax.sharding.Mesh` under `shard_map`
and accumulates the master grid with XLA collectives. Here each rank is one
process on one device (NCCL between cards, gloo on CPU ranks): it holds its
rows of the subgrid batch, runs the port's single-device code on them, and
the master grid is reduced with `all_reduce` / `reduce_scatter_tensor` /
`all_gather_into_tensor` over a `DeviceMesh` whose dimensions keep JAX's
axis names. The parity entry is `python -m idg_tpu_torch.parallel.parity`.
"""

from .distributed import (
    distribute_observation,
    hierarchical_psum,
    init_distributed,
    make_hier_mesh,
)
from .mesh import make_mesh, pad_to_multiple
from .sharded import (
    sharded_degridder,
    sharded_grid_to_degridder,
    sharded_grid_to_degridder_gather,
    sharded_gridder,
    sharded_gridder_to_grid,
)

__all__ = [
    "distribute_observation",
    "hierarchical_psum",
    "init_distributed",
    "make_hier_mesh",
    "make_mesh",
    "pad_to_multiple",
    "sharded_gridder",
    "sharded_degridder",
    "sharded_grid_to_degridder",
    "sharded_grid_to_degridder_gather",
    "sharded_gridder_to_grid",
]
