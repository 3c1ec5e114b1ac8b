"""Parity of the sharded pipelines with the single-device composition.

    python -m idg_tpu_torch.parallel.parity [--device cpu|cuda] [--backend gloo]
        [--hier C] [--versions G/D,...] [--checks ...] [--timeslots N] [--out DIR]
    torchrun --standalone --nproc-per-node 4 -m idg_tpu_torch.parallel.parity \\
        --device cpu --hier 2 --out DIR

The counterpart of the JAX package's multi-chip dry run
(`__graft_entry__.py:dryrun_multichip`): on the same small problem (128²
grid, N = 16, 5 stations, T = 16, C = 8), every rank runs the sharded
builders on its rows and holds what it holds against the single-device
composition of the same kernels on the same inputs, and raises on a miss:

  builders        sharded_gridder / sharded_degridder and their staged forms
                  (the subgrids and visibilities of the rank's rows)
  replicated      1. gridder → grid stage → all-reduce (hierarchical on a
                  ("host", "chip") mesh) → extraction → degridder
  scatter-gather  2. the reduce-scatter / all-gather pair: the row-sharded
                  grid and the degridder on the gathered grid
  ranges          3. the per-rank block-sorted range grid stage (the fused
                  gridder into K4 where the version has the fused form), held
                  against the single-device `pipeline --direction grid`
                  recipe on the whole block-sorted observation

Visibilities and subgrids hold the 1e-5 normalized-RMS gate; grids hold a
max-relative 1e-6 (only the order of the sum of partials differs). With
`--out`, each rank writes the gathered global results as
`<versions>_<name>_rank<r>.npy`. Without a launcher the world is one rank.
It measures no time.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

GRID_TOL = 1e-6


def small_params(n_ranks: int, nr_timeslots: int = 4):
    """The dry run's problem: 10 baselines × nr_timeslots subgrids, a grid
    of 16·max(8, n) rows so that its rows divide any mesh size up to it."""
    from ..config import IDGParams

    return IDGParams(grid_size=16 * max(8, n_ranks), subgrid_size=16, nr_stations=5,
                     nr_timeslots=nr_timeslots, nr_timesteps_subgrid=16, nr_channels=8)


def max_rel(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in (got, want))
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def single_device(params, obs, gversion: str, dversion: str, device):
    """The single-device composition on the global observation: subgrids,
    the grid (periodic scatter), visibilities degridded from it (range
    extraction), and the `pipeline --direction grid` recipe's grid on the
    block-sorted observation."""
    import torch

    from ..ops.api import _rank_args, gridded_pipeline_parts
    from ..ops.common import stage
    from ..ops.grid import (grid_to_subgrids_ranges, plan_grid_add_ranges,
                            sort_observation_blocks, subgrids_to_grid, subgrids_to_grid_ranges)
    from ..ops.registry import get_kernel

    g, n = params.grid_size, params.subgrid_size
    gk = get_kernel("gridder", gversion).fn
    dk = get_kernel("degridder", dversion).fn
    grank, drank = _rank_args("gridder", gversion, None), _rank_args("degridder", dversion, None)
    md = obs.metadata
    sub = gk(params, stage(params, obs, device), *grank)
    grid = subgrids_to_grid(sub, md.coord_x, md.coord_y, g, True)
    tiles = grid_to_subgrids_ranges(grid, md.coord_x, md.coord_y, n, True)
    vis = dk(params, stage(params, obs, device, with_vis=False), tiles, *drank)
    sorted_obs, _ = sort_observation_blocks(obs, g, n)
    smd = sorted_obs.metadata
    plan = plan_grid_add_ranges(smd.coord_x, smd.coord_y, g, n)
    pfn, pargs, gfn, _, _ = gridded_pipeline_parts(params, sorted_obs, gversion, None, plan,
                                                   device)
    if pfn is not None:
        grid_ranges = gfn(pfn(*pargs))
    else:
        cx, cy = (torch.as_tensor(np.asarray(c), device=device) for c in (smd.coord_x, smd.coord_y))
        sub_sorted = gk(params, stage(params, sorted_obs, device), *grank)
        grid_ranges = subgrids_to_grid_ranges(sub_sorted, cx, cy, g, plan=plan)
    return {"subgrids": sub, "grid": grid, "tiles": tiles, "vis": vis,
            "grid_ranges": grid_ranges}


def run_checks(params, mesh, device, gversion: str, dversion: str, checks, out_dir=None,
               log=print) -> None:
    """Every check of `checks` for one (gridder, degridder) version pair on
    this rank; raises AssertionError on the first miss."""
    import torch

    from ..data import make_observation
    from ..utils.compare import check_error
    from .distributed import distribute_subgrids, flat_axis_index
    from .sharded import (gather_grid_rows, gather_rows, local_rows, shard_observation,
                          shard_observation_block_sorted, shard_staged_inputs,
                          sharded_degridder, sharded_degridder_staged, sharded_grid_to_degridder,
                          sharded_grid_to_degridder_gather, sharded_gridder,
                          sharded_gridder_staged, sharded_gridder_to_grid)

    obs, _ = make_observation(params)
    s = obs.metadata.nr_subgrids
    ref = single_device(params, obs, gversion, dversion, device)
    rows = local_rows(mesh, s)
    nloc = rows.stop - rows.start
    tag = f"{gversion}-{dversion}"
    rank = flat_axis_index(mesh)

    def save(name, x):
        if out_dir is not None:
            np.save(os.path.join(out_dir, f"{tag}_{name}_rank{rank}.npy"), x.cpu().numpy())

    def hold_rows(name, local, want, gather=True):
        res = check_error(local[:nloc], want[rows], verbose=False)
        log(f"{tag} {name}: rows {rows.start}-{rows.stop} of {s}, mean_error "
            f"{res.mean_error:.3e} {'PASSED' if res.passed else 'FAILED'}")
        assert res.passed, f"{tag} {name}: mean_error {res.mean_error} past the gate"
        if gather and out_dir is not None:
            save(name, gather_rows(local, mesh, s))

    def hold_grid(name, grid, want):
        err = max_rel(grid, want)
        log(f"{tag} {name}: grid max-rel {err:.3e} (tolerance {GRID_TOL:g}) "
            f"{'PASSED' if err < GRID_TOL else 'FAILED'}")
        assert err < GRID_TOL, f"{tag} {name}: grid max-rel {err} past {GRID_TOL}"
        save(name, grid)

    local, s_pad = shard_observation(params, obs, mesh, device)
    if "builders" in checks:
        hold_rows("subgrids", sharded_gridder(params, mesh, gversion)(local), ref["subgrids"])
        tiles = torch.as_tensor(distribute_subgrids(ref["tiles"].cpu().numpy(), mesh, s_pad),
                                device=device)
        hold_rows("vis", sharded_degridder(params, mesh, dversion)(local, tiles), ref["vis"])
        stg, _ = shard_staged_inputs(params, obs, mesh, "gridder", device=device)
        hold_rows("subgrids_staged", sharded_gridder_staged(params, mesh, gversion)(stg),
                  ref["subgrids"])
        stg, sub = shard_staged_inputs(params, obs, mesh, "degridder", ref["tiles"].cpu().numpy(),
                                       device=device)
        hold_rows("vis_staged", sharded_degridder_staged(params, mesh, dversion)(stg, sub),
                  ref["vis"])
    if "replicated" in checks:
        grid = sharded_gridder_to_grid(params, mesh, gversion)(local)
        hold_grid("grid", grid, ref["grid"])
        vis = sharded_grid_to_degridder(params, mesh, dversion)(local, grid)
        hold_rows("vis_replicated", vis, ref["vis"], gather=out_dir is not None)
    if "scatter-gather" in checks:
        block = sharded_gridder_to_grid(params, mesh, gversion, grid_sharded=True)(local)
        hold_grid("grid_sharded", gather_grid_rows(block, mesh), ref["grid"])
        vis = sharded_grid_to_degridder_gather(params, mesh, dversion)(local, block)
        hold_rows("vis_gather", vis, ref["vis"])
    if "ranges" in checks:
        sorted_local, _, plan = shard_observation_block_sorted(params, obs, mesh, device)
        grid = sharded_gridder_to_grid(params, mesh, gversion, grid_method="ranges")(
            sorted_local, plan)
        hold_grid("grid_ranges", grid, ref["grid_ranges"])


CHECKS = ("builders", "replicated", "scatter-gather", "ranges")


def main(argv=None) -> int:
    import torch.distributed as dist

    from .distributed import flat_axis_index, init_distributed, make_hier_mesh
    from .mesh import make_mesh

    ap = argparse.ArgumentParser(prog="python -m idg_tpu_torch.parallel.parity",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    ap.add_argument("--backend", default=None,
                    help="collective backend (default NCCL on cuda, gloo on cpu; gloo on cuda "
                         "lets several ranks share one card)")
    ap.add_argument("--hier", type=int, default=None, metavar="C",
                    help='("host", "chip") mesh of C ranks a host (default: a 1-D mesh)')
    ap.add_argument("--versions", default="cuda_v6/cuda_v7",
                    help="comma-separated gridder/degridder version pairs")
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help=f"comma-separated subset of {', '.join(CHECKS)}")
    ap.add_argument("--timeslots", type=int, default=4,
                    help="subgrids = 10 baselines x timeslots (an odd count pads the tail)")
    ap.add_argument("--out", default=None, help="write each rank's gathered results here")
    args = ap.parse_args(argv)
    checks = args.checks.split(",")
    unknown = set(checks) - set(CHECKS)
    if unknown:
        ap.error(f"unknown checks {sorted(unknown)}")

    device = init_distributed(backend=args.backend, device=args.device)
    mesh = (make_hier_mesh(args.hier, device_type=device.type) if args.hier
            else make_mesh(device_type=device.type))
    world = dist.get_world_size()
    params = small_params(world, args.timeslots)
    rank = flat_axis_index(mesh)
    backend = dist.get_backend()
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    def log(msg):
        print(f"[parity rank {rank}/{world} {backend} {device.type}] {msg}", flush=True)

    log(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, grid {params.grid_size}², "
        f"{params.nr_subgrids} subgrids")
    for pair in args.versions.split(","):
        gversion, dversion = pair.split("/")
        run_checks(params, mesh, device, gversion, dversion, checks, args.out, log)
    dist.barrier()
    log("all checks PASSED")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
