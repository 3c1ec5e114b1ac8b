"""The degridding (predict) pass, in the recipe of ``python -m
idg_tpu_torch pipeline --direction degrid``: a grid in, c64[S, T, C, P]
visibilities out, subgrids in block order.

  program   the range extraction (K5) cuts the grid into pieces (span
            bench.grid_extract), the degridder with its fused DFT prologue
            (K2 with K3) turns them into visibilities (span
            bench.degridder).
  inputs    the observation of inputs.observation, then a complex normal
            model grid c64[P, G, G] drawn on the device.
  expected  reference.degrid_pass, its rows put in block order by the
            benchmark's own sort (home_block_order).
"""

import numpy as np
import torch

from benchmark import costs, inputs, passes, reference


def make_inputs(problem, traffic, seed, device):
    inp, gen = inputs.observation(problem, seed, device)
    inp.grid = inputs.model_grid(problem, gen, device)
    return inp


def build(problem, inp, device) -> passes.Pass:
    """The port's set-up on these inputs, timed by part."""
    from idg_tpu_torch.ops.api import staged_degridder_pieces_chunk_consumers
    from idg_tpu_torch.ops.cuda.grid import grid_extract_cuda
    from idg_tpu_torch.ops.grid import roll_offsets

    g, n = problem.grid_size, problem.subgrid_size
    with passes.SetupClock(device) as clock:
        obs = passes.block_sorted(problem, inp)
        md = obs.metadata
        oyx = roll_offsets(md.coord_x, md.coord_y, g, n)
        clock.planned()
        consumers, _, version = staged_degridder_pieces_chunk_consumers(
            passes.params(problem), obs, oyx=oyx, device=device)
        if consumers is None:
            raise RuntimeError(f"degridder {version} has no fused prologue")
        (consumer,) = consumers
        cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device=device)
                  for c in (md.coord_x, md.coord_y))
    stages = [("bench.grid_extract", lambda grid: grid_extract_cuda(grid, cx, cy, n)),
              ("bench.degridder", consumer)]
    return passes.Pass(stages, inp.grid, clock.plan_s, clock.stage_s, version)


def home_block_order(coord_x, coord_y, grid_size: int, subgrid_size: int) -> np.ndarray:
    """The stable order of subgrids by the grid block that holds their
    corner, row-major: the order in which block-sorted output comes."""
    g, n = grid_size, subgrid_size
    cx = np.asarray(coord_x, np.int64) % g
    cy = np.asarray(coord_y, np.int64) % g
    return np.argsort((cy // n) * (g // n) + cx // n, kind="stable")


def expected(problem, inp, rounding=reference.identity):
    out = reference.degrid_pass(problem, inp, rounding)
    order = home_block_order(inp.metadata["coord_x"], inp.metadata["coord_y"],
                             problem.grid_size, problem.subgrid_size)
    return out[torch.as_tensor(order, device=out.device)]


def pass_flops(problem) -> int:
    return costs.degridder_work(problem).flops
