"""The sharded gridding pass of a local world: every rank grids its own rows
of the observation on its own card, and the ranks' grids are summed.

  program   idg_tpu_torch.parallel: the local world (world.local_world,
            rank 0 this process), each rank's own rows block-sorted and
            planned (sharded.shard_observation_block_sorted with the global
            S) and staged once (sharded.sharded_gridder_to_grid_staged).
            A pass runs on every rank: K1 with its fused iDFT, K4 on the
            rank's range plan, the all-reduce of the c64[P, G, G] grid;
            rank 0's parts are the spans bench.gridder, bench.grid_add and
            bench.reduce.
  inputs    every rank makes the observation of inputs.observation, keeps
            its rows (`rows`: a contiguous block of subgrids, which are
            baseline-major, so whole baselines of every timeslot) and draws
            their visibilities c64[rows, T, C, P] on its own device from a
            generator seeded by (seed, rank).
  expected  reference.grid_pass on each rank's rows, on its device, the
            partial grids summed in float64 on rank 0 by a plain
            torch.distributed.reduce (not the program's collectives).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from benchmark import catalog, costs, inputs, passes, reference


def rows(nr_subgrids: int, ranks: int, rank: int) -> tuple:
    """[lo, hi) of the subgrids rank `rank` holds: blocks of ceil(S / ranks)."""
    per = -(-nr_subgrids // ranks)
    lo = min(nr_subgrids, rank * per)
    return lo, min(nr_subgrids, lo + per)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's visibilities, from the run's seed and the rank."""
    ss = np.random.SeedSequence([int(seed) & inputs.SEED_MASK, rank])
    return int(ss.generate_state(1, np.uint64)[0])


@dataclasses.dataclass(frozen=True)
class RowsProblem(catalog.Problem):
    """A configuration's sizes over `rows` of its subgrids."""

    rows: int = 0

    @property
    def nr_subgrids(self) -> int:
        return self.rows


def _rank_inputs(ctx, problem, seed):
    ctx.state.clear()
    obs, _ = inputs.observation(problem, seed, ctx.device)
    lo, hi = rows(problem.nr_subgrids, ctx.size, ctx.rank)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(rank_seed(seed, ctx.rank))
    shape = (hi - lo, problem.nr_timesteps_subgrid, problem.nr_channels,
             problem.nr_correlations)
    vis = torch.randn(shape, generator=gen, device=ctx.device, dtype=torch.complex64)
    ctx.state["inputs"] = dataclasses.replace(
        obs, uvw=np.ascontiguousarray(obs.uvw[lo:hi]),
        metadata={k: np.ascontiguousarray(v[lo:hi]) for k, v in obs.metadata.items()},
        visibilities=vis)
    ctx.state["rows"] = (lo, hi)


def make_inputs(problem, traffic, seed, device):
    """Rank 0's Inputs (its rows), with the local world as `world`."""
    from idg_tpu_torch.parallel.world import local_world

    world = local_world(int(traffic["ranks"]), device)
    world.run(_rank_inputs, problem, seed)
    inp = world.context.state["inputs"]
    inp.world = world
    return inp


def _rank_shard(ctx, problem):
    from idg_tpu_torch.parallel.sharded import shard_observation_block_sorted
    from idg_tpu_torch.types import Metadata, Observation

    inp = ctx.state["inputs"]
    obs = Observation(uvw=inp.uvw, wavenumbers=inp.wavenumbers,
                      visibilities=inp.visibilities, spheroidal=inp.spheroidal,
                      aterms=inp.aterms, metadata=Metadata(**inp.metadata))
    local, _, plan = shard_observation_block_sorted(passes.params(problem), obs, ctx.mesh,
                                                    ctx.device, problem.nr_subgrids)
    ctx.state["sharded"] = (local, plan)


def _rank_stage(ctx, problem):
    from idg_tpu_torch.parallel.sharded import sharded_gridder_to_grid_staged

    local, plan = ctx.state.pop("sharded")
    ctx.state["pass"] = sharded_gridder_to_grid_staged(passes.params(problem), local, plan,
                                                       ctx.mesh)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _rank_pass(ctx, record):
    ctx.state["pass"](record)


def build(problem, inp, device) -> passes.Pass:
    """The port's set-up on every rank, timed by part: the block sort and
    the range plan, then the staging, each to the slowest rank."""
    from idg_tpu_torch.utils.trace import profiling

    world = inp.world
    with passes.SetupClock(device) as clock:
        world.run(_rank_shard, problem)
        clock.planned()
        world.run(_rank_stage, problem)
    staged = world.context.state["pass"]

    def gridder(_):
        record = profiling()
        world.begin(_rank_pass, record)
        return staged.gridder(record)

    def reduce(grid):
        out = staged.reduce(grid)
        world.end()
        return out

    def on_rank0(fn):
        def stage(x):
            try:
                return fn(x)
            except Exception as exc:
                err = world.failure(exc)
                if err is exc:
                    raise
                raise err from exc
        return stage

    stages = [("bench.gridder", on_rank0(gridder)),
              ("bench.grid_add", on_rank0(staged.grid_add)),
              ("bench.reduce", on_rank0(reduce))]
    return passes.Pass(stages, None, clock.plan_s, clock.stage_s, staged.version)


def _rank_expected(ctx, problem, rounding):
    inp = ctx.state["inputs"]
    lo, hi = ctx.state["rows"]
    md = dict(inp.metadata)
    md["time_offset"] = md["time_offset"] - np.int32(lo * problem.nr_timesteps_subgrid)
    part = RowsProblem(**dataclasses.asdict(problem), rows=hi - lo)
    grid = reference.grid_pass(part, dataclasses.replace(inp, metadata=md), rounding)
    dist.reduce(torch.view_as_real(grid), dst=0)
    return grid if ctx.rank == 0 else None


def expected(problem, inp, rounding=reference.identity):
    return inp.world.run(_rank_expected, problem, rounding)


def pass_flops(problem) -> int:
    return costs.gridder_work(problem).flops
