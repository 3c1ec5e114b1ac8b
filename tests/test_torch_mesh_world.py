"""The local world (idg_tpu_torch/parallel/world.py) and the staged sharded
gridding pass on rank-local rows (parallel/sharded.py), in gloo worlds
started from the test process on the CPU, at a small size: 6 stations × 2
timeslots = 30 subgrids over 4 ranks, blocks of 8, so the last rank holds
6 rows and pads 2.

The pass is the benchmark's own recipe (benchmark/recipes/grid_mesh.py):
every rank makes its rows and draws its visibilities, shards and stages
them through the port, and grids; the grid is held against the float64
reference summed over the ranks (benchmark/reference.py:grid_pass) and
against the one-device pipeline on the whole observation. A planted fault
on one worker and a worker that raises must each be seen by rank 0.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from benchmark import catalog, compare
from idg_tpu_torch.ops.api import gridded_pipeline_parts
from idg_tpu_torch.parallel import world as pworld
from idg_tpu_torch.parallel.distributed import distribute_observation
from idg_tpu_torch.parallel.sharded import local_rows, shard_observation_block_sorted
from idg_tpu_torch.types import Metadata, Observation

PROBLEM = catalog.Problem(grid_size=128, subgrid_size=16, nr_stations=6, nr_timeslots=2,
                          nr_timesteps_subgrid=8, nr_channels=4, nr_correlations=4,
                          image_size=0.01, w_step=0.0)
TRAFFIC = {"recipe": "grid_mesh", "ranks": 4}
SEED = 2**33 + 21
LIMITS = catalog.load_cell("ska-low.grid-mesh4").limits
RECIPE = catalog.load_recipe("grid_mesh")


@pytest.fixture(scope="module", autouse=True)
def _close_the_world():
    yield
    if pworld._WORLD is not None:
        pworld._WORLD.close()


def _world(size=4):
    return pworld.local_world(size, "cpu", timeout_s=60)


def _observation(inp, metadata=None, visibilities=None) -> Observation:
    """The port's Observation of a benchmark Inputs."""
    return Observation(uvw=inp.uvw, wavenumbers=inp.wavenumbers,
                       visibilities=inp.visibilities if visibilities is None else visibilities,
                       spheroidal=inp.spheroidal, aterms=inp.aterms,
                       metadata=Metadata(**(inp.metadata if metadata is None else metadata)))


def _rank_rows(ctx):
    """This rank's own rows, as the recipe made them."""
    inp = ctx.state["inputs"]
    return ctx.state["rows"], inp.metadata, inp.uvw, inp.visibilities


def _rank_matches_global(ctx, problem, seed):
    """The rank-local path against the global-observation path, field for
    field, and their block sort and range plan."""
    from benchmark import inputs

    obs, gen = inputs.observation(problem, seed, "cpu")
    vis = inputs.visibilities(problem, gen, "cpu")
    whole = _observation(obs, visibilities=vis)
    rows = local_rows(ctx.mesh, problem.nr_subgrids)
    mine = _observation(obs, metadata={k: v[rows] for k, v in obs.metadata.items()},
                        visibilities=vis[rows])
    mine = dataclasses.replace(mine, uvw=obs.uvw[rows])
    params = _params(problem)
    a, s_a = distribute_observation(params, whole, ctx.mesh)
    b, s_b = distribute_observation(params, mine, ctx.mesh, problem.nr_subgrids)
    same = s_a == s_b and np.array_equal(a.uvw, b.uvw)
    same &= np.array_equal(np.asarray(a.visibilities), b.visibilities.numpy())
    for f in dataclasses.fields(a.metadata):
        x, y = getattr(a.metadata, f.name), getattr(b.metadata, f.name)
        same &= x.dtype == y.dtype and np.array_equal(x, y)
    sa, _, pa = shard_observation_block_sorted(params, whole, ctx.mesh, "cpu")
    sb, _, pb = shard_observation_block_sorted(params, mine, ctx.mesh, "cpu",
                                               problem.nr_subgrids)
    for f in dataclasses.fields(sa.metadata):
        same &= np.array_equal(getattr(sa.metadata, f.name), getattr(sb.metadata, f.name))
    same &= all(np.array_equal(getattr(pa, k), getattr(pb, k))
                for k in ("starts", "tstarts", "lens"))
    return bool(same), rows.stop - rows.start, int(a.uvw.shape[0])


def _zero_pieces_on(ctx, rank):
    """A planted fault: rank `rank`'s K1 emits zero pieces."""
    if ctx.rank == rank:
        staged = ctx.state["pass"]
        gridder = staged.gridder
        staged.gridder = lambda record=False: torch.zeros_like(gridder(record))


def _heal(ctx):
    ctx.state["pass"].__dict__.pop("gridder", None)


def _raise_on(ctx, rank):
    if ctx.rank == rank:
        raise ValueError(f"planted on rank {rank}")
    t = torch.ones(2)
    dist.all_reduce(t)      # the other ranks wait for the one that raised
    return t


def _raise_while_rank_0_waits(ctx):
    """Rank 1 raises; rank 0's own part waits where no collective breaks
    (as rank 0 does on the card behind an NCCL all-reduce)."""
    if ctx.rank == 1:
        raise ValueError("planted on rank 1")
    time.sleep(300)


def _params(problem):
    from benchmark import passes

    return passes.params(problem)


def _setup(ranks=4):
    """The recipe's inputs and set-up on every rank of the local world."""
    inp = RECIPE.make_inputs(PROBLEM, dict(TRAFFIC, ranks=ranks), SEED, "cpu")
    return inp, RECIPE.build(PROBLEM, inp, "cpu")


def _grid_of_one_device(world) -> torch.Tensor:
    """The one-device pipeline (ops/api.py:gridded_pipeline_parts) on the
    whole observation: the ranks' rows gathered in rank order."""
    from benchmark import inputs, passes
    from idg_tpu_torch.ops.grid import sort_observation_blocks

    parts = world.run(_rank_rows, gather=True)
    assert [p[0] for p in parts] == [(0, 8), (8, 16), (16, 24), (24, 30)]
    obs, _ = inputs.observation(PROBLEM, SEED, "cpu")
    vis = torch.cat([p[3] for p in parts])
    for name in obs.metadata:
        assert np.array_equal(np.concatenate([p[1][name] for p in parts]), obs.metadata[name])
    assert np.array_equal(np.concatenate([p[2] for p in parts]), obs.uvw)
    whole, _ = sort_observation_blocks(_observation(obs, visibilities=vis), PROBLEM.grid_size,
                                       PROBLEM.subgrid_size)
    pfn, pargs, gfn, _, _ = gridded_pipeline_parts(passes.params(PROBLEM), whole, device="cpu")
    return gfn(pfn(*pargs))


def test_world_of_one_is_the_one_device_pipeline_bit_for_bit():
    """At a world of one the staged sharded pass is the pipeline's grid,
    bit for bit, with no collective."""
    from benchmark import inputs, passes
    from idg_tpu_torch.ops.grid import sort_observation_blocks

    live = pworld._WORLD
    if live is not None and live.size != 1:
        live.close()
    try:
        inp, pass_obj = _setup(ranks=1)
        world = inp.world
        grid = pass_obj()
        assert world.size == 1 and not world.procs
        obs, _ = inputs.observation(PROBLEM, SEED, "cpu")
        whole, _ = sort_observation_blocks(_observation(obs, visibilities=inp.visibilities),
                                           PROBLEM.grid_size, PROBLEM.subgrid_size)
        pfn, pargs, gfn, _, _ = gridded_pipeline_parts(passes.params(PROBLEM), whole,
                                                       device="cpu")
        assert torch.equal(grid, gfn(pfn(*pargs)))
    finally:
        pworld._WORLD.close()
    assert not dist.is_initialized()


def test_world_of_four_grids_rank_local_rows():
    """Four gloo ranks, each with its own rows and visibilities: the grid
    against the float64 reference summed over the ranks, and against the
    one-device pipeline on the gathered observation (float32 rounding:
    only the order of the sum differs)."""
    world = _world()
    inp, pass_obj = _setup()
    grid = pass_obj()
    assert len(world.procs) == 3 and all(p.is_alive() for p in world.procs)
    ref = RECIPE.expected(PROBLEM, inp)
    got = compare.numbers(grid, ref)
    assert compare.judge(got, LIMITS) and got["rms_err"] < 1e-5, got
    one = compare.numbers(grid, _grid_of_one_device(world))
    assert one["rms_err"] < 1e-6 and one["max_err"] < 1e-5, one


def test_rank_local_rows_match_the_global_path():
    """distribute_observation and shard_observation_block_sorted on a
    rank's own rows with the global S give, row for row, what the global
    observation gives; the last rank's two padded rows included."""
    got = _world().run(_rank_matches_global, PROBLEM, SEED, gather=True)
    assert got == [(True, 8, 8), (True, 8, 8), (True, 8, 8), (True, 6, 8)]


def _reset_trace(ctx):
    from idg_tpu_torch.utils import trace

    trace.reset()


def test_the_local_pass_counter_is_gathered_from_every_rank():
    """Only while rank 0 traces does every rank time its K1 and K4 into the
    counter idg.mesh.local_pass; rank 0's snapshot gathers each rank's
    median."""
    from torch.profiler import ProfilerActivity, profile

    from idg_tpu_torch.utils import trace

    world = _world()
    _, pass_obj = _setup()
    world.run(_reset_trace)
    pass_obj()
    assert "counters" not in trace.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            pass_obj(spans=True)
    counter = trace.snapshot()["counters"]["idg.mesh.local_pass"]
    assert counter["count"] == 2 and len(counter["ranks"]) == 4
    assert all(m > 0 for m in counter["ranks"]) and counter["ranks"][0] == counter["median_ms"]
    world.run(_reset_trace)


def test_zeroed_pieces_on_one_worker_fail_the_comparison():
    world = _world()
    inp, pass_obj = _setup()
    ref = RECIPE.expected(PROBLEM, inp)
    assert compare.judge(compare.numbers(pass_obj(), ref), LIMITS)
    world.run(_zero_pieces_on, 2)
    bad = compare.numbers(pass_obj(), ref)
    assert not compare.judge(bad, LIMITS) and bad["rms_err"] > 0.1, bad
    world.run(_heal)
    assert compare.judge(compare.numbers(pass_obj(), ref), LIMITS)


def test_worker_that_raises_surfaces_in_rank_0():
    """A worker's exception reaches rank 0 as WorkerError with its
    traceback, within seconds, though the other ranks wait in a collective
    for it; the world is then closed and no worker is left."""
    world = _world()
    t0 = time.monotonic()
    with pytest.raises(pworld.WorkerError, match="planted on rank 3"):
        world.run(_raise_on, 3)
    assert time.monotonic() - t0 < 20
    assert world.closed and not any(p.is_alive() for p in world.procs)
    assert pworld._WORLD is None


WATCHED = """
import sys
sys.path.insert(0, {repo!r})
from idg_tpu_torch.parallel import world as pworld
from tests.test_torch_mesh_world import _raise_while_rank_0_waits
if __name__ == "__main__":
    world = pworld.local_world(2, "cpu", timeout_s=60)
    print("worker", world.procs[0].pid, flush=True)
    world.run(_raise_while_rank_0_waits)
    print("not reached", flush=True)
"""


def test_a_dead_worker_ends_a_rank_0_that_waits_unaware(tmp_path):
    """A worker that dies while rank 0 waits where nothing breaks ends rank
    0's process within EXIT_GRACE_S: exit code 1, the worker's traceback on
    stderr, no worker left."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    script = tmp_path / "watched.py"
    script.write_text(WATCHED.format(repo=str(repo)))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=90, cwd=tmp_path)
    assert out.returncode == 1, (out.stdout, out.stderr)
    assert time.monotonic() - t0 < 60
    assert "planted on rank 1" in out.stderr and "not reached" not in out.stdout
    pid = int(out.stdout.split()[1])
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
