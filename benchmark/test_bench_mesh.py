"""The cell ska-low.grid-mesh4 on the CPU: its recipe (recipes/grid_mesh.py)
through the harness on a tiny ska1-low problem with gloo workers, its four
readers (metrics/mesh_*.py, metrics/port_mesh_setup_s.py) on synthetic
contexts, and the worker processes free of JAX and the JAX package."""

import json
import math
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import catalog, harness, mesh, port
from benchmark.conftest import tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "ska-low.grid-mesh4"
READERS = ("mesh_gridder_roofline", "mesh_reduce_roofline", "mesh_rank_skew_pct",
           "port_mesh_setup_s")


def worker_banned(ctx):
    """A rank's loaded modules that the benchmark bans (a world call)."""
    return harness.banned_modules()


@pytest.fixture
def closed_world():
    """No local world before the test, none after it."""
    from idg_tpu_torch.parallel import world

    if world._WORLD is not None:
        world._WORLD.close()
    yield world
    if world._WORLD is not None:
        world._WORLD.close()


def test_the_cell_reports_its_four_metrics_and_no_other():
    cell = catalog.load_cell(CELL)
    assert cell.chips == 4 and cell.traffic["ranks"] == 4
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    p = cell.problem
    assert (p.nr_baselines, p.nr_subgrids, p.nr_visibilities) == (130_816, 1_046_528,
                                                                  2_143_289_344)
    assert p.nr_subgrids % 4 == 0


def test_the_recipe_through_the_harness(closed_world, quiet):
    res = harness.run(CELL, 2**33 + 7, 0.05, False, device="cpu", cell=tiny_cell(CELL),
                      log=quiet)
    assert res["correct"] and res["attempted"] >= 1, res
    assert closed_world._WORLD.size == 4
    assert all(p.is_alive() for p in closed_world._WORLD.procs)


def test_a_traced_run_reports_the_four_metrics(closed_world, quiet, monkeypatch):
    """Under a CPU profiler (so the ranks keep their counter) with a
    synthetic device summary standing in for the card's trace: all four
    metrics are in the line."""
    from torch.profiler import ProfilerActivity, profile

    from idg_tpu_torch.utils import trace

    def traced(run_pass, seconds, device, keep_at):
        with profile(activities=[ProfilerActivity.CPU]):
            window = harness.run_window(run_pass, seconds, device, keep_at)
        n = window.passes
        summary = dict(spans={"bench.gridder": (n * 4e-3, n), "bench.grid_add": (n * 1e-4, n),
                              "bench.reduce": (n * 2e-4, n)},
                       ops=[], stream=dict(span_s=1.0), busy_s=1.0, window_s=1.0,
                       idle_by_host=[])
        return window, summary

    monkeypatch.setattr(harness, "traced", traced)
    trace.reset()
    res = harness.run(CELL, 2**33 + 9, 0.05, True, device="cpu", cell=tiny_cell(CELL), log=quiet)
    assert set(res["metrics"]) == set(READERS), res["metrics"]
    assert all(m["value"] >= 0 for m in res["metrics"].values())
    assert res["metrics"]["port_mesh_setup_s"]["value"] > 0
    json.dumps(res)
    trace.reset()


def _ctx(spans=None, ops=(), rows=261_632):
    problem = catalog.load_cell(CELL).problem
    spans = spans or {}

    def span_seconds(name):
        total, count = spans.get(name, (0.0, 0))
        return total / count if count and total > 0 else None

    return SimpleNamespace(problem=problem, metadata={"coord_x": [0] * rows},
                           trace={"spans": spans, "ops": list(ops)},
                           span_seconds=span_seconds)


def test_rooflines_on_a_synthetic_context():
    """K1 on a quarter of the work; the all-reduce of the 2.15 GB grid,
    3/4 of it each way at 450 GB/s, over the span's device time."""
    from benchmark import costs

    ctx = _ctx({"bench.gridder": (0.8, 2), "bench.reduce": (0.02, 2)})
    quarter = costs.gridder_work(ctx.problem).bound_seconds() / 4
    read = catalog.load_reader
    assert read("mesh_gridder_roofline")(ctx) == pytest.approx(100 * quarter / 0.4, rel=1e-6)
    grid = 4 * 8192 ** 2 * 8
    assert mesh.ranks(ctx) == 4
    assert read("mesh_reduce_roofline")(ctx) == pytest.approx(
        100 * 0.75 * grid / 450e9 / 0.01)
    # no device op tied to the span: the NCCL kernels by name
    ctx = _ctx({"bench.reduce": (0.0, 4)},
               ops=[dict(name="ncclDevKernel_AllReduce_Sum_f32_RING_LL", total_s=0.04),
                    dict(name="gridder_kernel<32, true, false>", total_s=9.0)])
    assert read("mesh_reduce_roofline")(ctx) == pytest.approx(100 * 0.75 * grid / 450e9 / 0.01)
    for name in ("mesh_gridder_roofline", "mesh_reduce_roofline"):
        assert read(name)(_ctx()) is None
    # a world of one has no all-reduce to read
    assert read("mesh_reduce_roofline")(_ctx({"bench.reduce": (1.0, 1)},
                                             rows=1_046_528)) is None


def test_program_readers_on_a_synthetic_snapshot(monkeypatch):
    from idg_tpu_torch.utils import trace

    def use(snap):
        monkeypatch.setattr(trace, "snapshot", lambda: snap)

    agg = dict(count=1, total_s=0.0, top_s=0.0, median_s=0.0)
    use(dict(spans={"idg.mesh.launch": dict(agg, total_s=4.0),
                    "idg.mesh.shard": dict(agg, total_s=0.5),
                    "idg.mesh.stage": dict(agg, total_s=1.5),
                    "idg.mesh.reduce": dict(agg, total_s=9.0)},
             probes={},
             counters={"idg.mesh.local_pass": dict(count=30, median_ms=400.0,
                                                   ranks=[400.0, 404.0, 401.0, 402.0])}))
    read = catalog.load_reader
    assert read("port_mesh_setup_s")(None) == pytest.approx(6.0)
    assert read("mesh_rank_skew_pct")(None) == pytest.approx(1.0)
    use(dict(spans={}, probes={}))
    assert read("port_mesh_setup_s")(None) is None
    assert read("mesh_rank_skew_pct")(None) is None
    use(dict(spans={}, probes={}, counters={"idg.mesh.local_pass": dict(
        count=3, median_ms=1.0, ranks=[1.0, None])}))
    assert read("mesh_rank_skew_pct")(None) is None


def test_program_readers_without_the_programs_tracing(monkeypatch):
    import idg_tpu_torch.utils

    monkeypatch.delattr(idg_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "idg_tpu_torch.utils.trace", None)
    assert port.snapshot() is None
    for name in ("port_mesh_setup_s", "mesh_rank_skew_pct"):
        assert catalog.load_reader(name)(None) is None


def test_all_reduce_bytes_and_ranks():
    p = catalog.load_cell(CELL).problem
    assert mesh.all_reduce_bytes(p, 4) == 0.75 * 2_147_483_648
    assert mesh.all_reduce_bytes(p, 1) == 0
    assert mesh.ranks(_ctx(rows=8)) == math.ceil(1_046_528 / 8)


PROBE = r"""
import importlib.abc, sys
BANNED = {"jax", "jaxlib", "flax", "idg_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
from benchmark import harness
from benchmark.conftest import tiny_cell
from benchmark.test_bench_mesh import worker_banned
from idg_tpu_torch.parallel import world
res = harness.run("ska-low.grid-mesh4", 9, 0.05, False, device="cpu",
                  cell=tiny_cell("ska-low.grid-mesh4"), log=lambda line: None)
assert res["correct"], res
found = world._WORLD.run(worker_banned, gather=True)
world._WORLD.close()
print("OK", len(found), sorted({m for ranks in found for m in ranks}))
"""


def test_no_rank_loads_jax():
    """In a fresh interpreter where JAX and the JAX package cannot be
    imported, a run of the tiny cell: no rank, rank 0 or a worker, has
    loaded any of them (the workers start from fresh interpreters of
    their own, without the block, so their imports are checked as they
    are)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + PROBE],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK 4 []"
