"""The readers of the port's own spans and probes (metrics/port_*.py,
metrics/*_k3_pct.py, metrics/*_tc_wait_pct.py, through port.py) on a
synthetic snapshot, on an empty one and without the program's tracing
module, and in a traced run of a tiny cell on the CPU."""

import json
import sys

import pytest

from benchmark import catalog, harness, port, tracefile
from benchmark.conftest import tiny_cell
from benchmark.test_bench_trace import toy_events

NEW = ("port_plan_s", "port_stage_s", "port_enqueue_ms", "gridder_k3_pct",
       "gridder_tc_wait_pct", "degridder_k3_pct", "degridder_tc_wait_pct")


def _agg(total, top=None, median=0.0, count=1):
    return dict(count=count, total_s=total, top_s=total if top is None else top, median_s=median)


SNAPSHOT = dict(
    spans={
        "idg.plan.sort_blocks": _agg(0.004), "idg.plan.ranges": _agg(0.002),
        "idg.plan.rolls": _agg(0.001, top=0.0),
        "idg.stage.resolve": _agg(0.05), "idg.stage.copy": _agg(0.40, top=0.30, count=2),
        "idg.gridder": _agg(0.3, median=4e-4, count=700),
        "idg.grid_add": _agg(0.2, median=2e-4, count=700),
        "idg.kernel.grid_add": _agg(0.1, median=1e-4, count=700),
    },
    probes={"gridder_cuda_v6_pieces": dict(total=4000, k3=60, loop=3600, tc_wait=1800,
                                           form_wait=90, blocks=49000)},
)


@pytest.fixture
def snapshot_is(monkeypatch):
    from idg_tpu_torch.utils import trace

    def use(snap):
        monkeypatch.setattr(trace, "snapshot", lambda: snap)

    return use


def test_readers_on_a_synthetic_snapshot(snapshot_is):
    """Plans: every idg.plan.* span's total; staging: the idg.stage.* time
    in no enclosing span; enqueue: the pass spans' medians, not their
    children's; the probe shares of the gridder, none of the degridder."""
    snapshot_is(SNAPSHOT)
    got = {name: catalog.load_reader(name)(None) for name in NEW}
    assert got == {"port_plan_s": pytest.approx(0.007), "port_stage_s": pytest.approx(0.35),
                   "port_enqueue_ms": pytest.approx(0.6), "gridder_k3_pct": pytest.approx(1.5),
                   "gridder_tc_wait_pct": pytest.approx(50.0), "degridder_k3_pct": None,
                   "degridder_tc_wait_pct": None}


def test_readers_find_nothing_in_an_empty_snapshot(snapshot_is):
    snapshot_is(dict(spans={}, probes={}))
    assert {name: catalog.load_reader(name)(None) for name in NEW} == dict.fromkeys(NEW)
    snapshot_is(dict(SNAPSHOT, probes={port.GRIDDER_PROBE: dict.fromkeys(
        ("total", "k3", "loop", "tc_wait", "form_wait", "blocks"), 0)}))
    assert catalog.load_reader("gridder_k3_pct")(None) is None


def test_readers_without_the_programs_tracing_module(monkeypatch):
    """A program without idg_tpu_torch/utils/trace.py (the parent of the
    change that added it) gives None, and raises nothing."""
    import idg_tpu_torch.utils

    monkeypatch.delattr(idg_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "idg_tpu_torch.utils.trace", None)
    assert port.snapshot() is None
    assert {name: catalog.load_reader(name)(None) for name in NEW} == dict.fromkeys(NEW)


@pytest.mark.parametrize("workload", ["default.grid", "default.degrid"])
def test_traced_run_reports_the_port_spans_and_no_probe_on_the_cpu(workload, quiet,
                                                                   monkeypatch):
    """A traced run of a tiny cell on the CPU (the toy trace standing in for
    the card's): the port's span metrics are in the line, the probe shares,
    which need the card's kernels, are not."""
    from idg_tpu_torch.utils import trace

    monkeypatch.setattr(harness, "traced", lambda run_pass, seconds, device, keep_at: (
        harness.run_window(run_pass, seconds, device, keep_at),
        tracefile.summarize([e for e in toy_events() if e["ph"] == "X"])))
    trace.reset()
    res = harness.run(workload, 2**33 + 11, 0.05, True, device="cpu",
                      cell=tiny_cell(workload), log=quiet)
    metrics = res["metrics"]
    assert {"port_plan_s", "port_stage_s", "port_enqueue_ms"} <= set(metrics)
    assert not {"gridder_k3_pct", "gridder_tc_wait_pct", "degridder_k3_pct",
                "degridder_tc_wait_pct"} & set(metrics)
    assert all(metrics[m]["value"] > 0 for m in ("port_plan_s", "port_stage_s",
                                                 "port_enqueue_ms"))
    assert res["correct"]
    json.dumps(res)
    trace.reset()
