"""The w-term cell's configuration and mix, and its four readers
(metrics/wterm_gridder_*.py) on a synthetic context and snapshot, without
one, and on a program whose launches ran more than one rank."""

import json
from types import SimpleNamespace

import pytest

from benchmark import catalog, costs, port

CELL = "default.grid-wterm"
READERS = ("wterm_gridder_roofline", "wterm_gridder_tc_wait_pct",
           "wterm_gridder_form_wait_pct", "wterm_gridder_rank_ms")
GRIDDER_S = 0.080     # bench.gridder's device seconds a pass
PROBES = {port.GRIDDER_PROBE: dict(total=5000, k3=100, loop=4000, tc_wait=600, form_wait=900,
                                   blocks=24500, form_tiles=10, form_fast=10, launches=3)}


def _ctx(seconds=GRIDDER_S):
    cell = catalog.load_cell(CELL)
    return SimpleNamespace(problem=cell.problem,
                           span_seconds=lambda name: seconds if name == "bench.gridder" else None)


@pytest.fixture
def snapshot_is(monkeypatch):
    from idg_tpu_torch.utils import trace

    def use(snap):
        monkeypatch.setattr(trace, "snapshot", lambda: snap)

    return use


def test_configuration_and_mix_state_the_same_w():
    bench = catalog.load_benchmark()
    cell = catalog.load_cell(CELL, bench=bench)
    entry = {c["name"]: c for c in bench["configs"]}[cell.config_name]
    cfg = json.loads((catalog.ROOT / entry["file"]).read_text())
    assert cfg["declination_deg"] == cell.traffic["declination_deg"] == -27.0
    assert cfg["w_step"] == cell.traffic["w_step"] == cell.problem.w_step == 0.0
    assert cell.traffic["recipe"] == "grid_wterm" and cell.chips == 1
    assert {m["name"] for m in cell.per_layer} == set(READERS)


def test_readers_on_a_synthetic_snapshot(snapshot_is):
    snapshot_is(dict(spans={}, probes=PROBES,
                     w_term={"idg.w_rank.gridder": {5: 12}, "idg.w_mu_n.gridder": 0.1689}))
    ctx = _ctx()
    got = {name: catalog.load_reader(name)(ctx) for name in READERS}
    want_roofline = costs.roofline_pct(costs.gridder_work(ctx.problem), GRIDDER_S)
    assert got == {"wterm_gridder_roofline": pytest.approx(want_roofline),
                   "wterm_gridder_tc_wait_pct": pytest.approx(15.0),
                   "wterm_gridder_form_wait_pct": pytest.approx(22.5),
                   "wterm_gridder_rank_ms": pytest.approx(16.0)}
    assert got["wterm_gridder_roofline"] == catalog.load_reader("gridder_roofline")(ctx)


def test_readers_find_nothing_without_a_span_or_a_snapshot(snapshot_is):
    snapshot_is(None)
    assert {name: catalog.load_reader(name)(_ctx(None)) for name in READERS} == \
        dict.fromkeys(READERS)
    snapshot_is(dict(spans={}, probes={}))
    assert {name: catalog.load_reader(name)(_ctx()) for name in READERS} == dict(
        dict.fromkeys(READERS), wterm_gridder_roofline=catalog.load_reader(
            "gridder_roofline")(_ctx()))


@pytest.mark.parametrize("ranks", [{5: 11, 4: 1}, {}])
def test_rank_ms_needs_exactly_one_rank(snapshot_is, ranks):
    """Mixed ranks or no launch: None."""
    snapshot_is(dict(spans={}, probes={}, w_term={"idg.w_rank.gridder": ranks}))
    assert catalog.load_reader("wterm_gridder_rank_ms")(_ctx()) is None
