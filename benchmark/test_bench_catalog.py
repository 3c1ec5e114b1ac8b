"""BENCHMARK.json against the contract's shape rules, and discovery of
configurations, traffic mixes, metric readers and limits by name."""

import json
import re

import pytest

from benchmark import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = catalog.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_text(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_bounds_and_setup():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_name_reported_cells_and_layers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(WORKLOADS)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_loads_by_name(workload):
    cell = catalog.load_cell(workload)
    recipe = catalog.load_recipe(cell.traffic["recipe"])
    for fn in ("make_inputs", "build", "expected", "pass_flops"):
        assert callable(getattr(recipe, fn))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "mvis_s", "pass_ms_p95"}
    assert cell.per_layer
    assert set(cell.limits) == {"rms_err", "max_err"}
    for m in cell.per_layer:
        assert callable(catalog.load_reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_sizes_they_run(config):
    cfg = json.loads((catalog.ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    assert set(cfg["reduced"]) <= set(cfg) and set(cfg["reduced"]) <= set(catalog.SIZE_KEYS)
    p = catalog.Problem.from_config(cfg)
    assert (p.subgrid_size, p.nr_timeslots, p.nr_timesteps_subgrid, p.nr_channels,
            p.nr_correlations) == (32, 20, 128, 16, 4)


def test_hand_worked_sizes():
    d = catalog.load_cell("default.grid").problem
    sp = catalog.load_cell("sparse4096.grid").problem
    assert (d.nr_baselines, d.nr_subgrids, d.nr_visibilities) == (1225, 24500, 50_176_000)
    assert (sp.nr_baselines, sp.nr_subgrids, sp.nr_visibilities) == (351, 7020, 14_376_960)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        catalog.load_cell("no.such")


@pytest.mark.parametrize("kind", ["recipe", "reader"])
def test_unknown_file_is_refused(kind):
    load = catalog.load_recipe if kind == "recipe" else catalog.load_reader
    with pytest.raises(FileNotFoundError):
        load("no_such")
