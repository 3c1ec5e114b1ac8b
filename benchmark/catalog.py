"""The benchmark's catalog: configurations, traffic mixes, per-layer metric
readers and limits, each found by name in a file of its own.

    configs/<file from BENCHMARK.json>   problem sizes (JSON)
    traffic/<traffic>.json              the mix's parameters (JSON), among them
                                        `recipe`, the pass it drives
    recipes/<recipe>.py                 the pass: make_inputs, build, expected,
                                        pass_flops
    metrics/<metric>.py                 a reader: read(ctx) -> float | None
    limits/<workload>.json              the limits of the numbers compared
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

SIZE_KEYS = ("grid_size", "subgrid_size", "nr_stations", "nr_timeslots",
             "nr_timesteps_subgrid", "nr_channels", "nr_correlations")


@dataclasses.dataclass(frozen=True)
class Problem:
    """One configuration's sizes, in the upstream's names."""

    grid_size: int
    subgrid_size: int
    nr_stations: int
    nr_timeslots: int
    nr_timesteps_subgrid: int
    nr_channels: int
    nr_correlations: int
    image_size: float
    w_step: float

    @property
    def nr_baselines(self) -> int:
        return self.nr_stations * (self.nr_stations - 1) // 2

    @property
    def nr_subgrids(self) -> int:
        return self.nr_baselines * self.nr_timeslots

    @property
    def nr_visibilities(self) -> int:
        return self.nr_subgrids * self.nr_timesteps_subgrid * self.nr_channels

    @classmethod
    def from_config(cls, cfg: dict) -> "Problem":
        return cls(**{k: int(cfg[k]) for k in SIZE_KEYS},
                   image_size=float(cfg["image_size"]), w_step=float(cfg["w_step"]))


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""

    name: str
    config_name: str
    problem: Problem
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: tuple      # metric entries of BENCHMARK.json this cell reports
    per_layer: tuple
    limits: dict           # {number name: limit}


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str, reported: set) -> bool:
    """A metric with a `workloads` list applies to the cells it names; one
    without applies to every cell (end-to-end), or to every cell that
    reports the end-to-end metric it moves (per-layer)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(workload: str, root: pathlib.Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, workload, set()))
    reported = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _applies(m, workload, reported))
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(workload, w["config"], Problem.from_config(cfg), w["traffic"], traffic,
                int(w["chips"]), e2e, per_layer, limits)


def _load(path: pathlib.Path, module_name: str):
    """A module of the catalog, loaded by file path (a name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str):
    """metrics/<metric>.py's `read`."""
    return _load(HERE / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}").read


def load_recipe(name: str):
    """recipes/<name>.py: make_inputs(problem, traffic, seed, device),
    build(problem, inputs, device) -> passes.Pass, expected(problem,
    inputs, rounding) -> the reference's output in the program's order,
    pass_flops(problem)."""
    return _load(HERE / "recipes" / f"{name}.py", f"benchmark_recipe_{name}")
