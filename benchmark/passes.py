"""What the recipes share to call the port, the system under test: a pass
as a list of stages, the port's parameters and observation built from the
benchmark's inputs, and the set-up's clock.

A pass is a list of stages, each (span name, function of the previous
stage's output); the harness wraps each in its span when it traces. Each
recipe (recipes/<name>.py) builds its own.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class Pass:
    stages: list            # [(span name, fn(x) -> y)]
    first_input: object     # what the first stage takes
    plan_s: float           # host seconds of the grid plans
    stage_s: float          # host seconds of the guards and the staging, to a synchronize
    version: str            # the port's resolved rung

    def __call__(self, hook=None, spans: bool = False):
        """One pass. With `spans`, each stage runs inside a
        torch.profiler.record_function range of its name; `hook(name, x)`
        may replace a stage's output (the tests' planted faults)."""
        x = self.first_input
        for name, fn in self.stages:
            if spans:
                with torch.profiler.record_function(name):
                    x = fn(x)
            else:
                x = fn(x)
            if hook is not None:
                x = hook(name, x)
        return x


def params(problem):
    """The port's IDGParams of a configuration's sizes."""
    from idg_tpu_torch.config import IDGParams

    return IDGParams(**{f.name: getattr(problem, f.name)
                        for f in dataclasses.fields(IDGParams)})


def block_sorted(problem, inputs):
    """The port's Observation of the inputs, in its block order
    (ops/grid.py:sort_observation_blocks)."""
    from idg_tpu_torch.ops.grid import sort_observation_blocks
    from idg_tpu_torch.types import Metadata, Observation

    obs = Observation(uvw=inputs.uvw, wavenumbers=inputs.wavenumbers,
                      visibilities=inputs.visibilities, spheroidal=inputs.spheroidal,
                      aterms=inputs.aterms, metadata=Metadata(**inputs.metadata))
    return sort_observation_blocks(obs, problem.grid_size, problem.subgrid_size)[0]


class SetupClock:
    """Host seconds of a recipe's set-up: `plan_s` from entering to
    `planned()`, `stage_s` from there to a synchronize on leaving."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.t0 = self.t1 = time.perf_counter()
        return self

    def planned(self) -> None:
        self.t1 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.plan_s = self.t1 - self.t0
        self.stage_s = time.perf_counter() - self.t1
        return False
