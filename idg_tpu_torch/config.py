"""Problem configuration for the PyTorch/CUDA IDG benchmark.

The counterpart of ``idg_tpu/config.py``: the reference's compile-time
constants (app/common/parameters.hpp:3-5) and its env-var runtime
configuration with identical names and defaults (app/CUDA/util.cpp:177-183,
97-98; app/common/common.cpp:10-25).
"""

from __future__ import annotations

import dataclasses
import os

# Compile-time constants in the reference (parameters.hpp:3-5).
NR_CORRELATIONS = 4
IMAGE_SIZE = 0.01
W_STEP = 0.0

SPEED_OF_LIGHT = 299792458.0
START_FREQUENCY = 150.0e6
FREQUENCY_INCREMENT = 0.7e6


def get_env_var(name: str, default):
    """Env-var override with default (common.cpp:10-25 semantics)."""
    value = os.environ.get(name)
    if value is None:
        return default
    if isinstance(default, str):
        return value
    return type(default)(int(value)) if isinstance(default, int) else type(default)(value)


@dataclasses.dataclass(frozen=True)
class IDGParams:
    """Static problem parameters (shapes are all derived from these).

    Defaults are the reference's performance-mode defaults
    (app/CUDA/util.cpp:177-183); `correctness_defaults()` gives the shrunken
    correctness-mode problem (tests/gridder_common.cpp:54-64).
    """

    grid_size: int = 1024
    subgrid_size: int = 32
    nr_stations: int = 50
    nr_timeslots: int = 20
    nr_timesteps_subgrid: int = 128
    nr_channels: int = 16
    nr_correlations: int = NR_CORRELATIONS
    image_size: float = IMAGE_SIZE
    w_step: float = W_STEP

    @property
    def nr_baselines(self) -> int:
        return (self.nr_stations * (self.nr_stations - 1)) // 2

    @property
    def nr_subgrids(self) -> int:
        return self.nr_baselines * self.nr_timeslots

    @property
    def total_nr_timesteps(self) -> int:
        return self.nr_subgrids * self.nr_timesteps_subgrid

    @property
    def nr_visibilities(self) -> int:
        return self.total_nr_timesteps * self.nr_channels

    @classmethod
    def from_env(cls, **overrides) -> "IDGParams":
        """Read the reference's env vars with its perf-mode defaults."""
        kwargs = dict(
            grid_size=get_env_var("GRID_SIZE", 1024),
            subgrid_size=get_env_var("SUBGRID_SIZE", 32),
            nr_stations=get_env_var("NR_STATIONS", 50),
            nr_timeslots=get_env_var("NR_TIMESLOTS", 20),
            nr_timesteps_subgrid=get_env_var("NR_TIMESTEPS_SUBGRID", 128),
            nr_channels=get_env_var("NR_CHANNELS", 16),
            nr_correlations=get_env_var("NR_CORRELATIONS", NR_CORRELATIONS),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def correctness_defaults(cls, **overrides) -> "IDGParams":
        """Correctness-mode shrunken problem (tests/gridder_common.cpp:54-64)."""
        kwargs = dict(
            grid_size=get_env_var("GRID_SIZE", 1024),
            subgrid_size=get_env_var("SUBGRID_SIZE", 32),
            nr_stations=get_env_var("NR_STATIONS", 2),
            nr_timeslots=get_env_var("NR_TIMESLOTS", 2),
            nr_timesteps_subgrid=get_env_var("NR_TIMESTEPS_SUBGRID", 128),
            nr_channels=get_env_var("NR_CHANNELS", 16),
            nr_correlations=get_env_var("NR_CORRELATIONS", NR_CORRELATIONS),
        )
        kwargs.update(overrides)
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class HarnessConfig:
    """Timing-harness knobs (app/CUDA/util.cpp:97-98; README.md:70-71).

    nr_windows (new vs the reference): repetitions of the calibrated timing
    window, so results carry a measured noise bound (utils/timing.py)."""

    nr_warm_up_runs: int = 2
    nr_iterations: int = 5
    nr_windows: int = 3
    output_path: str = "."

    @classmethod
    def from_env(cls, **overrides) -> "HarnessConfig":
        kwargs = dict(
            nr_warm_up_runs=get_env_var("NR_WARM_UP_RUNS", 2),
            nr_iterations=get_env_var("NR_ITERATIONS", 5),
            nr_windows=get_env_var("NR_WINDOWS", 3),
            output_path=get_env_var("OUTPUT_PATH", "."),
        )
        kwargs.update(overrides)
        return cls(**kwargs)
