"""Device timing harness.

The reference times kernels with cudaEvent-bracketed launch loops:
NR_WARM_UP_RUNS warm-ups then NR_ITERATIONS timed launches
(app/CUDA/util.cpp:81-161). This is the counterpart of
``idg_tpu/utils/timing.py:time_kernel``: the first launch (kernel build and
load) and the warm-ups are excluded, then NR_WINDOWS windows of back-to-back
launches are timed with CUDA events on the current stream, the iteration
count calibrated so a window lasts at least MIN_WINDOW_S. The headline is
the min over windows; mean and σ are kept as the noise bound.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import HarnessConfig

MIN_WINDOW_S = 0.05
MAX_ITERATIONS = 4096


@dataclasses.dataclass(frozen=True)
class TimingResult:
    seconds: float          # min-window seconds per iteration (robust estimate)
    iterations: int         # iterations per window
    warmup_runs: int
    all_seconds: tuple      # per-window device seconds

    @property
    def seconds_std(self) -> float:
        """Per-iteration standard deviation across windows (noise bound; 0
        with a single window)."""
        w = np.asarray(self.all_seconds)
        return float(w.std(ddof=1) / self.iterations) if w.size > 1 else 0.0


def time_kernel(
    fn: Callable, *args, harness: Optional[HarnessConfig] = None
) -> TimingResult:
    """Warm-up + CUDA-event-timed launch windows (p_run_kernel semantics,
    app/CUDA/util.cpp:81-128). `fn(*args)` must enqueue its work on the
    current CUDA stream. Raises when no card is visible: a time is only
    ever a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_kernel times the card, and no CUDA device is visible")
    cfg = harness or HarnessConfig.from_env()

    fn(*args)                      # build, load and first-touch excluded
    for _ in range(cfg.nr_warm_up_runs):
        fn(*args)
    torch.cuda.synchronize()

    def window(iters: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    iters = max(1, cfg.nr_iterations)
    total = window(iters)
    while total < MIN_WINDOW_S and iters < MAX_ITERATIONS:
        iters = min(MAX_ITERATIONS,
                    max(iters * 2, int(iters * 1.2 * MIN_WINDOW_S / max(total, 1e-9))))
        total = window(iters)

    windows = [total] + [window(iters) for _ in range(max(0, cfg.nr_windows - 1))]
    return TimingResult(
        seconds=min(windows) / iters,
        iterations=iters,
        warmup_runs=cfg.nr_warm_up_runs,
        all_seconds=tuple(windows),
    )
