"""Device timing harness.

The reference times kernels with cudaEvent-bracketed launch loops:
NR_WARM_UP_RUNS warm-ups then NR_ITERATIONS timed launches
(app/CUDA/util.cpp:81-161). This is the counterpart of
``idg_tpu/utils/timing.py:time_kernel``: the first launch (kernel build and
load) and the warm-ups are excluded, then NR_WINDOWS windows of back-to-back
launches are timed with CUDA events on the current stream, the iteration
count calibrated so a window lasts at least MIN_WINDOW_S. The headline is
the min over windows; mean and σ are kept as the noise bound.

`time_kernel_sustained` is the counterpart of
``idg_tpu/utils/timing.py:144-213``: launches back to back for a wall-clock
window of some seconds, its device time taken in chunks, so that the
per-chunk series shows drift (clocks, power, queue backpressure) that the
min-of-windows headline hides by construction.

The trace hook is the counterpart of ``idg_tpu/utils/timing.py:79-85,
105-106, 131-132``: with `profile_dir=` or ``IDG_PROFILE_DIR`` set,
`time_kernel`'s timed windows run inside `torch.profiler` (`trace_window`),
which exports one Chrome trace per call for ``scripts/trace_tools_cuda.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import re
import time
from typing import Callable, Iterator, Optional

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
    # every window timed, the calibration's included, as (iterations,
    # seconds): what a trace of the call covers
    timed_windows: tuple = ()

    @property
    def seconds_std(self) -> float:
        """Per-iteration standard deviation across windows (noise bound; 0
        with a single window)."""
        w = np.asarray(self.all_seconds)
        return float(w.std(ddof=1) / self.iterations) if w.size > 1 else 0.0


def _device_seconds(fn: Callable, args: tuple, iters: int) -> float:
    """Device seconds of `iters` back-to-back launches of `fn(*args)`,
    bracketed by CUDA events on the current stream around the launches
    only, then synchronized."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def _trace_rank() -> int:
    """This process's rank for a trace's file name: torch.distributed's when
    a world is up, else the launcher's RANK, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


@contextlib.contextmanager
def trace_window(profile_dir: Optional[str], label: str = "fn") -> Iterator[Optional[str]]:
    """Run the body inside `torch.profiler.profile` (CPU and CUDA activity,
    no shapes or stacks, flops counted where the profiler can) and export
    its Chrome trace into `profile_dir` as
    ``<pid>-r<rank>-<n>-<label>.pt.trace.json``, n counting this process's
    traces of that rank there, so that calls and ranks never share a file.
    Yields the file's path; with no `profile_dir` it yields None and traces
    nothing. The profile stops, and nothing is written, when the body
    raises."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    stem = f"{os.getpid()}-r{_trace_rank()}"
    n = len(glob.glob(os.path.join(glob.escape(profile_dir), f"{stem}-*.pt.trace.json")))
    label = re.sub(r"[^A-Za-z0-9_.]+", "", label) or "fn"
    path = os.path.join(profile_dir, f"{stem}-{n}-{label}.pt.trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False, with_flops=True) as prof:
        yield path
    prof.export_chrome_trace(path)


def time_kernel(
    fn: Callable, *args, harness: Optional[HarnessConfig] = None,
    agree: Optional[Callable[[float], float]] = None,
    profile_dir: Optional[str] = None,
) -> TimingResult:
    """Warm-up + CUDA-event-timed launch windows (p_run_kernel semantics,
    app/CUDA/util.cpp:81-128). `fn(*args)` must enqueue its work on the
    current CUDA stream. Raises when no card is visible: a time is only
    ever a device time.

    `agree` is for ranks that time together (the sharded pipelines, whose
    collectives every rank must enter as often as the others): each rank
    passes it every window's seconds and gets back the value all ranks
    share, their maximum, before the next window starts. So every rank
    calibrates the same launch count, the agreement is each window's
    barrier, and the windows are the slowest rank's.

    `profile_dir`, or when it is None the ``IDG_PROFILE_DIR`` environment
    variable, traces the timed windows, the first through the last, the
    calibration's included (`trace_window`), so any command that times
    through here can be traced with no flag of its own. A traced call's
    times carry the profiler's cost: they are not headline times."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_kernel times the card, and no CUDA device is visible")
    cfg = harness or HarnessConfig.from_env()
    agree = agree or (lambda seconds: seconds)
    if profile_dir is None:
        profile_dir = os.environ.get("IDG_PROFILE_DIR") or None

    fn(*args)                      # build, load and first-touch excluded
    for _ in range(cfg.nr_warm_up_runs):
        fn(*args)
    torch.cuda.synchronize()
    agree(0.0)

    timed = []

    def window(n: int) -> float:
        seconds = agree(_device_seconds(fn, args, n))
        timed.append((n, seconds))
        return seconds

    with trace_window(profile_dir, getattr(fn, "__name__", "fn")):
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
        timed_windows=tuple(timed),
    )


@dataclasses.dataclass(frozen=True)
class SustainedResult:
    seconds: float         # sustained seconds per launch: device time over launches
    launches: int          # launches inside the window
    window_seconds: float  # wall time of the window
    chunk_seconds: tuple   # per-launch device seconds of each chunk, in order

    @property
    def drift_pct(self) -> float:
        """The last chunk's per-launch time against the first's, in percent:
        positive when launches got slower as the window ran (clocks or
        power throttling, queue backpressure)."""
        c = self.chunk_seconds
        if len(c) < 2 or c[0] <= 0:
            return 0.0
        return float(100.0 * (c[-1] - c[0]) / c[0])


def time_kernel_sustained(
    fn: Callable, *args, duration_s: float = 10.0,
    harness: Optional[HarnessConfig] = None,
) -> SustainedResult:
    """A sustained launch window: `fn(*args)` back to back until the wall
    clock passes `duration_s` (the reference's energy loop keeps its kernel
    running ~10 s, app/CUDA/util.cpp:131-155; no power is read here, as
    the JAX package reads none). The first launch and the warm-ups are
    excluded; one more launch, timed alone, sizes the chunks at about
    duration_s / 20 and at least 10 launches. Each chunk is bracketed by
    CUDA events on the current stream around its launches only, and
    synchronized once. So 2 + NR_WARM_UP_RUNS launches precede the window.
    Raises when no card is visible."""
    if duration_s <= 0:
        raise ValueError(f"the sustained window needs a duration > 0 s, got {duration_s}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_kernel_sustained times the card, and no CUDA device is visible")
    cfg = harness or HarnessConfig.from_env()

    fn(*args)                      # build, load and first-touch excluded
    for _ in range(cfg.nr_warm_up_runs):
        fn(*args)
    torch.cuda.synchronize()

    estimate = max(_device_seconds(fn, args, 1), 1e-6)
    iters = max(10, int(duration_s / 20.0 / estimate))
    chunks = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < duration_s:
        chunks.append(_device_seconds(fn, args, iters) / iters)
    window = time.perf_counter() - t0
    return SustainedResult(
        seconds=sum(chunks) / len(chunks),   # the chunks are equal in launches
        launches=iters * len(chunks),
        window_seconds=window,
        chunk_seconds=tuple(chunks),
    )
