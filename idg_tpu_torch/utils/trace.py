"""The port's tracing: spans at its layer boundaries, the phase probes of
the fused K1 and K2, and the profiler window.

    span(name)      a context manager and a decorator. Every span adds its
                    duration (`perf_counter_ns`) to its name's aggregate:
                    a count, a total, the time it ran with no enclosing
                    span on its thread (top level), and its newest SAMPLES
                    durations for a median. Only while a profiler is
                    recording does it also open a
                    `torch.profiler.record_function` range of its name, so
                    that the span sits in the profiler's trace beside the
                    device operations it launched. With no profiler a span
                    costs one check and two clock reads.
    probe(kernel, device)
                    the kernel's phase accumulator, u64[len(PROBE_FIELDS)]
                    on `device`, for one launch in PROBE_EVERY while a
                    profiler is recording, else None. A fused K1 or K2
                    launched with it runs its probed instance, which adds
                    each block's clock64() phase cycles into it
                    (csrc/gridder.cu, csrc/degridder.cu); launched without
                    it, the kernel is the unprobed one.
    mark(device), add_interval(name, start, end)
                    a counter of device intervals: `mark` records a CUDA
                    event on the current stream (a host clock reading on
                    the CPU), `add_interval` keeps a pair of marks under a
                    name, its newest SAMPLES pairs; their milliseconds are
                    read when a snapshot is taken. The caller marks only
                    while it traces.
    count_rank(name, rank), keep_bound(name, value)
                    the w-term's tallies, host-side dict updates with no
                    device work: `count_rank` adds one launch to the Taylor
                    rank (or the pass count) it ran, `keep_bound` keeps a
                    guard's newest |μ·n| bound.
    snapshot()      the spans' aggregates and each kernel's probe sums,
                    copied to the host once, and, where intervals were
                    kept, each counter's count and median ms; on rank 0 of
                    a local world (parallel/world.py) also every rank's
                    median, gathered from the ranks when it is taken; and,
                    where any were kept, the w-term's tallies.
    reset()         clears all four.
    trace_window(profile_dir, label)
                    runs a body inside `torch.profiler` and exports its
                    Chrome trace (utils/timing.py:time_kernel's hook,
                    IDG_PROFILE_DIR).

Names: `idg.plan.*` (ops/grid.py's plans), `idg.stage.*` (ops/api.py's
guards, ops/common.py's staging), the pass spans `idg.gridder`,
`idg.grid_add` (with `idg.kernel.grid_add` inside), `idg.grid_extract` and
`idg.degridder`; the local world's `idg.mesh.launch`, `idg.mesh.shard`,
`idg.mesh.stage` and `idg.mesh.reduce` (parallel/). The counter
`idg.mesh.local_pass` times a rank's K1 and K4 of a sharded pass. The
w-term's tallies: `idg.w_rank.gridder`, {Taylor rank: launches} of the
gridder's K1 (ops/cuda/gridder.py: `gridder_cuda_v6` and
`gridder_cuda_v6_pieces`, a call of their plain versions on the CPU
counting as one), `idg.w_passes.gridder`, {TF32 product passes a tile:
launches} of the same (ops/precision.py:gridder_three_pass_ranks), and
`idg.w_mu_n.<workload>`, the |μ·n| bound the guard
computed last for that workload (ops/api.py:_resolve). No span runs inside
a loop over subgrids or tiles.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import glob
import os
import re
import statistics
import threading
import time
from typing import Iterator, Optional

import torch

SAMPLES = 4096     # durations kept a span name, the newest, for its median
# the fields of a probe accumulator, in the order the kernels add them;
# form_tiles and form_fast count K1's producer-warp tile formations and
# those whose phasors needed no exact fallback (K2 leaves both at 0)
PROBE_FIELDS = ("total", "k3", "loop", "tc_wait", "form_wait", "blocks", "form_tiles",
                "form_fast")
# A probed launch is slower than an unprobed one on an H100, K1 by 1.4% and
# K2 by 2.7%, and still by 0.8% and 2.4% without the timing of the tile
# barriers, so under a profiler one launch of a kernel in PROBE_EVERY runs
# probed: a traced window's K1 and K2 then lose some 0.2% and 0.3%.
PROBE_EVERY = 8


def profiling() -> bool:
    """Whether a torch profiler is recording in this process."""
    return torch._C._autograd._profiler_enabled()


class Tracer:
    """Per-name span aggregates and the kernels' probe accumulators."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        # rank 0 of a local world: fn() -> every rank's interval_medians()
        self.gather = None
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # name -> [count, total ns, top-level ns, newest durations]
            self.aggregates = {}
            self.probes = {}     # (kernel, device) -> i64[len(PROBE_FIELDS)] on the device
            self.probe_calls = collections.Counter()   # (kernel, device) -> calls while profiling
            self.probed = collections.Counter()        # (kernel, device) -> probed launches
            self.intervals = {}  # name -> newest (start, end) marks
            self.ranks = {}      # name -> Counter of launches by Taylor rank
            self.bounds = {}     # name -> newest |μ·n| bound

    def _stack(self) -> list:
        """This thread's open spans, each (start ns, profiler range or None)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name: str, dur: int, top: bool) -> None:
        with self._lock:
            agg = self.aggregates.get(name)
            if agg is None:
                agg = self.aggregates[name] = [0, 0, 0, collections.deque(maxlen=SAMPLES)]
            agg[0] += 1
            agg[1] += dur
            if top:
                agg[2] += dur
            agg[3].append(dur)

    def probe(self, kernel: str, device) -> Optional[torch.Tensor]:
        """`kernel`'s probe accumulator on `device` (allocated zeroed at its
        first use) for the first of every PROBE_EVERY calls while a profiler
        is recording, else None. The caller launches the probed kernel with
        what it gets, and only then."""
        if not profiling():
            return None
        key = (kernel, torch.device(device))
        with self._lock:
            self.probe_calls[key] += 1
            if (self.probe_calls[key] - 1) % PROBE_EVERY:
                return None
            self.probed[key] += 1
            buf = self.probes.get(key)
            if buf is None:
                buf = self.probes[key] = torch.zeros(len(PROBE_FIELDS), dtype=torch.int64,
                                                     device=key[1])
        return buf

    def add_interval(self, name: str, start, end) -> None:
        with self._lock:
            rows = self.intervals.get(name)
            if rows is None:
                rows = self.intervals[name] = collections.deque(maxlen=SAMPLES)
            rows.append((start, end))

    def count_rank(self, name: str, rank: int) -> None:
        with self._lock:
            self.ranks.setdefault(name, collections.Counter())[int(rank)] += 1

    def keep_bound(self, name: str, value: float) -> None:
        with self._lock:
            self.bounds[name] = float(value)

    def interval_medians(self) -> dict:
        """{name: (count, median ms)} of the kept intervals of this
        process, waiting for each one's closing event."""
        with self._lock:
            kept = {name: list(rows) for name, rows in self.intervals.items()}
        return {name: (len(rows), statistics.median(_elapsed_ms(a, b) for a, b in rows))
                for name, rows in kept.items() if rows}

    def snapshot(self) -> dict:
        """{"spans": per span name {count, total_s, top_s (with no enclosing
        span), median_s (of its newest SAMPLES)}; "probes": per kernel the
        sums of PROBE_FIELDS over its devices, and `launches`, its probed
        launches}; with kept intervals also "counters": per name {count,
        median_ms, ranks: each rank's median ms, rank 0 first (this
        process's alone outside a local world)}."""
        medians = self.interval_medians()
        counters = {}
        if medians:
            ranks = self.gather() if self.gather is not None else None
            for name, (count, median) in medians.items():
                per_rank = ([r.get(name, (0, None))[1] for r in ranks] if ranks
                            else [median])
                counters[name] = dict(count=count, median_ms=median, ranks=per_rank)
        with self._lock:
            spans = {name: dict(count=c, total_s=t * 1e-9, top_s=top * 1e-9,
                                median_s=statistics.median(d) * 1e-9)
                     for name, (c, t, top, d) in self.aggregates.items()}
            probes = [(key, buf, self.probed[key]) for key, buf in self.probes.items()]
            w_term = {name: dict(ranks) for name, ranks in self.ranks.items()}
            w_term.update(self.bounds)
        sums = {}
        for (kernel, _), buf, launches in probes:
            got = sums.setdefault(kernel, dict.fromkeys(PROBE_FIELDS + ("launches",), 0))
            for field, value in zip(PROBE_FIELDS, buf.cpu().tolist()):
                got[field] += int(value)
            got["launches"] += launches
        out = dict(spans=spans, probes=sums)
        if counters:
            out["counters"] = counters
        if w_term:
            out["w_term"] = w_term
        return out


def _elapsed_ms(start, end) -> float:
    """Milliseconds between two marks: CUDA events or perf_counter_ns."""
    if isinstance(start, int):
        return (end - start) * 1e-6
    end.synchronize()
    return start.elapsed_time(end)


class span:
    """A span of the port, `with span(name):` or `@span(name)`. State lives
    on the thread's stack of open spans, so one span object may be entered
    again inside itself and from several threads. Its time leaves out the
    opening and closing of its profiler range."""

    __slots__ = ("name", "tracer")

    def __init__(self, name: str, tracer: Optional[Tracer] = None):
        self.name = name
        self.tracer = tracer

    def __enter__(self):
        rf = None
        if profiling():
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        (self.tracer or TRACER)._stack().append((time.perf_counter_ns(), rf))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tracer = self.tracer or TRACER
        stack = tracer._stack()
        start, rf = stack.pop()
        if rf is not None:
            rf.__exit__(*exc)
        tracer._record(self.name, end - start, not stack)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return spanned


TRACER = Tracer()


def probe(kernel: str, device) -> Optional[torch.Tensor]:
    return TRACER.probe(kernel, device)


def snapshot() -> dict:
    return TRACER.snapshot()


def mark(device):
    """A CUDA event recorded on `device`'s current stream, or on the CPU
    the host clock in ns: one end of an interval for add_interval."""
    device = torch.device(device)
    if device.type != "cuda":
        return time.perf_counter_ns()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def add_interval(name: str, start, end) -> None:
    TRACER.add_interval(name, start, end)


def count_rank(name: str, rank: int) -> None:
    TRACER.count_rank(name, rank)


def keep_bound(name: str, value: float) -> None:
    TRACER.keep_bound(name, value)


def reset() -> None:
    TRACER.reset()


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
    no shapes or stacks) and export its Chrome trace into `profile_dir` as
    ``<pid>-r<rank>-<n>-<label>.pt.trace.json``, n counting this process's
    traces of that rank there, so that calls and ranks never share a file.
    Yields the file's path; with no `profile_dir` it yields None and traces
    nothing. The profile stops, and nothing is written, when the body
    raises. Inside it the port's spans are profiler ranges and the fused
    K1 and K2 run probed."""
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
                 record_shapes=False, with_stack=False) as prof:
        yield path
    prof.export_chrome_trace(path)
