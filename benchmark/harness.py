"""One run of one cell: inputs from the seed, the port's set-up, a warm-up,
a closed loop of whole passes for a fixed time, the comparison with the
plain reference, and one JSON line.

The window: passes are enqueued back to back with at most two in flight;
a CUDA event recorded on the stream after each pass closes its interval,
so a pass's time counts any gap in which the host ran late. The window
ends in a synchronize.
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import catalog, compare, inputs as inputs_mod, tracefile

BANNED = ("jax", "jaxlib", "flax", "idg_tpu")   # top-level module names, compared whole
IN_FLIGHT = 2
WARMUP_PASSES = 3
SAMPLE_SPREAD = 32    # the sampled pass is one of passes 2 .. 2 + SAMPLE_SPREAD − 1


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class BannedModules(RuntimeError):
    """JAX or the JAX package was loaded in the process that reports."""


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def cache_dirs(root=catalog.ROOT) -> None:
    """Fixed cache directories inside the checkout for any toolchain that
    reads them; the port's own build cache is idg_tpu_torch/_build/."""
    base = root / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def check_device(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark times the card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} card(s), {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    passes: int
    seconds: float            # host clock, from the first enqueue to the closing synchronize
    pass_ms: list             # per pass, event to event (host clock off the card)
    enqueue_s: list           # host seconds inside each pass call
    outputs: dict             # "sampled" (if the window reached it) and "last"


def run_window(run_pass, seconds: float, device: torch.device, keep_at: int) -> Window:
    cuda = device.type == "cuda"

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    marks, enqueue, outputs = [mark()], [], {}
    t0 = time.perf_counter()
    i = 0
    while True:
        if cuda and i >= IN_FLIGHT:
            marks[i - IN_FLIGHT + 1].synchronize()
        h0 = time.perf_counter()
        out = run_pass()
        enqueue.append(time.perf_counter() - h0)
        marks.append(mark())
        if i == keep_at:
            outputs["sampled"] = out
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    outputs["last"] = out
    if cuda:
        pass_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        pass_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return Window(i, elapsed, pass_ms, enqueue, outputs)


def power_line() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def reader_context(cell, recipe, inp, pass_obj, window: Window, summary: dict | None):
    """What per-layer readers read."""
    spans = summary["spans"] if summary else {}

    def span_seconds(name):
        """Device seconds a pass in span `name`, or None when the span
        launched nothing."""
        total, count = spans.get(name, (0.0, 0))
        return total / count if count and total > 0 else None

    return SimpleNamespace(
        problem=cell.problem, pass_flops=recipe.pass_flops(cell.problem),
        metadata=inp.metadata,
        plan_s=pass_obj.plan_s, stage_s=pass_obj.stage_s, enqueue_s=window.enqueue_s,
        trace=summary,
        span_seconds=span_seconds, span_names=[name for name, _ in pass_obj.stages],
    )


def traced(run_pass, seconds, device, keep_at):
    """run_window inside torch.profiler; returns (window, trace summary)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window.pt.trace.json")
        with profile(activities=activities) as prof:
            window = run_window(run_pass, seconds, device, keep_at)
        prof.export_chrome_trace(path)
        summary = tracefile.summarize(tracefile.load_events(path))
    return window, summary


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float | None = None,
        device=None, cell=None, hook=None, log=None) -> dict:
    """One run; returns the result object. `device` None means the card
    (and checks that the cell's cards are there); tests pass "cpu", a
    small `cell` and a `hook(stage, x) -> x` that breaks the pass."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    cell = cell or catalog.load_cell(workload)
    dev = check_device(cell.chips) if device is None else torch.device(device)
    cache_dirs()
    parts["device"] = time.perf_counter() - t
    recipe = catalog.load_recipe(cell.traffic["recipe"])

    t = time.perf_counter()
    if dev.type == "cuda":
        from idg_tpu_torch.ops.cuda import build as kernel_build

        kernel_build.library()
    parts["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    inp = recipe.make_inputs(cell.problem, cell.traffic, seed, dev)
    _sync(dev)
    parts["inputs"] = time.perf_counter() - t

    pass_obj = recipe.build(cell.problem, inp, dev)
    parts["plan"], parts["stage"] = pass_obj.plan_s, pass_obj.stage_s

    def run_pass(spans=False):
        return pass_obj(hook=hook, spans=spans)

    t = time.perf_counter()
    for _ in range(WARMUP_PASSES):
        run_pass()
    _sync(dev)
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    keep_at = 2 + (int(seed) & inputs_mod.SEED_MASK) % SAMPLE_SPREAD
    if trace:
        window, summary = traced(lambda: run_pass(spans=True), seconds, dev, keep_at)
    else:
        window, summary = run_window(run_pass, seconds, dev, keep_at), None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    outputs = window.outputs
    version = pass_obj.version
    ctx = reader_context(cell, recipe, inp, pass_obj, window, summary)
    del pass_obj, run_pass, window.outputs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = recipe.expected(cell.problem, inp)
    readings = [compare.numbers(out, ref) for out in outputs.values()]
    failed = sum(not compare.judge(got, cell.limits) for got in readings)
    values = {k: max((got[k] for got in readings),
                     key=lambda v: math.inf if math.isnan(v) else v)
              for k in compare.NAMES}
    del ref, outputs
    parts["reference"] = time.perf_counter() - t
    correct = failed == 0 and compare.judge(values, cell.limits)

    pass_ms = window.pass_ms
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = catalog.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        e2e = {"mvis_s": window.passes * cell.problem.nr_visibilities / window.seconds / 1e6,
               "pass_ms_p95": float(np.percentile(pass_ms, 95)),
               "setup_s": setup_s}
        metrics = {m["name"]: _metric(e2e[m["name"]], m["unit"]) for m in cell.end_to_end}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": cell.chips if dev.type == "cuda" else 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window.passes, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        # both on the profiler's clock: the host's perf_counter and the
        # trace's timestamps drift apart by some hundreds of ppm, more than
        # the card's idle share in a window
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[r["name"], r["total_s"]] for r in summary["ops"][:10]],
            "idle_gaps": [[f"{r['host_cat']} {r['host']}".strip() or "(no host event)", r["s"]]
                          for r in summary["idle_by_host"][:10]],
        }
    result["compared"] = {k: {"value": values[k], "limit": cell.limits[k]}
                          for k in compare.NAMES}

    log(f"cell {cell.name}: config {cell.config_name}, traffic {cell.traffic_name}, "
        f"seed {seed}, {cell.traffic['recipe']} pass on {version}")
    if dev.type == "cuda":
        log(f"card: {power_line()}")
    log("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items() if k != "reference")
        + f"; total {setup_s:.3f}")
    log(f"window: {window.passes} passes in {window.seconds:.3f} s, pass ms median "
        f"{statistics.median(pass_ms):.4f} p95 {np.percentile(pass_ms, 95):.4f} max "
        f"{max(pass_ms):.4f}, enqueue ms mean {1e3 * statistics.mean(window.enqueue_s):.4f}")
    if trace:
        log(f"trace: window {summary['window_s']:.6f} s, busy {summary['busy_s']:.6f} s, "
            f"pass stream span {summary['stream']['span_s']:.6f} s")
    log(f"reference s: {parts['reference']:.3f}")
    for k in compare.NAMES:
        log(f"{k} {values[k]:.6e} limit {cell.limits[k]:.6e}")
    # last, after the reference and the readers: whatever this process
    # loaded since it started, none of it JAX or the JAX package
    found = banned_modules()
    if found:
        raise BannedModules(f"loaded in the reporting process: {', '.join(found)}")
    return result

