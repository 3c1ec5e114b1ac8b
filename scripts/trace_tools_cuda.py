#!/usr/bin/env python
"""Per-kernel device time, idle share and idle gaps from a torch.profiler trace.

The port's counterpart of scripts/xplane_tools.py: it reads the Chrome
trace that `torch.profiler`'s `export_chrome_trace` writes, as
idg_tpu_torch/utils/timing.py:time_kernel does for every call when
IDG_PROFILE_DIR is set.

Usage:
  python scripts/trace_tools_cuda.py <trace_dir_or_file> [--all] [--top N]
                                     [--name SUBSTR] [--gaps N] [--json]
  python scripts/trace_tools_cuda.py <trace_dir_or_file> --stats

A directory gives its newest *.pt.trace.json, or with --all every one of
them (each call and each rank writes its own). Prints, per trace:
  - per device operation (kernels, memcpys, memsets): total device ms,
    count, mean ms and share of the device time, sorted by total; each
    hand-written kernel with its K-id (PERF.md's table of TPU kernels);
  - per (device, stream): the span from the first device event's start to
    the last one's end, the busy time (the union of the device intervals)
    and the idle share, 1 - busy/span;
  - the longest idle gaps on the busiest stream, each with the host event
    (cpu_op or cuda_runtime, the innermost of those that overlap it most)
    that the host was in while the card waited and, chosen the same way,
    the port's span (an `idg.*` range, idg_tpu_torch/utils/trace.py) it
    was in, and the stream's idle time summed by host event and span over
    every gap.
--stats lists the `args` keys each event category carries, with an example
value; --json prints the same tables as one JSON line a trace. A trace
with no device event exits non-zero.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict

# event categories of the card's own work, and of the host's
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
# the port's spans: profiler ranges whose names start so
SPAN_CAT, SPAN_PREFIX = "user_annotation", "idg."

# PERF.md's K-id of every __global__ in idg_tpu_torch/csrc/
KERNEL_IDS = {
    "gridder_kernel": "K1",
    "degridder_kernel": "K2",
    "grid_add_kernel": "K4",
    "grid_extract_kernel": "K5",
    "grid_add_pieces_kernel": "K6",
    "grid_add_merged_kernel": "K7",
    "gridder_direct_kernel": "K8a",
    "gridder_sep_v3_kernel": "K8b",
    "gridder_sep_v4_kernel": "K8b",
    "gridder_sep_v5_kernel": "K8c",
    "degridder_direct_kernel": "K9a",
    "degridder_sep_v3_kernel": "K9b",
    "degridder_sep_v4_kernel": "K9b",
    "degridder_sep_v5_kernel": "K9c",
    "degridder_polstack_kernel": "K9d",
    "vadd_kernel": "K10",
    "vadd_scalar": "K10",
    "grid_add_scatter_kernel": "K11a",
    "grid_add_slots_kernel": "K11b",
    "phasor_check_kernel": "K1",   # the check of K1's phasors (tests only)
}

_BASE = re.compile(r"^(?:void\s+)?(?:(?:\(anonymous namespace\)|\w+)::)*(\w+)\s*(?:<(.*?)>)?\s*(?:\(|$)")


def kernel_base(name: str) -> tuple[str, str]:
    """(function name, template arguments) of a demangled kernel name, e.g.
    ('gridder_kernel', '32, true') for 'void (anonymous namespace)::
    gridder_kernel<32, true>(float const*, ...)'; ('', '') when the name
    does not parse."""
    m = _BASE.match(name.strip())
    return (m.group(1), m.group(2) or "") if m else ("", "")


def kernel_id(name: str) -> str:
    """The K-id of a hand-written kernel's trace name, '' for any other."""
    return KERNEL_IDS.get(kernel_base(name)[0], "")


def label(name: str) -> str:
    kid = kernel_id(name)
    return f"{kid} {name}" if kid else name


def find_traces(path: str, every: bool = False) -> list:
    """The trace file `path`, or under the directory `path` the newest
    *.pt.trace.json (every one, oldest first, with `every`)."""
    if os.path.isfile(path):
        return [path]
    hits = sorted(glob.glob(os.path.join(glob.escape(path), "**", "*.pt.trace.json"),
                            recursive=True), key=lambda p: (os.path.getmtime(p), p))
    if not hits:
        raise SystemExit(f"no *.pt.trace.json under {path}")
    return hits if every else hits[-1:]


def load_events(path: str) -> list:
    """The complete ('X') events of a Chrome trace, ts and dur in µs."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _stream_key(e: dict) -> tuple:
    args = e.get("args", {})
    return (args.get("device", e.get("pid")), args.get("stream", e.get("tid")))


def merge_intervals(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def per_op(device: list, name_filter: str = "") -> list:
    """Rows {name, id, total_ms, count, mean_ms, share} per device
    operation name, sorted by total; share is of all device time."""
    agg = defaultdict(lambda: [0.0, 0])
    for e in device:
        agg[e["name"]][0] += e["dur"]
        agg[e["name"]][1] += 1
    total = sum(t for t, _ in agg.values())
    rows = [dict(name=name, id=kernel_id(name), total_ms=t * 1e-3, count=c,
                 mean_ms=t * 1e-3 / c, share=t / total if total else 0.0)
            for name, (t, c) in agg.items()
            if not name_filter or name_filter.lower() in label(name).lower()]
    return sorted(rows, key=lambda r: -r["total_ms"])


def per_stream(device: list) -> list:
    """Rows {device, stream, span_ms, busy_ms, idle_share, events} per
    (device, stream), the busiest first."""
    by_stream = defaultdict(list)
    for e in device:
        by_stream[_stream_key(e)].append((e["ts"], e["ts"] + e["dur"]))
    rows = []
    for (dev, stream), iv in by_stream.items():
        merged = merge_intervals(iv)
        span = merged[-1][1] - merged[0][0]
        busy = sum(b - a for a, b in merged)
        rows.append(dict(device=dev, stream=stream, span_ms=span * 1e-3, busy_ms=busy * 1e-3,
                         idle_share=1.0 - busy / span if span > 0 else 0.0, events=len(iv)))
    return sorted(rows, key=lambda r: -r["busy_ms"])


def _most_overlapping(intervals: list, events: list) -> list:
    """For each (start, end) of the sorted disjoint `intervals`, the event
    that overlaps it most (the shortest of equals: the innermost), or None.
    One sweep: an event joins the candidates when it starts before an
    interval's end and leaves them once it ends before an interval's start."""
    pending = sorted(events, key=lambda h: h["ts"])
    i, active, out = 0, [], []
    for start, end in intervals:
        while i < len(pending) and pending[i]["ts"] < end:
            active.append(pending[i])
            i += 1
        active = [h for h in active if h["ts"] + h["dur"] > start]
        best = None
        for h in active:
            overlap = min(end, h["ts"] + h["dur"]) - max(start, h["ts"])
            if best is None or (overlap, -h["dur"]) > best[0]:
                best = ((overlap, -h["dur"]), h)
        out.append(best[1] if best else None)
    return out


def stream_gaps(device: list, host: list, stream: tuple, spans: list = ()) -> list:
    """Every gap between the union of `stream`'s device intervals, in time
    order, each {start_us, ms, host, host_cat, span}: the host event and the
    port's span (of `spans`, '' for none) that overlap the gap most."""
    merged = merge_intervals((e["ts"], e["ts"] + e["dur"]) for e in device
                             if _stream_key(e) == stream)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    return [dict(start_us=start, ms=(end - start) * 1e-3, host=h["name"] if h else "",
                 host_cat=h["cat"] if h else "", span=sp["name"] if sp else "")
            for (start, end), h, sp in zip(gaps, _most_overlapping(gaps, host),
                                           _most_overlapping(gaps, list(spans)))]


def idle_by_host(gaps: list) -> list:
    """Rows {host, host_cat, span, ms, gaps}: the stream's idle time summed
    by the host event and the port's span each gap falls in, the largest
    first."""
    agg = defaultdict(lambda: [0.0, 0])
    for g in gaps:
        key = (g["host_cat"], g["host"], g["span"])
        agg[key][0] += g["ms"]
        agg[key][1] += 1
    return [dict(host=host, host_cat=cat, span=span, ms=ms, gaps=n)
            for (cat, host, span), (ms, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])]


def arg_stats(events: list) -> dict:
    """{cat: {args key: example value}}: what each category records."""
    seen = defaultdict(dict)
    for e in events:
        for key, value in e.get("args", {}).items():
            seen[e.get("cat", "")].setdefault(key, value)
    return seen


def summarize(path: str, top: int = 25, name_filter: str = "", gaps: int = 5) -> dict:
    """The tables of one trace; raises ValueError when it has no device
    event (the CUDA activity recorded nothing)."""
    events = load_events(path)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        raise ValueError(f"{path}: no device event ({', '.join(DEVICE_CATS)}); the CUDA "
                         "activity recorded nothing")
    host = [e for e in events if e.get("cat") in HOST_CATS]
    spans = [e for e in events
             if e.get("cat") == SPAN_CAT and e["name"].startswith(SPAN_PREFIX)]
    streams = per_stream(device)
    busiest = (streams[0]["device"], streams[0]["stream"])
    every_gap = stream_gaps(device, host, busiest, spans)
    return dict(trace=path, device_ms=sum(e["dur"] for e in device) * 1e-3,
                ops=per_op(device, name_filter)[:top], streams=streams,
                gaps=sorted(every_gap, key=lambda g: -g["ms"])[:gaps],
                idle_by_host=idle_by_host(every_gap)[:top],
                gap_stream=dict(device=busiest[0], stream=busiest[1]))


def where(gap: dict) -> str:
    """A gap's (or row's) host event, then the port's span it was in."""
    host = f"{gap['host_cat']} {gap['host']}" if gap["host"] else "(no host event)"
    return f"{host} [{gap['span']}]" if gap["span"] else host


def print_summary(s: dict) -> None:
    print(f"trace: {s['trace']}")
    print(f"\n== device operations: {s['device_ms']:.3f} ms in all")
    for r in s["ops"]:
        print(f"  {r['total_ms']:10.3f} ms ×{r['count']:<7d} mean {r['mean_ms']:8.3f} ms "
              f"{100 * r['share']:5.1f}%  {label(r['name'])[:100]}")
    print("\n== streams (device, stream): span, busy, idle share")
    for r in s["streams"]:
        print(f"  ({r['device']}, {r['stream']}): span {r['span_ms']:.3f} ms, busy "
              f"{r['busy_ms']:.3f} ms, idle {100 * r['idle_share']:.2f}% "
              f"({r['events']} events)")
    g = s["gap_stream"]
    print(f"\n== longest idle gaps on ({g['device']}, {g['stream']})")
    for r in s["gaps"]:
        print(f"  {r['ms']:10.3f} ms at {r['start_us']:.1f} us: {where(r)[:120]}")
    print(f"\n== idle time by host event and span on ({g['device']}, {g['stream']})")
    for r in s["idle_by_host"]:
        print(f"  {r['ms']:10.3f} ms in {r['gaps']:6d} gaps: {where(r)[:120]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="trace directory or .pt.trace.json file")
    ap.add_argument("--all", action="store_true", help="every trace under the directory")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--name", default="", help="device operation filter (substring)")
    ap.add_argument("--gaps", type=int, default=5, help="longest idle gaps to list")
    ap.add_argument("--stats", action="store_true",
                    help="list the args keys each event category records")
    ap.add_argument("--json", action="store_true", help="one JSON line a trace")
    args = ap.parse_args(argv)

    for path in find_traces(args.path, args.all):
        if args.stats:
            print(f"trace: {path}")
            for cat, keys in sorted(arg_stats(load_events(path)).items()):
                print(f"  {cat or '(no cat)'}:")
                for key, value in sorted(keys.items()):
                    print(f"    {key} = {str(value)[:70]}")
            continue
        try:
            s = summarize(path, args.top, args.name, args.gaps)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(s))
            continue
        print_summary(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
