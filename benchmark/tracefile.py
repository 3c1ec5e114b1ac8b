"""Reading a torch.profiler Chrome trace: per-op device time, stream idle
share, idle gaps with their host events, and device time by span.

The per-op, per-stream and gap logic is a frozen copy of the port's
``scripts/trace_tools_cuda.py`` (per_op, per_stream, stream_gaps,
idle_by_host), so a later change there cannot move the benchmark's
readings. `span_device_seconds` is the benchmark's own: it attributes each
device operation to the benchmark span whose host launch encloses it,
through the profiler's correlation ids.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"


def load_events(path) -> list:
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


def per_op(device: list) -> list:
    """Rows {name, total_s, count} per device operation name, sorted by
    total."""
    agg = defaultdict(lambda: [0.0, 0])
    for e in device:
        agg[e["name"]][0] += e["dur"]
        agg[e["name"]][1] += 1
    rows = [dict(name=name, total_s=t * 1e-6, count=c) for name, (t, c) in agg.items()]
    return sorted(rows, key=lambda r: -r["total_s"])


def per_stream(device: list) -> list:
    """Rows {device, stream, span_s, busy_s, idle_share, events} per
    (device, stream), the busiest first."""
    by_stream = defaultdict(list)
    for e in device:
        by_stream[_stream_key(e)].append((e["ts"], e["ts"] + e["dur"]))
    rows = []
    for (dev, stream), iv in by_stream.items():
        merged = merge_intervals(iv)
        span = merged[-1][1] - merged[0][0]
        busy = sum(b - a for a, b in merged)
        rows.append(dict(device=dev, stream=stream, span_s=span * 1e-6, busy_s=busy * 1e-6,
                         idle_share=1.0 - busy / span if span > 0 else 0.0, events=len(iv)))
    return sorted(rows, key=lambda r: -r["busy_s"])


def busy_seconds(device: list) -> float:
    """Seconds in which any device operation ran (the union over streams)."""
    return sum(b - a for a, b in merge_intervals(
        (e["ts"], e["ts"] + e["dur"]) for e in device)) * 1e-6


def stream_gaps(device: list, host: list, stream: tuple) -> list:
    """Every gap between the union of `stream`'s device intervals, in time
    order, each {start_us, s, host, host_cat}: the host event that overlaps
    the gap most (the shortest of equals: the innermost)."""
    merged = merge_intervals((e["ts"], e["ts"] + e["dur"]) for e in device
                             if _stream_key(e) == stream)
    pending = sorted(host, key=lambda h: h["ts"])
    i, active, out = 0, [], []
    for a, b in zip(merged, merged[1:]):
        start, end = a[1], b[0]
        if end <= start:
            continue
        while i < len(pending) and pending[i]["ts"] < end:
            active.append(pending[i])
            i += 1
        active = [h for h in active if h["ts"] + h["dur"] > start]
        best = None
        for h in active:
            overlap = min(end, h["ts"] + h["dur"]) - max(start, h["ts"])
            if best is None or (overlap, -h["dur"]) > best[0]:
                best = ((overlap, -h["dur"]), h)
        out.append(dict(start_us=start, s=(end - start) * 1e-6,
                        host=best[1]["name"] if best else "",
                        host_cat=best[1]["cat"] if best else ""))
    return out


def idle_by_host(gaps: list) -> list:
    """Rows {host, host_cat, s, gaps}: the stream's idle time summed by the
    host event each gap falls in, the largest first."""
    agg = defaultdict(lambda: [0.0, 0])
    for g in gaps:
        agg[(g["host_cat"], g["host"])][0] += g["s"]
        agg[(g["host_cat"], g["host"])][1] += 1
    return [dict(host=host, host_cat=cat, s=s, gaps=n)
            for (cat, host), (s, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])]


def span_device_seconds(events: list, prefix: str = "bench.") -> dict:
    """{span name: (device seconds, instances)}: each device operation
    counts for the `prefix` span (a host `record_function` range) that
    encloses, on the same host thread, the launch call sharing its
    correlation id. Operations launched outside every such span count for
    none."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    spans = defaultdict(list)   # (pid, tid) -> [(ts, end, name)]
    counts = defaultdict(int)
    for e in events:
        if e.get("cat") == SPAN_CAT and e["name"].startswith(prefix):
            spans[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e["dur"], e["name"]))
            counts[e["name"]] += 1
    starts = {}
    for key, rows in spans.items():
        rows.sort()
        starts[key] = [r[0] for r in rows]
    seconds = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        key = (launch.get("pid"), launch.get("tid"))
        rows = spans.get(key)
        if not rows:
            continue
        i = bisect.bisect_right(starts[key], launch["ts"]) - 1
        if i >= 0 and launch["ts"] <= rows[i][1]:
            seconds[rows[i][2]] += e["dur"] * 1e-6
    return {name: (seconds.get(name, 0.0), n) for name, n in counts.items()}


def trace_span_seconds(events: list) -> float:
    """Seconds from the first event's start to the last one's end, host and
    device events alike: the traced window on the trace's own clock, which
    holds every device interval."""
    return (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) * 1e-6


def summarize(events: list, top: int = 10) -> dict:
    """What a traced window gives the harness: device events, per-op rows,
    the pass stream's span, busy and idle share, busy seconds over every
    stream, the window's length on the trace's clock, idle time by host
    event, and device seconds by span. Raises ValueError when the trace
    holds no device event."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        raise ValueError("the trace holds no device event; the CUDA activity recorded nothing")
    host = [e for e in events if e.get("cat") in HOST_CATS]
    streams = per_stream(device)
    busiest = (streams[0]["device"], streams[0]["stream"])
    return dict(ops=per_op(device)[:top], stream=streams[0], busy_s=busy_seconds(device),
                window_s=trace_span_seconds(events),
                idle_by_host=idle_by_host(stream_gaps(device, host, busiest))[:top],
                spans=span_device_seconds(events))
