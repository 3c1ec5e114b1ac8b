"""The trace reader on a recorded toy trace: span attribution through
correlation ids, per-op totals, the stream's idle share, busy seconds and
idle time by host event."""

import json

import pytest

from benchmark import tracefile


def toy_events():
    """Two passes on one host thread (pid 1, tid 7) and one stream (device
    0, stream 7). Pass 1: span bench.gridder [0, 100) launches K1 (corr 1)
    and a fill (corr 2); span bench.grid_add [100, 130) launches K4 (corr
    3). Pass 2 the same from 1000 µs. A launch outside any span (corr 9)
    and a span on another thread must count for nothing."""
    ev = []

    def span(name, ts, dur, tid=7):
        ev.append(dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, pid=1, tid=tid))

    def launch(corr, ts, tid=7):
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=5,
                       pid=1, tid=tid, args={"correlation": corr}))

    def kernel(name, corr, ts, dur, cat="kernel"):
        ev.append(dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=7,
                       args={"correlation": corr, "device": 0, "stream": 7}))

    for base, c in ((0, 0), (1000, 10)):
        span("bench.gridder", base, 100)
        launch(c + 1, base + 10)
        launch(c + 2, base + 50)
        span("bench.grid_add", base + 100, 30)
        launch(c + 3, base + 110)
        kernel("gridder_kernel<32, true>", c + 1, base + 20, 400)
        kernel("Memset (Device)", c + 2, base + 420, 10, cat="gpu_memset")
        kernel("grid_add_kernel", c + 3, base + 430, 50)
    launch(9, 3000)
    kernel("stray", 9, 3010, 5)
    span("bench.gridder", 5000, 10, tid=8)
    ev.append(dict(ph="X", cat="cpu_op", name="aten::empty", ts=470, dur=600, pid=1, tid=7))
    ev.append(dict(ph="i", cat="kernel", name="instant", ts=1, pid=0, tid=7))
    return ev


def test_span_attribution():
    spans = tracefile.span_device_seconds(toy_events())
    # gridder: (400 + 10) µs a pass, 2 passes on tid 7 and one empty span on tid 8
    assert spans["bench.gridder"] == (pytest.approx(820e-6), 3)
    assert spans["bench.grid_add"] == (pytest.approx(100e-6), 2)
    assert set(spans) == {"bench.gridder", "bench.grid_add"}


def test_summary_tables(tmp_path):
    path = tmp_path / "toy.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": toy_events()}))
    events = tracefile.load_events(path)
    assert all(e["ph"] == "X" for e in events)
    s = tracefile.summarize(events)
    ops = {r["name"]: (r["total_s"], r["count"]) for r in s["ops"]}
    assert ops["gridder_kernel<32, true>"] == (pytest.approx(800e-6), 2)
    assert ops["grid_add_kernel"] == (pytest.approx(100e-6), 2)
    assert s["ops"][0]["name"] == "gridder_kernel<32, true>"
    # the stream: busy 2 x 460 + 5 µs, span 20 .. 3015 µs
    assert s["stream"]["busy_s"] == pytest.approx(925e-6)
    assert s["stream"]["span_s"] == pytest.approx(2995e-6)
    assert s["stream"]["idle_share"] == pytest.approx(1 - 925 / 2995)
    assert s["busy_s"] == pytest.approx(925e-6)
    # the window: the first span's start (0) to the span on tid 8's end
    assert s["window_s"] == pytest.approx(5010e-6)
    # gaps: 480..1020 (aten::empty overlaps it most), 1480..3010 (only the
    # stray launch at 3000..3005 overlaps it)
    by_host = {r["host"]: (r["s"], r["gaps"]) for r in s["idle_by_host"]}
    assert by_host["aten::empty"] == (pytest.approx(540e-6), 1)
    assert by_host["cudaLaunchKernel"] == (pytest.approx(1530e-6), 1)


def test_no_device_event_raises():
    with pytest.raises(ValueError):
        tracefile.summarize([dict(ph="X", cat="cpu_op", name="a", ts=0, dur=1)])


def test_merge_intervals():
    assert tracefile.merge_intervals([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
