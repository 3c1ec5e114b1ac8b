"""The port's tracing (idg_tpu_torch/utils/trace.py: spans, the
probe accumulators, trace_window; time_kernel's IDG_PROFILE_DIR), its
reader scripts/trace_tools_cuda.py, the renderer
scripts/results_table_cuda.py and the sweep scripts, on the CPU.

The reader is held to exact tables on a hand-written Chrome trace (two
streams, overlapping kernels, a memcpy, a memset, known gaps, nested host
events and spans), and parses the real torch.profiler output of this torch
version, the port's spans in it.
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from idg_tpu_torch.utils import timing as ttiming
from idg_tpu_torch.utils import trace as ttrace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tools = _script("trace_tools_cuda")
table = _script("results_table_cuda")

K1 = "void (anonymous namespace)::gridder_kernel<32, true>(float const*, float2 const*, int)"
K4 = "void (anonymous namespace)::grid_add_kernel<32>(float4 const*, int2 const*, float2*)"
FILL = ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
        "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)")
COPY = "Memcpy DtoH (Device -> Pageable)"


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def synthetic_events():
    """Stream (0, 7): K1 [100, 150] and K4 [140, 160] overlapping, a memcpy
    [200, 210], K1 [300, 350]: busy 120 of a 250 µs span, gaps 40 µs at 160
    and 90 µs at 210. Stream (0, 13): an aten fill [170, 180] and a memset
    [400, 405]. Host: the first gap is covered by a cpu_op and, as fully, by
    the cuda_runtime call nested in it (the innermost is named); the second
    gap overlaps a cpu_op for 90 µs and the cuda_runtime call inside it for
    70 (the larger overlap is named), and lies inside the port's span
    idg.grid_add, which it overlaps for 90 µs, and its child
    idg.kernel.grid_add, for 85 (the larger overlap is named). The first
    gap lies in no span of the port."""
    host = dict(pid=4242, tid=4242)
    return [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        _x("kernel", K1, 100.0, 50.0, device=0, stream=7, correlation=1),
        _x("kernel", K4, 140.0, 20.0, device=0, stream=7, correlation=2),
        _x("gpu_memcpy", COPY, 200.0, 10.0, device=0, stream=7, bytes=4096),
        _x("kernel", K1, 300.0, 50.0, device=0, stream=7, correlation=3),
        _x("kernel", FILL, 170.0, 10.0, pid=0, tid=13, device=0, stream=13),
        _x("gpu_memset", "Memset (Device)", 400.0, 5.0, pid=0, tid=13, device=0, stream=13),
        _x("gpu_user_annotation", "pass_fn", 100.0, 250.0, device=0, stream=7),
        _x("cpu_op", "aten::mm", 10.0, 5.0, flops=2.0e6, **host),
        _x("cpu_op", "outer_op", 150.0, 45.0, **host),
        _x("cuda_runtime", "cudaLaunchKernel", 155.0, 40.0, correlation=9, **host),
        _x("cpu_op", "aten::copy_", 195.0, 20.0, **host),
        _x("cuda_runtime", "cudaMemcpyAsync", 196.0, 18.0, **host),
        _x("cpu_op", "aten::nonzero", 205.0, 100.0, **host),
        _x("cuda_runtime", "cudaStreamSynchronize", 220.0, 70.0, **host),
        _x("user_annotation", "ProfilerStep", 0.0, 500.0, **host),
        _x("user_annotation", "idg.grid_add", 205.0, 120.0, **host),
        _x("user_annotation", "idg.kernel.grid_add", 208.0, 87.0, **host),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 4242, "tid": 4242, "ts": 155.0},
    ]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "1-r0-0-pass_fn.pt.trace.json"
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": synthetic_events()}))
    return str(path)


def test_reader_tables_on_a_synthetic_trace(trace):
    s = tools.summarize(trace)
    assert s["device_ms"] == pytest.approx(0.145)
    ops = {r["name"]: r for r in s["ops"]}
    assert list(ops) == [K1, K4, COPY, FILL, "Memset (Device)"]
    assert (ops[K1]["count"], ops[K1]["total_ms"], ops[K1]["mean_ms"]) == (2, 0.1, 0.05)
    assert ops[K1]["share"] == pytest.approx(100 / 145)
    assert [ops[n]["id"] for n in ops] == ["K1", "K4", "", "", ""]
    assert [ops[n]["count"] for n in ops] == [2, 1, 1, 1, 1]
    assert [ops[n]["total_ms"] for n in ops] == pytest.approx([0.1, 0.02, 0.01, 0.01, 0.005])

    busiest, other = s["streams"]
    assert (busiest["device"], busiest["stream"], busiest["events"]) == (0, 7, 4)
    assert busiest["span_ms"] == pytest.approx(0.25)
    assert busiest["busy_ms"] == pytest.approx(0.12)     # K1 and K4 overlap: counted once
    assert busiest["idle_share"] == pytest.approx(0.52)
    assert (other["stream"], other["events"]) == (13, 2)
    assert other["span_ms"] == pytest.approx(0.235)
    assert other["idle_share"] == pytest.approx(1 - 15 / 235)

    assert s["gap_stream"] == {"device": 0, "stream": 7}
    assert [(g["start_us"], g["ms"]) for g in s["gaps"]] == [(210.0, pytest.approx(0.09)),
                                                             (160.0, pytest.approx(0.04))]
    assert [(g["host_cat"], g["host"], g["span"]) for g in s["gaps"]] == [
        ("cpu_op", "aten::nonzero", "idg.grid_add"), ("cuda_runtime", "cudaLaunchKernel", "")]
    assert s["idle_by_host"] == [
        {"host": "aten::nonzero", "host_cat": "cpu_op", "span": "idg.grid_add",
         "ms": pytest.approx(0.09), "gaps": 1},
        {"host": "cudaLaunchKernel", "host_cat": "cuda_runtime", "span": "",
         "ms": pytest.approx(0.04), "gaps": 1}]


def test_gaps_by_host_over_many_gaps():
    """Every gap of a stream, in time order, against the brute-force
    reckoning of each gap's host event; the idle time summed by host event."""
    import random

    rng = random.Random(7)
    device, host, t = [], [], 0.0
    for _ in range(300):
        dur = rng.uniform(1, 20)
        device.append(_x("kernel", "k", t, dur, device=0, stream=7))
        t += dur + rng.choice([0.0, rng.uniform(0.5, 30)])
    for _ in range(400):
        ts = rng.uniform(-50, t + 50)
        host.append(_x(rng.choice(tools.HOST_CATS), f"h{rng.randrange(12)}", ts,
                       rng.uniform(0.1, 400), pid=1, tid=1))
    spans = [_x("user_annotation", f"idg.s{i}", rng.uniform(-50, t + 50), rng.uniform(0.1, 400),
                pid=1, tid=1) for i in range(60)]
    gaps = tools.stream_gaps(device, host, (0, 7), spans)
    merged = tools.merge_intervals((e["ts"], e["ts"] + e["dur"]) for e in device)
    want = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    assert [(g["start_us"], g["ms"]) for g in gaps] == [
        (a, pytest.approx((b - a) * 1e-3)) for a, b in want]
    for g, (a, b) in zip(gaps, want):
        scored = [((min(b, h["ts"] + h["dur"]) - max(a, h["ts"]), -h["dur"]), h["name"])
                  for h in host if min(b, h["ts"] + h["dur"]) > max(a, h["ts"])]
        assert g["host"] == (max(scored)[1] if scored else "")
        scored = [((min(b, h["ts"] + h["dur"]) - max(a, h["ts"]), -h["dur"]), h["name"])
                  for h in spans if min(b, h["ts"] + h["dur"]) > max(a, h["ts"])]
        assert g["span"] == (max(scored)[1] if scored else "")
    by_host = tools.idle_by_host(gaps)
    assert sum(r["gaps"] for r in by_host) == len(gaps)
    assert sum(r["ms"] for r in by_host) == pytest.approx(sum(g["ms"] for g in gaps))
    assert [r["ms"] for r in by_host] == sorted((r["ms"] for r in by_host), reverse=True)


def test_reader_filters_and_limits(trace):
    s = tools.summarize(trace, top=1, name_filter="k4", gaps=1)
    assert [r["name"] for r in s["ops"]] == [K4]
    assert s["ops"][0]["share"] == pytest.approx(20 / 145)   # of all device time
    assert len(s["gaps"]) == 1 and s["gaps"][0]["ms"] == pytest.approx(0.09)


def test_reader_json_and_console(trace, capsys):
    assert tools.main([trace, "--json"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line) == json.loads(json.dumps(tools.summarize(trace)))
    assert tools.main([os.path.dirname(trace), "--gaps", "2"]) == 0
    out = capsys.readouterr().out
    assert f"K1 {K1}"[:100] in out and "idle 52.00%" in out
    assert "cuda_runtime cudaLaunchKernel" in out and "cpu_op aten::nonzero [idg.grid_add]" in out


def test_reader_stats_and_flops(trace, capsys):
    """--stats lists each category's args keys; --flops is gone."""
    stats = tools.arg_stats(tools.load_events(trace))
    assert stats["kernel"]["correlation"] == 1 and stats["gpu_memcpy"]["bytes"] == 4096
    assert stats["cpu_op"]["flops"] == 2.0e6
    assert tools.main([trace, "--stats"]) == 0
    out = capsys.readouterr().out
    assert "correlation = 1" in out and "flops = 2000000.0" in out
    with pytest.raises(SystemExit):
        tools.main([trace, "--flops"])


def test_reader_picks_the_newest_trace_or_all(tmp_path):
    paths = []
    for i, events in enumerate((synthetic_events()[:2], synthetic_events())):
        p = tmp_path / "sub" / f"9-r0-{i}-fn.pt.trace.json"
        p.parent.mkdir(exist_ok=True)
        p.write_text(json.dumps({"traceEvents": events}))
        os.utime(p, (1000 + i, 1000 + i))
        paths.append(str(p))
    assert tools.find_traces(str(tmp_path)) == paths[1:]
    assert tools.find_traces(str(tmp_path), every=True) == paths
    assert tools.find_traces(paths[0]) == paths[:1]
    with pytest.raises(SystemExit, match="no \\*.pt.trace.json"):
        tools.find_traces(str(tmp_path / "sub" / "none"))


def test_reader_exits_nonzero_without_device_events(tmp_path):
    path = tmp_path / "host-only.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": [e for e in synthetic_events()
                                                if e.get("cat") not in tools.DEVICE_CATS]}))
    with pytest.raises(ValueError, match="no device event"):
        tools.summarize(str(path))
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "trace_tools_cuda.py"),
                          str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 1 and "no device event" in out.stderr and out.stdout == ""


@pytest.mark.parametrize("name, base, kid", [
    (K1, ("gridder_kernel", "32, true"), "K1"),
    (K4, ("grid_add_kernel", "32"), "K4"),
    ("void (anonymous namespace)::degridder_kernel<16, (bool)1>(float const*)",
     ("degridder_kernel", "16, (bool)1"), "K2"),
    ("void (anonymous namespace)::vadd_scalar(float const*, float const*, float*, long long)",
     ("vadd_scalar", ""), "K10"),
    (FILL, ("vectorized_elementwise_kernel",
            "4, at::native::FillFunctor<float>, std::array<char*, 1ul> "), ""),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", ""), ""),
    (COPY, ("", ""), ""),
])
def test_kernel_names_and_ids(name, base, kid):
    assert tools.kernel_base(name) == base
    assert tools.kernel_id(name) == kid


def test_kernel_ids_cover_every_global_in_csrc():
    names = set()
    for src in (ROOT / "idg_tpu_torch" / "csrc").glob("*.cu*"):
        code = re.sub(r"//[^\n]*", "", src.read_text())
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                code))
    assert len(names) >= 19
    assert names == set(tools.KERNEL_IDS)
    assert set(tools.KERNEL_IDS.values()) == {
        "K1", "K2", "K4", "K5", "K6", "K7", "K8a", "K8b", "K8c", "K9a", "K9b", "K9c", "K9d",
        "K10", "K11a", "K11b"}


def test_trace_window_writes_one_file_a_call_and_rank(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    a = torch.randn(16, 16)
    paths = []
    for lab in ("pass_fn", "<lambda>"):
        with ttiming.trace_window(str(tmp_path), lab) as path:
            (a @ a).sum()
        paths.append(path)
    monkeypatch.setenv("RANK", "3")
    with ttiming.trace_window(str(tmp_path), "kfn") as path:
        a + 1
    paths.append(path)
    pid = os.getpid()
    assert [os.path.basename(p) for p in paths] == [
        f"{pid}-r0-0-pass_fn.pt.trace.json", f"{pid}-r0-1-lambda.pt.trace.json",
        f"{pid}-r3-0-kfn.pt.trace.json"]
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(p) for p in paths)
    events = tools.load_events(paths[0])      # the real profiler output parses
    mm = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    assert len(mm) == 1
    with pytest.raises(ValueError, match="no device event"):   # a CPU run records no device
        tools.summarize(paths[0])


def test_trace_window_off_or_raising_writes_nothing(tmp_path):
    with ttiming.trace_window(None, "fn") as path:
        pass
    assert path is None
    with pytest.raises(ZeroDivisionError):
        with ttiming.trace_window(str(tmp_path / "t"), "fn"):
            1 / 0
    assert not any((tmp_path / "t").iterdir())


def test_time_kernel_traced_without_a_card_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("IDG_PROFILE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        ttiming.time_kernel(lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        ttiming.time_kernel(lambda: None, profile_dir=str(tmp_path / "x"))
    assert list(tmp_path.iterdir()) == []


def test_time_kernel_traces_the_timed_windows_only(tmp_path, monkeypatch):
    """With the card's clock stubbed, the trace holds exactly the calls of
    the timed windows, the calibration's included, and none of the first
    call or the warm-ups; without IDG_PROFILE_DIR no file is written."""
    answers = iter([True])    # time_kernel's own check sees a card; the profiler does not
    monkeypatch.setattr(torch.cuda, "is_available", lambda: next(answers, False))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def device_seconds(fn, args, iters):
        for _ in range(iters):
            fn(*args)
        return iters * 0.004

    monkeypatch.setattr(ttiming, "_device_seconds", device_seconds)
    monkeypatch.setenv("IDG_PROFILE_DIR", str(tmp_path))
    x = torch.ones(4)

    def pass_fn(t):
        return t + 1

    res = ttiming.time_kernel(pass_fn, x, harness=ttiming.HarnessConfig(
        nr_warm_up_runs=2, nr_iterations=5, nr_windows=3))
    assert res.timed_windows == ((5, 0.02), (15, 0.06), (15, 0.06), (15, 0.06))
    assert (res.iterations, res.all_seconds) == (15, (0.06, 0.06, 0.06))
    (path,) = tmp_path.iterdir()
    assert path.name == f"{os.getpid()}-r0-0-pass_fn.pt.trace.json"
    adds = [e for e in tools.load_events(str(path)) if e["name"] == "aten::add"]
    assert len(adds) == 50

    monkeypatch.delenv("IDG_PROFILE_DIR")
    answers = iter([True])
    ttiming.time_kernel(pass_fn, x, harness=ttiming.HarnessConfig(
        nr_warm_up_runs=0, nr_iterations=20, nr_windows=1))
    assert len(list(tmp_path.iterdir())) == 1


def _csv(path, rows):
    path.write_text("".join(f"{k},{v}\n" for k, v in rows))


def test_results_table_cuda(tmp_path, capsys):
    dev = "NVIDIA-H100-80GB-HBM3"
    _csv(tmp_path / f"{dev}-gridder_cuda_v6-cuda.csv",
         [("ms", "45.60"), ("ms_stddev", "0.0123"), ("GFLOP/s", "39000.00"), ("GB/s", "10.00"),
          ("FLOP/Byte", "3.90"), ("MVis/s", "1101.00"), ("roofline_pct", "7.88"), ("W", "n/a")])
    _csv(tmp_path / f"{dev}-pipeline_degrid_cuda_v7_nofuse-cuda.csv",
         [("ms", "31.00"), ("MVis/s", "1600.00"), ("grid_stage_ms", "0.40")])
    _csv(tmp_path / f"{dev}-pipeline_cuda_v6_lofar4096-cuda.csv", [("ms", "13.78")])
    _csv(tmp_path / f"{dev}-grid_add_ranges_lofar4096-cuda.csv", [("ms", "0.35"), ("GB/s", "9")])
    _csv(tmp_path / f"{dev}-vadd_cuda-cuda.csv", [("ms", "1.04"), ("GB/s", "3090.00")])
    _csv(tmp_path / "TPU-v5-lite-gridder_pallas_v6-tpu.csv", [("ms", "60.0")])
    _csv(tmp_path / f"{dev}-notes-cuda.csv", [("ms", "1")])
    assert table.main(["--dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:2] == ["| benchmark | ms | ±ms | MVis/s | GFLOP/s | GB/s | roofline % |",
                         "|---|---|---|---|---|---|---|"]
    assert lines[2:] == [
        "| grid_add_ranges_lofar4096 | 0.35 |  |  |  | 9 |  |",
        "| gridder_cuda_v6 | 45.60 | 0.0123 | 1101.00 | 39000.00 | 10.00 | 7.88 |",
        "| pipeline_cuda_v6_lofar4096 | 13.78 |  |  |  |  |  |",
        "| pipeline_degrid_cuda_v7_nofuse | 31.00 |  | 1600.00 |  |  |  |",
        "| vadd_cuda | 1.04 |  |  |  | 3090.00 |  |"]
    assert table.main(["--dir", str(tmp_path), "--filter", "pipeline"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 4


def test_sweep_scripts(tmp_path):
    env = {**os.environ, "OUTPUT_PATH": str(tmp_path), "PYTHONPATH": str(ROOT)}
    env.pop("IDG_PROFILE_DIR", None)
    perf = subprocess.run(["bash", str(ROOT / "scripts" / "run_perf_cuda.sh")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert perf.returncode == 2 and "no CUDA device is visible" in perf.stderr
    check = subprocess.run(["bash", str(ROOT / "scripts" / "run_check_cuda.sh"),
                            "--device", "cpu"], env=env, capture_output=True, text=True,
                           timeout=600)
    assert check.returncode == 0, check.stdout[-3000:] + check.stderr[-3000:]
    assert check.stdout.count(">>> Result PASSED") == 25
    assert list(tmp_path.iterdir()) == []


def _clock(monkeypatch, ticks):
    """perf_counter_ns as the given ticks, in order."""
    it = iter(ticks)
    monkeypatch.setattr(ttrace.time, "perf_counter_ns", lambda: next(it))


def test_span_nesting_parent_and_self_time(monkeypatch):
    """Spans nest on their thread. Each adds its own duration, its
    children's inside it, to its name's count, total and median; only a span
    with no parent on its thread adds to its name's top-level time; the
    median is of the newest SAMPLES durations."""
    tracer = ttrace.Tracer()
    a, b = ttrace.span("a", tracer), ttrace.span("b", tracer)

    @ttrace.span("c", tracer)
    def c():
        return 7

    _clock(monkeypatch, [0, 10, 15, 20, 26, 40, 50, 53])
    with a:               # 0 .. 40
        with b:           # 10 .. 15
            pass
        assert c() == 7   # 20 .. 26
    with b:               # 50 .. 53
        pass
    agg = tracer.snapshot()["spans"]
    assert agg["a"] == pytest.approx(dict(count=1, total_s=40e-9, top_s=40e-9, median_s=40e-9))
    assert agg["b"] == pytest.approx(dict(count=2, total_s=8e-9, top_s=3e-9, median_s=4e-9))
    assert agg["c"] == pytest.approx(dict(count=1, total_s=6e-9, top_s=0.0, median_s=6e-9))
    assert c.__name__ == "c" and c.__wrapped__() == 7

    monkeypatch.setattr(ttrace, "SAMPLES", 2)
    newest = ttrace.Tracer()
    _clock(monkeypatch, [0, 1, 10, 15, 20, 29])
    for _ in range(3):
        with ttrace.span("d", newest):
            pass
    assert newest.snapshot()["spans"]["d"] == pytest.approx(dict(
        count=3, total_s=15e-9, top_s=15e-9, median_s=7e-9))

    seen = []                       # another thread's span has no parent there
    _clock(monkeypatch, [100, 200, 205, 300])
    with a:
        worker = threading.Thread(target=lambda: seen.append(b.__enter__()) or b.__exit__())
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive() and seen
    assert tracer.snapshot()["spans"]["b"]["top_s"] == pytest.approx(8e-9)
    tracer.reset()
    assert tracer.snapshot() == dict(spans={}, probes={})


def test_spans_open_profiler_ranges_only_while_profiling(monkeypatch):
    opened = []

    class Counted:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            opened.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    tracer = ttrace.Tracer()
    for _ in range(3):
        with ttrace.span("idg.x", tracer), ttrace.span("idg.y", tracer):
            pass
    assert opened == [] and not ttrace.profiling()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert ttrace.profiling()
        for _ in range(3):
            with ttrace.span("idg.x", tracer), ttrace.span("idg.y", tracer):
                pass
    assert opened == ["idg.x", "idg.y"] * 3
    assert tracer.snapshot()["spans"]["idg.y"]["count"] == 6


def test_cpu_pass_under_trace_window_holds_the_pass_spans(tmp_path):
    """A gridded pass of the plain path inside trace_window: the trace holds
    the port's spans as profiler ranges, idg.gridder then idg.grid_add with
    idg.kernel.grid_add inside it, and the aggregates count the pass spans
    at top level and the kernel's inside them."""
    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import make_observation
    from idg_tpu_torch.ops.api import gridded_pipeline_parts
    from idg_tpu_torch.ops.grid import sort_observation_blocks

    params = IDGParams(grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
                       nr_timesteps_subgrid=8, nr_channels=4)
    ttrace.reset()
    obs, _ = sort_observation_blocks(make_observation(params)[0], params.grid_size,
                                     params.subgrid_size)
    pfn, pargs, gfn, _, _ = gridded_pipeline_parts(params, obs, device="cpu")
    with ttrace.trace_window(str(tmp_path), "pass") as path:
        grid = gfn(pfn(*pargs))
    assert tuple(grid.shape) == (4, 128, 128)
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in tools.load_events(path)
              if e.get("cat") == "user_annotation" and e["name"].startswith("idg.")}
    assert set(ranges) == {"idg.gridder", "idg.grid_add", "idg.kernel.grid_add"}
    assert ranges["idg.gridder"][1] <= ranges["idg.grid_add"][0]
    assert (ranges["idg.grid_add"][0] <= ranges["idg.kernel.grid_add"][0]
            and ranges["idg.kernel.grid_add"][1] <= ranges["idg.grid_add"][1])
    snap = ttrace.snapshot()
    spans = snap["spans"]
    assert spans["idg.kernel.grid_add"]["top_s"] == 0.0
    for name in ("idg.gridder", "idg.grid_add"):
        assert spans[name]["count"] == 1 and spans[name]["top_s"] == spans[name]["total_s"] > 0
    assert {"idg.plan.sort_blocks", "idg.plan.ranges", "idg.plan.rolls", "idg.stage.resolve",
            "idg.stage.copy"} <= set(spans)
    assert snap["probes"] == {}
    ttrace.reset()


def test_snapshot_decodes_a_probe_accumulator():
    """A probe accumulator is handed out only while a profiler records, for
    the first of every PROBE_EVERY calls of a kernel on a device; snapshot()
    names its fields, sums a kernel's devices and counts its probed
    launches; reset() drops it."""
    tracer = ttrace.Tracer()
    assert tracer.probe("k", "cpu") is None
    every = ttrace.PROBE_EVERY
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [tracer.probe("k", "cpu") for _ in range(2 * every + 1)]
        meta = tracer.probe("k", torch.device("meta"))
    buf = got[0]
    assert [g is buf for g in got] == ([True] + [False] * (every - 1)) * 2 + [True]
    assert all(g is None for g in got if g is not buf)
    assert ttrace.PROBE_FIELDS[-2:] == ("form_tiles", "form_fast")
    assert buf.dtype == torch.int64 and buf.tolist() == [0] * len(ttrace.PROBE_FIELDS) == [0] * 8
    buf.copy_(torch.tensor([5_000_000_000, 70, 4_000, 1_500, 900, 24_500, 12_544_000,
                            12_543_990]))
    assert meta.device.type == "meta"
    tracer.probes[("k", torch.device("meta"))] = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8])
    assert tracer.snapshot()["probes"] == {"k": dict(
        total=5_000_000_001, k3=72, loop=4_003, tc_wait=1_504, form_wait=905, blocks=24_506,
        form_tiles=12_544_007, form_fast=12_543_998, launches=4)}
    tracer.reset()
    assert tracer.snapshot()["probes"] == {}


@pytest.mark.parametrize("probes,want", [
    ({"gridder_cuda_v6_pieces": dict(total=9, form_tiles=12_544_000, form_fast=12_543_000)},
     100.0 * 12_543_000 / 12_544_000),
    ({"gridder_cuda_v6_pieces": dict(form_tiles=800, form_fast=800)}, 100.0),
    ({"gridder_cuda_v6_pieces": dict(form_tiles=0, form_fast=0)}, None),
    ({"degridder_cuda_v7_fused": dict(form_tiles=0, form_fast=0)}, None),
    ({"gridder_cuda_v6_pieces": dict(total=9, k3=1, loop=5, tc_wait=1, form_wait=1,
                                     blocks=1)}, None),
    ({}, None),
], ids=["fallbacks", "all-fast", "no-formation", "no-gridder-probe", "older-probes",
        "no-probed-launch"])
def test_gridder_form_fast_pct_reads_the_probe_counts(monkeypatch, probes, want):
    """benchmark/metrics/gridder_form_fast_pct.py: 100 · Σform_fast /
    Σform_tiles of the fused K1's probe sums; None where no probed K1
    launch ran, where it formed nothing, or where the probes lack the two
    counts (a program before them)."""
    from benchmark import catalog

    monkeypatch.setattr(ttrace, "snapshot", lambda: dict(spans={}, probes=probes))
    got = catalog.load_reader("gridder_form_fast_pct")(None)
    assert got == (None if want is None else pytest.approx(want))


def test_guard_warnings_name_the_callers_line():
    """ops/api.py:_resolve runs inside its span, and its warnings still
    name the line that called the API (here cuda_v2 on non-uniform
    channels, falling back to cuda_v1)."""
    import dataclasses
    import warnings

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import make_observation
    from idg_tpu_torch.ops.api import run_gridder

    params = IDGParams(grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
                       nr_timesteps_subgrid=8, nr_channels=4)
    obs, _ = make_observation(params)
    k = np.array(obs.wavenumbers, copy=True)
    k[-1] *= 1.05
    obs = dataclasses.replace(obs, wavenumbers=k)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        line = sys._getframe().f_lineno + 1
        out = run_gridder(params, obs, version="cuda_v2", device="cpu")
    assert tuple(out.shape) == (obs.uvw.shape[0], 4, 16, 16)
    falls = [w for w in caught if "falling back to cuda_v1" in str(w.message)]
    assert [(w.filename, w.lineno) for w in falls] == [(__file__, line)]
