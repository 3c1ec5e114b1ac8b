"""The port's sustained launch window (`utils/timing.py:SustainedResult`,
`time_kernel_sustained`) and `run --sustain S`, on the CPU: the drift on set
chunk times, the refusal without a card, the option's parsing, and the CSV
rows `_perf_one` writes, through a stubbed staging and timers (the window
itself times the card, in chip_smoke.py)."""

import dataclasses

import pytest
import torch

import idg_tpu_torch.ops.api as tapi
import idg_tpu_torch.utils.report as treport
import idg_tpu_torch.utils.timing as ttiming
from idg_tpu_torch import cli
from idg_tpu_torch.config import IDGParams
from idg_tpu_torch.utils.timing import SustainedResult, TimingResult, time_kernel_sustained


def _sustained(*chunks, cls=SustainedResult):
    return cls(seconds=sum(chunks) / len(chunks), launches=10 * len(chunks),
               window_seconds=1.0, chunk_seconds=tuple(chunks))


@pytest.mark.parametrize("chunks,drift", [
    ((0.010, 0.011), 10.0),
    ((0.020, 0.030, 0.015), -25.0),
    ((0.010, 0.012, 0.010), 0.0),
    ((0.010,), 0.0),                # one chunk: no drift to read
    ((0.0, 0.010), 0.0),            # a zero first chunk: none either
])
def test_drift_pct(chunks, drift):
    """The set value, and the JAX package's SustainedResult on the same chunks."""
    from idg_tpu.utils.timing import SustainedResult as JaxSustainedResult

    got = _sustained(*chunks).drift_pct
    assert got == pytest.approx(drift)
    assert got == _sustained(*chunks, cls=JaxSustainedResult).drift_pct


def test_sustained_window_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launched = []
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        time_kernel_sustained(lambda: launched.append(1), duration_s=0.1)
    assert not launched


def test_sustained_window_needs_a_duration():
    with pytest.raises(ValueError, match="duration"):
        time_kernel_sustained(lambda: None, duration_s=0.0)


@pytest.mark.parametrize("argv,want", [
    ([], None),
    (["--sustain", "5"], 5.0),
    (["--sustain", "2.5", "--version", "cuda_v4"], 2.5),
])
def test_run_parses_sustain(monkeypatch, argv, want):
    calls = []
    monkeypatch.setattr(cli, "_perf_one", lambda *a, **kw: calls.append((a, kw)) or 1.0)
    assert cli.main(["run", "--workload", "gridder", *argv]) == 0
    (args, kwargs), = calls
    assert kwargs["sustain_s"] == want
    assert args[:2] == ("gridder", "cuda_v4" if "cuda_v4" in argv else "cuda_v6")


def _read_csv(path):
    with open(path) as f:
        return dict(line.strip().split(",", 1) for line in f)


@pytest.mark.parametrize("sustain", [None, 3.0])
def test_perf_one_writes_the_sustained_rows(monkeypatch, tmp_path, capsys, sustain):
    """_perf_one on a stubbed card: the min-of-windows headline stays the
    CSV's ms, the sustained window adds its four rows (and the console
    line), and W, GFLOP/s/W and MVis/J stay n/a, as in the JAX package."""
    seen = {}

    def fake_runner(workload, version, params, obs, subgrids, w_rank=None, device=None):
        seen["runner"] = (workload, version)
        return (lambda: None), ()

    def fake_sustained(fn, *args, duration_s, harness):
        seen["duration"] = duration_s
        return SustainedResult(seconds=0.0125, launches=400, window_seconds=3.01,
                               chunk_seconds=(0.0120, 0.0125, 0.0126))

    monkeypatch.setenv("OUTPUT_PATH", str(tmp_path))
    monkeypatch.setattr(tapi, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(tapi, "staged_runner", fake_runner)
    monkeypatch.setattr(ttiming, "time_kernel", lambda fn, *a, harness: TimingResult(
        seconds=0.0120, iterations=5, warmup_runs=2, all_seconds=(0.060, 0.061, 0.062)))
    monkeypatch.setattr(ttiming, "time_kernel_sustained", fake_sustained)
    monkeypatch.setattr(treport, "device_name", lambda: "NVIDIA H100 80GB HBM3")
    params = IDGParams(grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
                       nr_timesteps_subgrid=8, nr_channels=4)
    assert cli._perf_one("gridder", "cuda_v6", params=params, sustain_s=sustain) == 0.0120
    assert seen["runner"] == ("gridder", "cuda_v6")
    (csv,) = tmp_path.glob("NVIDIA-H100-80GB-HBM3-gridder_cuda_v6*.csv")
    rows = _read_csv(csv)
    assert float(rows["ms"]) == 12.0
    assert {rows[k] for k in ("W", "GFLOP/s/W", "MVis/J")} == {"n/a"}
    out = capsys.readouterr().out
    if sustain is None:
        assert "duration" not in seen and "sustained_ms" not in rows
        assert "sustained" not in out
        return
    assert seen["duration"] == sustain
    assert float(rows["sustained_ms"]) == 12.5
    assert float(rows["sustain_launches"]) == 400
    assert float(rows["sustain_window_s"]) == 3.01
    assert float(rows["sustain_drift_pct"]) == 5.0
    assert ("sustained 3.0s window: 12.50 ms/launch over 400 launches (min-of-windows "
            "12.00 ms, drift +5.0%)") in out


def test_sustained_result_fields_match_jax():
    """The JAX package's SustainedResult fields, in its order."""
    from idg_tpu.utils.timing import SustainedResult as JaxSustainedResult

    assert [f.name for f in dataclasses.fields(SustainedResult)] == [
        f.name for f in dataclasses.fields(JaxSustainedResult)]
