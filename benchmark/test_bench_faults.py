"""A run with the timed path broken underneath comes out not correct, and
the TF32 control fails the limits the program meets: at a tiny size on the
CPU, where the port runs its plain versions (the harness's look for a card
is skipped by passing the device)."""

import importlib
import json
import sys
import types

import pytest
import torch

from benchmark import catalog, control, harness, tracefile
from benchmark.conftest import tiny_cell
from benchmark.test_bench_trace import toy_events

LAST = {"bench.gridder": "bench.grid_add", "bench.grid_extract": "bench.degridder"}


def unchanged(name, x):
    """The pass's output left as allocated, never written."""
    return torch.zeros_like(x) if name in LAST.values() else x


def half_batch(name, x):
    """Half of the subgrids left out, the mean taken over the rest."""
    if name not in ("bench.gridder", "bench.degridder"):
        return x
    x = x.clone()
    half = x.shape[0] // 2
    x[half:] = 0
    x[:half] *= 2
    return x


def altered(name, x):
    """One answer altered where it is produced: the largest output element
    negated."""
    if name not in LAST.values():
        return x
    flat = x.clone().reshape(-1)
    i = int(flat.abs().argmax())
    flat[i] = -flat[i]
    return flat.reshape(x.shape)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
WORKLOADS = ["default.grid", "default.degrid", "sparse4096.grid", "sparse4096.degrid"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct_and_its_line_has_the_keys(workload, quiet):
    res = harness.run(workload, 2**33 + 5, 0.2, False, device="cpu",
                      cell=tiny_cell(workload), log=quiet)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"mvis_s", "pass_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["compared"]) == {"rms_err", "max_err"}
    json.dumps(res)


@pytest.mark.parametrize("workload", ["default.grid", "default.degrid"])
def test_traced_line_has_busy_within_its_window(workload, quiet, monkeypatch):
    """A traced run's busy_s and window_s both come from the trace, so the
    busy seconds never exceed the window, whatever the host clock read."""
    monkeypatch.setattr(harness, "traced", lambda run_pass, seconds, device, keep_at: (
        harness.run_window(run_pass, seconds, device, keep_at),
        tracefile.summarize([e for e in toy_events() if e["ph"] == "X"])))
    res = harness.run(workload, 2**33 + 7, 0.05, True, device="cpu",
                      cell=tiny_cell(workload), log=quiet)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "compared"]
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert dev["window_s"] == pytest.approx(5010e-6)
    json.dumps(res)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["default.grid", "default.degrid"])
def test_planted_fault_is_not_correct(workload, fault, quiet):
    res = harness.run(workload, 2**33 + 6, 0.1, False, device="cpu",
                      cell=tiny_cell(workload), hook=FAULTS[fault], log=quiet)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("workload", ["default.grid", "default.degrid"])
def test_control_fails_where_the_program_passes(workload):
    cell = tiny_cell(workload)
    for seed in (1, 2, 3):
        row = control.readings(cell, seed, "cpu")
        for name, limit in cell.limits.items():
            assert row["program"][name] < limit / 3
        assert any(row["control"][name] > limit for name, limit in cell.limits.items())


@pytest.fixture
def stub_jax(tmp_path, monkeypatch):
    """A package named jax on the path, importable and empty."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    yield
    sys.modules.pop("jax", None)


def _import_jax():
    importlib.import_module("jax")


@pytest.mark.parametrize("where", ["window", "reader", "reference"])
def test_banned_module_refuses_the_run(where, stub_jax, quiet, monkeypatch):
    """JAX loaded anywhere before the result (by the timed path, by a
    per-layer reader or by the reference) refuses the run."""
    real_recipe = catalog.load_recipe
    if where == "window":
        hook = lambda name, x: (_import_jax(), x)[1]          # noqa: E731
    else:
        hook = None
    if where == "reader":
        def load_reader(metric):
            def read(ctx):
                _import_jax()
                return 1.0
            return read

        monkeypatch.setattr(catalog, "load_reader", load_reader)
        # the traced window without a card: the window itself, and the
        # toy trace's summary for the readers
        monkeypatch.setattr(harness, "traced", lambda run_pass, seconds, device, keep_at: (
            harness.run_window(run_pass, seconds, device, keep_at),
            tracefile.summarize([e for e in toy_events() if e["ph"] == "X"])))
    if where == "reference":
        def load_recipe(name):
            recipe = real_recipe(name)

            def expected(*args, **kwargs):
                _import_jax()
                return recipe.expected(*args, **kwargs)

            return types.SimpleNamespace(**{**vars(recipe), "expected": expected})

        monkeypatch.setattr(catalog, "load_recipe", load_recipe)
    with pytest.raises(harness.BannedModules, match="jax"):
        harness.run("default.grid", 3, 0.05, where == "reader", device="cpu",
                    cell=tiny_cell("default.grid"), hook=hook, log=quiet)
