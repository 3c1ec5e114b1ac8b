"""The port's pol-stacked degridder `cuda_v6` (K9d's plain version), its
"3x2k" precision policy and its guard, against the JAX package's
`pallas_v6` and the f64 oracle on identical numpy inputs, at small sizes on
the CPU; and the two host pieces that came with it: the bench's version
knobs and the roofline row.

On a CPU staging `degridder_cuda_v6` runs its plain PyTorch version, which
takes the kernel's bf16 splits and all four split products ("3x2k") for the
signal; the JAX side runs `pallas_v6` through `idg_tpu.ops.api` in Pallas
interpret mode. JAX's pol-stacked product takes its "default" rank-1 pass
on bf16 operands even on the CPU (degridder.py:773-775), so both sides
compute the TPU's single bf16 pass there, and w_scale 45 (rank 2, μ ≠ 0)
shows no gap of its own.

Gates: the reference's 1e-5 normalized-RMS comparator against the oracle;
against JAX 2e-6 of the same metric. Observed on the CPU: against JAX
8.0e-7 at w = 0, the default w, w_scale 45 and w_scale 1000 (rank 4), and
9.7e-7 at C = 48 (the recurrence resyncs at c = 16 and 32); the two sides
differ in their sin/cos and summation order, which moves some values
across a bf16 rounding boundary of the split. Against the oracle 3.3e-6 to
4.2e-6, as JAX's own (3.4e-6 to 4.2e-6): the split's 2⁻¹⁷ representation
error. The CUDA kernel meets this plain version on the card, in
`-m cuda tests/test_torch_cuda.py`.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import idg_tpu.data as jdata
import idg_tpu.ops.api as japi
import idg_tpu_torch.config as tcfg
import idg_tpu_torch.ops.api as tapi
from idg_tpu.ops.pallas.degridder import degridder_precisions as jax_degridder_precisions
from idg_tpu_torch import bench
from idg_tpu_torch.models.reference import degridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.ops.precision import degridder_precisions
from idg_tpu_torch.types import from_numpy_observation
from idg_tpu_torch.utils import roofline
from idg_tpu_torch.utils.compare import check_error
from idg_tpu_torch.utils.costs import grid_costs, workload_costs
from idg_tpu_torch.utils.report import report_csv

ROOT = pathlib.Path(__file__).resolve().parents[1]
GATE = 1e-5
JAX_TOL = 2e-6
RANK2_W_SCALE = 45.0         # rank 2 with μ ≠ 0 (tests/test_torch_separable.py)
ESCALATED_W_SCALE = 1000.0   # the guard picks rank 4 here
H100 = "NVIDIA H100 80GB HBM3"


def _port(params):
    return tcfg.IDGParams(**dataclasses.asdict(params))


def _case(params, case):
    if case == "w0":
        obs, sub = jdata.make_observation(params, include_subgrids=True)
        return params, obs, sub
    if case == "c48":
        # 48 channels: the recurrence resyncs at c = 16 and 32
        params = dataclasses.replace(params, nr_stations=2, nr_timesteps_subgrid=8,
                                     nr_channels=48)
        obs, sub = jdata.make_observation(params, include_subgrids=True)
        return params, obs, sub
    w_scale = {"w_default": None, "w_rank2": RANK2_W_SCALE,
               "w_escalated": ESCALATED_W_SCALE}[case]
    return jdata.make_w_observation(params, w_scale=w_scale, include_subgrids=True)


def _port_run(version, params, obs, sub):
    return tapi.run_degridder(_port(params), from_numpy_observation(obs), sub, version,
                              device="cpu")


def _error(got, want):
    return check_error(got, want, verbose=False).mean_error


@pytest.mark.parametrize("w_rank", range(1, 7))
def test_degridder_precisions_equal_jax(w_rank):
    assert degridder_precisions(w_rank) == jax_degridder_precisions(w_rank)


@pytest.mark.parametrize("case", ["w0", "w_default", "w_rank2", "w_escalated", "c48"])
def test_polstack_matches_jax_and_oracle(case, small_params):
    params, obs, sub = _case(small_params, case)
    rank = japi._resolve("degridder", "pallas_v6", params, obs)[1]
    assert (rank is not None and rank > 2) == (case == "w_escalated")
    assert tapi._resolve("degridder", "cuda_v6", _port(params),
                         from_numpy_observation(obs)) == ("cuda_v6", rank)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _port_run("cuda_v6", params, obs, sub)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    want = japi.run_degridder(params, obs, sub, version="pallas_v6")
    oracle = degridder_reference(_port(params), from_numpy_observation(obs), sub)
    assert _error(got, oracle) <= GATE
    assert _error(got, want) <= JAX_TOL


def test_polstack_falls_back_on_non_uniform_channels(small_params):
    """As JAX's pallas_v6 falls back to pallas_v4, cuda_v6 warns and runs
    cuda_v4, which meets the oracle."""
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    k = np.array(obs.wavenumbers, copy=True)
    k[-1] *= 1.05   # break uniform spacing (tests/test_guards.py:37-40)
    obs = dataclasses.replace(obs, wavenumbers=k)
    with pytest.warns(UserWarning, match="falling back to pallas_v4"):
        assert japi._resolve("degridder", "pallas_v6", small_params, obs) == ("pallas_v4", None)
    tp, tobs = _port(small_params), from_numpy_observation(obs)
    with pytest.warns(UserWarning, match="uniform channel spacing.*falling back to cuda_v4"):
        assert tapi._resolve("degridder", "cuda_v6", tp, tobs) == ("cuda_v4", None)
    with pytest.warns(UserWarning, match="falling back to cuda_v4"):
        got = _port_run("cuda_v6", small_params, obs, sub)
    assert torch.equal(got, _port_run("cuda_v4", small_params, obs, sub))
    assert _error(got, degridder_reference(tp, tobs, sub)) <= GATE


def test_cpu_staging_leaves_launch_counter_at_zero(small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    stg = stage(params, from_numpy_observation(obs), "cpu", with_vis=False)
    kernels.reset_launch_counts()
    kernels.degridder_cuda_v6(params, stg, torch.from_numpy(np.ascontiguousarray(sub)), 3)
    assert kernels.degridder_cuda_v6 in kernels.KERNELS
    assert all(wrapper.launches == 0 for wrapper in kernels.KERNELS)


@pytest.mark.parametrize("bad", ["subgrid_size", "w_rank", "subgrids_shape"])
def test_polstack_wrapper_rejects_bad_input(bad, small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    stg = stage(params, from_numpy_observation(obs), "cpu", with_vis=False)
    subt = torch.from_numpy(np.ascontiguousarray(sub))
    with pytest.raises(ValueError):
        if bad == "subgrid_size":
            kernels.degridder_cuda_v6(dataclasses.replace(params, subgrid_size=24), stg, subt)
        elif bad == "w_rank":
            kernels.degridder_cuda_v6(params, stg, subt, 7)
        else:
            kernels.degridder_cuda_v6(params, stg, subt[:, :, :, :8])


@pytest.mark.parametrize("env,want", [
    ({}, ("cuda_v6", "cuda_v7", None)),
    ({"BENCH_DEGRIDDER_KERNEL": "cuda_v6"}, ("cuda_v6", "cuda_v6", None)),
    ({"BENCH_KERNEL": "cuda_v3", "BENCH_W_RANK": "3"}, ("cuda_v3", "cuda_v7", 3)),
    ({"BENCH_KERNEL": "", "BENCH_W_RANK": ""}, ("cuda_v6", "cuda_v7", None)),
])
def test_bench_config_reads_the_knobs(env, want):
    config = bench.bench_config(env)
    assert (config.gridder, config.degridder, config.w_rank) == want


@pytest.mark.parametrize("env,match", [
    ({"BENCH_KERNEL": "pallas_v6"}, "no kernel"),
    ({"BENCH_DEGRIDDER_KERNEL": "cuda_v9"}, "no kernel"),
    ({"BENCH_W_RANK": "two"}, "not an integer"),
])
def test_bench_config_rejects_unknown_values(env, match):
    with pytest.raises(ValueError, match=match):
        bench.bench_config(env)


def test_bench_exits_nonzero_on_an_unknown_version():
    env = dict(os.environ, PYTHONPATH=str(ROOT), BENCH_DEGRIDDER_KERNEL="cuda_v9")
    out = subprocess.run([sys.executable, "-m", "idg_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert "cuda_v9" in out.stderr and not out.stdout.strip()


def test_bench_leaves_out_the_pipeline_of_an_unfused_gridder(small_params, capsys):
    """A gridder with no fused pipeline form gives no pipeline_* fields and
    one stderr line saying why (JAX's _bench_pipeline returns {} there); no
    --no-fuse composition is timed in its place."""
    params = _port(small_params)
    obs = from_numpy_observation(jdata.make_observation(small_params)[0])
    assert bench.pipeline_fields(params, obs, "cuda_v3", None, None, 1.0, device="cpu") == {}
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "pipeline_* left out" in err and "cuda_v3" in err


@pytest.mark.parametrize("workload,version,unit", [
    ("degridder", "cuda_v6", "bf16"), ("gridder", "cuda_v4", "bf16"),
    ("degridder", "cuda_v5", "bf16"), ("gridder", "cuda_v6", "tf32"),
    ("degridder", "cuda_v7", "tf32"), ("gridder", "cuda_v3", "fp32"),
    ("gridder", "cuda_v7", "tf32"), ("gridder", "cuda_v2", "tf32"),
    ("degridder", "cuda_v8", "tf32"), ("degridder", "cuda_v2", "tf32"),
    ("gridder", "cuda_v1", "tf32"), ("degridder", "cuda_v1", "tf32"),
    ("degridder", "cuda_v3", "fp32"),
])
def test_roofline_takes_the_unit_of_the_rung(workload, version, unit):
    assert roofline.unit(workload, version) == unit
    # an intensity of 1000 FLOP/byte is compute-bound on either unit
    frac = roofline.roofline_fraction(10.0, 1000.0, 1.0, H100, workload, version)
    assert frac == pytest.approx(10.0e9 / roofline.PEAK_FLOP_PER_S[unit])


def test_roofline_bound_and_unknown_device():
    assert roofline.roofline_fraction(1.0, 1.0, 1.0, "NVIDIA A100-SXM4-80GB", "gridder",
                                      "cuda_v6") is None
    assert roofline.roofline_fraction(1.0, 1.0, 0.0, H100, "gridder", "cuda_v6") is None
    # 1 FLOP/byte is bandwidth-bound: the bound is 1 · 3.35 TB/s
    assert roofline.roofline_fraction(1.0, 1.0, 1.0, H100, "degridder", "cuda_v6") == \
        pytest.approx(1e9 / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_seconds(67e12, 1.0) == (pytest.approx(1.0), "operations")
    assert roofline.bound_seconds(989e12, 3.35e12, "bf16") == (pytest.approx(1.0), "bytes")


@pytest.mark.parametrize("workload,version", [("gridder", "cuda_v6"), ("degridder", "cuda_v7")])
def test_roofline_bounds_k1_on_the_tf32_peak(workload, version):
    """K1's and K2's bound: the reference's operation model of one pass at
    the default problem (1.779·10¹² FLOP) over 495 TFLOP/s, 3.594 ms; the
    fused form adds the grid stage's (i)DFT, 3.699 ms."""
    params = tcfg.IDGParams()
    flops = workload_costs(params)[0] * 1e9
    fused = flops + grid_costs(params)[0] * 1e9
    unit = roofline.unit(workload, version)
    assert roofline.PEAK_FLOP_PER_S[unit] == 495e12
    seconds, by = roofline.bound_seconds(flops, 2.4e9, unit)
    assert by == "operations" and seconds * 1e3 == pytest.approx(3.594, abs=1e-3)
    assert roofline.bound_seconds(fused, 2.4e9, unit)[0] * 1e3 == pytest.approx(3.699, abs=1e-3)


def test_report_csv_writes_the_roofline_row(tmp_path):
    path = report_csv("degridder_cuda_v6", H100, 0.5, 100.0, 10.0, 50.0,
                      output_path=str(tmp_path), roofline=0.25)
    rows = dict(line.split(",") for line in pathlib.Path(path).read_text().splitlines())
    assert rows["roofline_pct"] == "25.00" and rows["MVis/s"] == "100.00"
    path = report_csv("gridder_cuda_v6", "cpu", 0.5, 100.0, 10.0, 50.0,
                      output_path=str(tmp_path))
    assert "roofline_pct" not in pathlib.Path(path).read_text()


def test_polstack_steps_by_the_uniform_fit(monkeypatch):
    """cuda_v6 (K9d) takes the recurrence of cuda_v5's planes, stepped by the
    uniform fit's Δk: on the correctness problem its plain error does not
    rise against the one with k[1] − k[0] (5.67e-6 → 5.57e-6)."""
    from idg_tpu_torch.data import initialize_subgrids, make_observation
    from idg_tpu_torch.ops.cuda import gridder_separable

    params = tcfg.IDGParams.correctness_defaults()
    obs, _ = make_observation(params)
    sub = initialize_subgrids(params.nr_subgrids, params.nr_correlations, params.subgrid_size)
    want = degridder_reference(params, obs, sub)

    def error():
        return _error(tapi.run_degridder(params, obs, sub, "cuda_v6", device="cpu"), want)

    fitted = error()
    monkeypatch.setattr(gridder_separable, "channel_step",
                        lambda k: k[1] - k[0] if k.shape[0] > 1 else torch.zeros(()))
    assert fitted <= error()
