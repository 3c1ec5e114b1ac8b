#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is
non-zero:
  1. device   the card's name and `nvidia-smi` name/power limit; exactly one
              visible CUDA device
  2. build    both CUDA kernels from idg_tpu_torch/csrc, with ptxas's report
  3. check    cuda_v6 / cuda_v7 against the f64 oracle at the 1e-5 gate, on
              the correctness-mode observation (w = 0) and on a w != 0
              observation where the API escalates the Taylor rank
  4. compare  each kernel against its plain PyTorch version on the card, on
              the first 512 subgrids of the default problem (1e-5 gate), and
              both timed on the full default problem
  5. perf     the main path: the CLI's perf mode for both kernels at the full
              default problem (24,500 subgrids), launch-only timing; every
              wrapper's launch count is reset before and read after
  6. grid     the grid stage on the block-sorted default problem: the fused
              gridder (K1 + K3 epilogue), the range grid-add (K4), the range
              extraction (K5, exact) and the fused degridder (K2 + K3
              prologue) each against its plain version on the first 512
              subgrids (1e-5 gate), and each timed both ways on the full
              problem; K3 (inside the fused forms) against the plain (i)DFT
              and roll on the full problem; both fused pipelines against the
              f64 oracle on a 40-subgrid problem
  7. pipeline the `pipeline` command, grid and degrid, at the full default
              problem; launch counts reset before and read after each, and
              every kernel of its path must have launched; then each against
              its --no-fuse composition (1e-5 gate on the outputs over
              max |ref|)
Then a JSON line of per-kernel results, the `nvidia-smi` line, and last the
result line {"ok": true, "device": {...}}. Perf CSVs go to $OUTPUT_PATH, by
default a fresh temporary directory.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GATE = 1e-5
COMPARE_SUBGRIDS = 512


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def device_ms(fn, *args, harness) -> float:
    from idg_tpu_torch.utils.timing import time_kernel

    return time_kernel(fn, *args, harness=harness).seconds * 1e3


def compare(name: str, got, want, exact: bool = False) -> float:
    """Gate `got` (kernel, on the card) against `want` (plain version);
    returns the max abs error. Raises on a miss or a non-finite value."""
    import torch

    from idg_tpu_torch.utils.compare import check_error

    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(got)).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    want = want.to(got.device)
    max_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    if exact:
        ok = max_abs == 0.0
        msg = f"max_abs_err {max_abs:.3e} (exact)"
    else:
        res = check_error(got, want, verbose=False)
        ok = res.passed
        msg = (f"mean_error {res.mean_error:.3e} (gate {GATE:g}), max_abs_err "
               f"{max_abs:.3e}, max |reference| {scale:.3e}")
    phase("grid", f"{name}: {msg} {'PASSED' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{name} disagrees with its reference")
    return max_abs


def grid_stage_phase(rows, timing, plain_timing):
    """Phase 6: each grid-stage kernel against its plain version on the
    card, then timed both ways on the full block-sorted default problem;
    both fused pipelines against the f64 oracle on a small problem."""
    import torch

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import make_observation, make_perf_observation
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops import grid as tgrid
    from idg_tpu_torch.ops.api import (gridded_pipeline_parts,
                                       staged_degridder_pieces_chunk_consumers)
    from idg_tpu_torch.ops.common import slice_staged, stage

    # the fused pipelines against the f64 oracle, 40 subgrids at N = 32
    params = IDGParams(grid_size=256, nr_stations=5, nr_timeslots=4, nr_timesteps_subgrid=32,
                       nr_channels=8)
    g, n = params.grid_size, params.subgrid_size
    obs, _ = tgrid.sort_observation_blocks(make_observation(params)[0], g, n)
    md = obs.metadata
    pfn, pargs, gfn, _, _ = gridded_pipeline_parts(params, obs)
    want = tgrid.subgrids_to_grid(torch.from_numpy(gridder_reference(params, obs)),
                                  md.coord_x, md.coord_y, g)
    compare("gridded pipeline vs f64 oracle (40 subgrids)", gfn(pfn(*pargs)), want)
    grid = torch.complex(*(torch.from_numpy((np.random.default_rng(11).normal(
        size=(4, g, g)) / n**2).astype(np.float32)) for _ in range(2)))
    oyx = tgrid.roll_offsets(md.coord_x, md.coord_y, g, n)
    (consumer,), _, _ = staged_degridder_pieces_chunk_consumers(params, obs, oyx=oyx)
    pieces = tgrid.grid_to_subgrids_ranges(grid.cuda(), md.coord_x, md.coord_y, n, pieces=True)
    want = degridder_reference(params, obs, tgrid.grid_to_subgrids(
        grid, md.coord_x, md.coord_y, n).numpy())
    compare("degrid pipeline vs f64 oracle (40 subgrids)", consumer(pieces),
            torch.from_numpy(want))

    # each kernel against its plain version: 512 sorted subgrids, then timed.
    # The grid is normal(0, 1)/N², so the visibilities are O(1) like the
    # reference's correctness data (check_error's metric grows with the
    # square root of the values' magnitude).
    params = IDGParams.from_env()
    g, n = params.grid_size, params.subgrid_size
    obs, _ = tgrid.sort_observation_blocks(make_perf_observation(params), g, n)
    md = obs.metadata
    torch.cuda.reset_peak_memory_stats()
    stg = stage(params, obs, "cuda")
    phase("grid", f"block-sorted staging (time gather path): peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on the device")
    oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, g, n), device="cuda")
    cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device="cuda")
              for c in (md.coord_x, md.coord_y))
    plan = tgrid.plan_grid_add_ranges(md.coord_x, md.coord_y, g, n)
    k = COMPARE_SUBGRIDS
    small = slice_staged(stg, 0, k)
    plan_k = tgrid.plan_grid_add_ranges(md.coord_x[:k], md.coord_y[:k], g, n)
    grid = torch.complex(*(torch.as_tensor((np.random.default_rng(11).normal(
        size=(4, g, g)) / n**2).astype(np.float32), device="cuda") for _ in range(2)))
    pieces = kernels.gridder_cuda_v6_pieces(params, stg, oyx, 2)
    xpieces = kernels.grid_extract_cuda(grid, cx, cy, n)
    torch.cuda.synchronize()
    cases = (
        ("gridder_cuda_v6_pieces", kernels.gridder_cuda_v6_pieces,
         kernels.gridder_v6_pieces_plain, (params, small, oyx[:k], 2), (params, stg, oyx, 2),
         "idg_tpu_torch/csrc/gridder.cu", "idg_tpu/ops/pallas/gridder.py:942", False),
        ("grid_add_cuda", kernels.grid_add_cuda, kernels.grid_add_plain,
         (pieces[:k], oyx[:k], plan_k, g), (pieces, oyx, plan, g),
         "idg_tpu_torch/csrc/grid_add.cu", "idg_tpu/ops/grid.py:923", False),
        ("grid_extract_cuda", kernels.grid_extract_cuda, kernels.grid_extract_plain,
         (grid, cx[:k], cy[:k], n), (grid, cx, cy, n),
         "idg_tpu_torch/csrc/grid_extract.cu", "idg_tpu/ops/grid.py:1228", True),
        ("degridder_cuda_v7_fused", lambda *a: kernels.degridder_cuda_v7(*a[:4], fuse_oyx=a[4]),
         lambda *a: kernels.degridder_plain(*a[:2], tgrid._finish_extract(a[2], a[4]), a[3]),
         (params, small, xpieces[:k], 2, oyx[:k]), (params, stg, xpieces, 2, oyx),
         "idg_tpu_torch/csrc/degridder.cu", "idg_tpu/ops/pallas/degridder.py:1022", False),
    )
    times = {}
    for name, kernel, plain, small_args, full_args, source, replaces, exact in cases:
        max_abs = compare(f"{name} vs plain on {k} subgrids", kernel(*small_args),
                          plain(*small_args), exact)
        full = kernel(*full_args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(torch.view_as_real(full)).all()):
            raise RuntimeError(f"{name}: non-finite output on the full problem")
        del full
        k_ms = device_ms(kernel, *full_args, harness=timing)
        p_ms = device_ms(plain, *full_args, harness=plain_timing)
        times[name] = k_ms
        phase("grid", f"{name} full problem ({params.nr_subgrids} subgrids): kernel "
                      f"{k_ms:.3f} ms, plain {p_ms:.3f} ms")
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=0, max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms))

    # K3 runs inside the fused kernels: check it on the full problem against
    # the plain (i)DFT + roll of the same subgrids, and print what the fused
    # forms cost over the non-fused ones in this call
    sub = kernels.gridder_cuda_v6(params, stg, 2)
    compare("K3 (inverse, in the fused gridder) vs plain on the full problem",
            pieces, tgrid.pieces_from_subgrids(sub, oyx))
    k3_plain = device_ms(tgrid.pieces_from_subgrids, sub, oyx, harness=plain_timing)
    base = {"gridder_cuda_v6_pieces": device_ms(kernels.gridder_cuda_v6, params, stg, 2,
                                                harness=timing),
            "degridder_cuda_v7_fused": device_ms(kernels.degridder_cuda_v7, params, stg,
                                                 xpieces, 2, harness=timing)}
    for name, ms in base.items():
        phase("grid", f"{name}: {times[name]:.3f} ms, non-fused form {ms:.3f} ms "
                      f"({times[name] - ms:+.3f} ms); plain (i)DFT + roll {k3_plain:.3f} ms")
    del stg, small, pieces, xpieces, grid, sub
    torch.cuda.empty_cache()


def pipeline_phase(rows, mvis):
    """Phase 7: the `pipeline` command at the full default problem, each
    direction with counted launches, then against its --no-fuse form."""
    import torch

    from idg_tpu_torch import cli
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.utils.compare import check_error

    counted = {
        "grid": (("gridder_cuda_v6_pieces", lambda: kernels.gridder_cuda_v6_pieces.launches),
                 ("grid_add_cuda", lambda: kernels.grid_add_cuda.launches)),
        "degrid": (("grid_extract_cuda", lambda: kernels.grid_extract_cuda.launches),
                   ("degridder_cuda_v7_fused",
                    lambda: kernels.degridder_cuda_v7.fused_launches)),
    }
    by_name = {row["name"]: row for row in rows}
    for direction, path in counted.items():
        kernels.reset_launch_counts()
        res = cli._pipeline_one(direction)
        launches = {name: count() for name, count in path}
        phase("pipeline", f"{res.name}: {res.seconds * 1e3:.3f} ms/pass, "
                          f"{mvis / res.seconds:.2f} MVis/s; kernel "
                          f"{res.kernel_seconds * 1e3:.3f} ms, grid stage "
                          f"{res.grid_seconds * 1e3:.3f} ms; launches {launches}")
        for name, n in launches.items():
            by_name[name]["launches"] += n
            if n == 0:
                raise RuntimeError(f"{name} was never launched on the {direction} pipeline")
        ref = cli._pipeline_one(direction, no_fuse=True, suffix="_nofuse")
        # gated on both outputs over max|ref|, which makes check_error's metric
        # a normalized RMS: the CLI's degrid grid is normal(0, 1), so the
        # visibilities reach ~1e3, where the raw metric (printed too) grows
        # with their magnitude
        scale = float(ref.output.abs().max())
        raw = check_error(res.output, ref.output, verbose=False)
        ok = check_error(res.output / scale, ref.output / scale, verbose=False)
        phase("pipeline", f"{res.name} vs {ref.name} ({ref.seconds * 1e3:.3f} ms/pass): "
                          f"mean_error {ok.mean_error:.3e} over max |ref| {scale:.3e} "
                          f"(gate {GATE:g}; raw {raw.mean_error:.3e}) "
                          f"{'PASSED' if ok.passed else 'FAILED'}")
        if not ok.passed:
            raise RuntimeError(f"{res.name} disagrees with its --no-fuse composition")
        del res, ref
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "idg_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(idg_tpu_torch/ is not beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("OUTPUT_PATH", tempfile.mkdtemp(prefix="chip_smoke_"))

    from idg_tpu_torch import cli
    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import (initialize_subgrids, make_observation,
                                    make_perf_observation, make_w_observation)
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.api import _resolve, run_degridder, run_gridder
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda import build
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.costs import workload_costs
    from idg_tpu_torch.utils.printing import nvidia_smi_power_line

    # 1. device
    count = torch.cuda.device_count()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_power_line()
    phase("device", f"{kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}")
    if count != 1:
        raise RuntimeError(f"chip_smoke needs exactly one visible CUDA device, found {count}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    phase("build", f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(build.NVCC_FLAGS[:2])})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            phase("build", line.strip())

    # 3. check mode against the f64 oracle
    params_c = IDGParams.correctness_defaults()
    obs_c, _ = make_observation(params_c)
    for workload, version in (("gridder", "cuda_v6"), ("degridder", "cuda_v7")):
        rank = _resolve(workload, version, params_c, obs_c)[1] or 2
        res = cli._check_one(workload, version, "cuda")
        phase("check", f"{workload} {version} w=0: rank {rank}, mean_error "
                       f"{res.mean_error:.3e} (gate {GATE:g}) "
                       f"{'PASSED' if res.passed else 'FAILED'}")
        if not res.passed:
            raise RuntimeError(f"{workload} {version} failed the gate at w=0")
    params_w, obs_w, _ = make_w_observation(params_c, w_scale=1000.0)
    sub_w = initialize_subgrids(params_w.nr_subgrids, params_w.nr_correlations,
                                params_w.subgrid_size)
    for workload, version in (("gridder", "cuda_v6"), ("degridder", "cuda_v7")):
        _, rank = _resolve(workload, version, params_w, obs_w)
        if workload == "gridder":
            got = run_gridder(params_w, obs_w, version, device="cuda")
            golden = gridder_reference(params_w, obs_w)
        else:
            got = run_degridder(params_w, obs_w, sub_w, version, device="cuda")
            golden = degridder_reference(params_w, obs_w, sub_w)
        res = check_error(got, golden, verbose=False)
        phase("check", f"{workload} {version} w!=0 (w_scale 1000): rank {rank}, "
                       f"mean_error {res.mean_error:.3e} {'PASSED' if res.passed else 'FAILED'}")
        if not res.passed or rank is None or rank < 3:
            raise RuntimeError(f"{workload} {version} w!=0 check failed (rank {rank})")

    # 4. kernel against plain version on the card
    params = IDGParams.from_env()
    obs = make_perf_observation(params)
    subgrids = initialize_subgrids(params.nr_subgrids, params.nr_correlations,
                                   params.subgrid_size)
    stg = stage(params, obs, "cuda")
    sub_t = torch.as_tensor(np.ascontiguousarray(subgrids), device="cuda")
    del subgrids
    small = slice_staged(stg, 0, COMPARE_SUBGRIDS)
    timing = HarnessConfig(nr_warm_up_runs=1, nr_iterations=3, nr_windows=3)
    plain_timing = HarnessConfig(nr_warm_up_runs=1, nr_iterations=1, nr_windows=2)
    cases = (
        ("gridder_cuda_v6", kernels.gridder_cuda_v6, kernels.gridder_plain,
         (params, small, 2), (params, stg, 2),
         "idg_tpu_torch/csrc/gridder.cu", "idg_tpu/ops/pallas/gridder.py:794"),
        ("degridder_cuda_v7", kernels.degridder_cuda_v7, kernels.degridder_plain,
         (params, small, sub_t[:COMPARE_SUBGRIDS], 2), (params, stg, sub_t, 2),
         "idg_tpu_torch/csrc/degridder.cu", "idg_tpu/ops/pallas/degridder.py:901"),
    )
    rows = []
    for name, kernel, plain, small_args, full_args, source, replaces in cases:
        got = kernel(*small_args)
        want = plain(*small_args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(torch.view_as_real(got)).all()):
            raise RuntimeError(f"{name}: non-finite kernel output")
        res = check_error(got, want, verbose=False)
        max_abs = float((got - want).abs().max())
        phase("compare", f"{name} vs plain on {COMPARE_SUBGRIDS} subgrids: mean_error "
                         f"{res.mean_error:.3e} (gate {GATE:g}), max_abs_err {max_abs:.3e}")
        if not res.passed:
            raise RuntimeError(f"{name} disagrees with its plain version")
        full = kernel(*full_args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(torch.view_as_real(full)).all()):
            raise RuntimeError(f"{name}: non-finite output on the full problem")
        del full
        k_ms = device_ms(kernel, *full_args, harness=timing)
        p_ms = device_ms(plain, *full_args, harness=plain_timing)
        phase("compare", f"{name} full problem ({params.nr_subgrids} subgrids): kernel "
                         f"{k_ms:.3f} ms, plain {p_ms:.3f} ms")
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=0, max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms))
    del stg, small, sub_t
    torch.cuda.empty_cache()

    # 5. the main path: perf mode through the CLI, counted launches
    _, _, mvis = workload_costs(params)
    kernels.reset_launch_counts()
    seconds = {
        "gridder_cuda_v6": cli._perf_one("gridder", "cuda_v6"),
        "degridder_cuda_v7": cli._perf_one("degridder", "cuda_v7"),
    }
    launches = {
        "gridder_cuda_v6": kernels.gridder_cuda_v6.launches,
        "degridder_cuda_v7": kernels.degridder_cuda_v7.launches,
    }
    for row in rows:
        name = row["name"]
        row["launches"] = launches[name]
        phase("perf", f"{name}: {seconds[name] * 1e3:.3f} ms/pass, "
                      f"{mvis / seconds[name]:.2f} MVis/s, launches {launches[name]}")
        if launches[name] == 0:
            raise RuntimeError(f"{name} was never launched on the main path")

    # 6. the grid stage, kernel against plain version on the card
    grid_stage_phase(rows, timing, plain_timing)

    # 7. the pipelines through the CLI, counted launches
    pipeline_phase(rows, mvis)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
