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

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
