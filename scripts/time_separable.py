#!/usr/bin/env python3
"""Time the port's separable kernels (K8b/K8c, K9b/K9c) of one checkout on
one CUDA card, for A/B comparisons of two versions of the kernels.

    python scripts/time_separable.py ROOT TAG [gridder,degridder]

ROOT is a checkout of the repository (the current one, or the parent commit
unpacked with `git archive` into a directory that .gitignore lists); its
kernels are built into ROOT/idg_tpu_torch/_build. For each of cuda_v3,
cuda_v4 and cuda_v5 of the chosen workloads it prints the kernel's error
against its plain version on the first 512 subgrids of the default problem
and its time on the full problem (min over windows of back-to-back
launches), each line prefixed with TAG, plus the ptxas registers and spills
of the N = 32 instances and each rung's mean error against the f64 oracle
on the correctness problem at w = 0, at rank 4 (w_scale 1000) and on a
ragged V = 37·7 (as `-m cuda tests/test_torch_cuda.py` holds them). Compare two
checkouts in one call, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import time


def main(argv) -> int:
    root, tag = argv[1], argv[2]
    workloads = argv[3].split(",") if len(argv) > 3 else ["gridder", "degridder"]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import (initialize_subgrids, make_observation,
                                    make_perf_observation, make_w_observation)
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.api import run_degridder, run_gridder
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda import build
    from idg_tpu_torch.ops.cuda.gridder_separable import plain_precisions
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.timing import time_kernel

    if not torch.cuda.is_available():
        print("time_separable: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.library()
    print(f"{tag} build {time.perf_counter() - t0:.1f} s", flush=True)
    lines = build.build_log.splitlines()
    # the N = 32 instances: (degridder|gridder)_sep_v<3|4|5>_kernel<32>, or
    # before their redesign (degridder|gridder)_separable_kernel<32, bf16, recur>
    stems = (re.compile(r"(degridder|gridder)_sep_v(\d)_kernelILi32E"),
             re.compile(r"(degridder|gridder)_separable_kernelILi32ELb(\d)ELb(\d)"))
    for i, line in enumerate(lines):
        found = [m for m in (stem.search(line) for stem in stems) if m]
        if "Compiling entry" in line and found:
            groups = found[0].groups()
            if len(groups) == 2:
                workload, rung = groups[0], f"cuda_v{groups[1]}"
            else:
                workload, bf16, recur = groups
                rung = "cuda_v5" if recur == "1" else "cuda_v4" if bf16 == "1" else "cuda_v3"
            print(f"{tag} ptxas {workload} {rung} N = 32 |",
                  " | ".join(x.strip() for x in lines[i + 2:i + 4]))

    # against the f64 oracle: the correctness problem at w = 0, rank 4 and a
    # ragged V
    base = IDGParams.correctness_defaults()
    params_w, obs_w, _ = make_w_observation(base, w_scale=1000.0)
    params_r = dataclasses.replace(base, nr_timesteps_subgrid=37, nr_channels=7)
    problems = (("w=0", base, make_observation(base)[0]), ("rank 4", params_w, obs_w),
                ("V = 37*7", params_r, make_observation(params_r)[0]))
    for label, p, obs in problems:
        sb = initialize_subgrids(p.nr_subgrids, p.nr_correlations, p.subgrid_size)
        oracles = {"gridder": gridder_reference(p, obs),
                   "degridder": degridder_reference(p, obs, sb)}
        for version in ("cuda_v3", "cuda_v4", "cuda_v5"):
            for workload in workloads:
                if workload == "gridder":
                    got = run_gridder(p, obs, version, device="cuda")
                else:
                    got = run_degridder(p, obs, sb, version, device="cuda")
                err = check_error(got, oracles[workload], verbose=False).mean_error
                print(f"{tag} oracle {workload} {version} {label}: {err:.4e}", flush=True)

    params = IDGParams.from_env()
    stg = stage(params, make_perf_observation(params), "cuda")
    sub = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
    small = slice_staged(stg, 0, 512)
    harness = HarnessConfig(nr_warm_up_runs=1, nr_iterations=3, nr_windows=3)
    for version in ("cuda_v3", "cuda_v4", "cuda_v5"):
        prec, rec = plain_precisions(version, 2), version == "cuda_v5"
        for workload in workloads:
            kernel = getattr(kernels, f"{workload}_{version}")
            if workload == "gridder":
                small_args, full_args = (params, small, 2), (params, stg, 2)
                want = kernels.gridder_separable_plain(params, small, 2, prec, rec)
            else:
                small_args, full_args = (params, small, sub[:512], 2), (params, stg, sub, 2)
                want = kernels.degridder_separable_plain(params, small, sub[:512], 2, prec, rec)
            err = check_error(kernel(*small_args), want, verbose=False).mean_error
            ms = time_kernel(kernel, *full_args, harness=harness).seconds * 1e3
            print(f"{tag} {workload} {version}: {ms:.3f} ms, vs plain {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
