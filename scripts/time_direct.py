#!/usr/bin/env python3
"""Time the port's direct rungs (K8a, K9a: gridder and degridder cuda_v1 /
cuda_v2) of one checkout on one CUDA card, for A/B comparisons of two
versions of the kernels.

    python scripts/time_direct.py ROOT TAG [--drop products|phasors] [--no-oracle]

ROOT is a checkout of the repository (the current one, or the parent commit
unpacked with `git archive` into a directory that .gitignore lists); its
kernels are built into ROOT/idg_tpu_torch/_build. It prints the ptxas
registers and spills of the eight direct instances, then for each rung its
mean error against the f64 oracle, beside its plain version's (on the
CPU), on the direct gate's problems (`direct_oracle_problems`) and on the
card test's C = 256 case, its error against its plain version on the first 512 subgrids of
the default problem, and its time on the full problem (min over windows of
back-to-back launches); each line prefixed with TAG. Compare two checkouts
in one call, in turns: parent, change, change, parent.

--drop builds a diagnostic copy of the kernels (-DIDG_DIRECT_DROP, a
library of its own): without the tensor-core products, or without the
phasors' evaluation. Its results are wrong by design, so it prints times
only.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
import time

DROPS = {"products": 1, "phasors": 2}
RUNGS = (("gridder", "cuda_v1"), ("gridder", "cuda_v2"),
         ("degridder", "cuda_v1"), ("degridder", "cuda_v2"))
STRESS_W = 2.0e4     # a w no Taylor rank reaches (tests/test_guards.py:171-185)


def direct_oracle_problems():
    """(label, params, observation, subgrids) of the direct rungs' oracle
    gate (tests/test_torch_cuda.py:DIRECT_ORACLE_GATE) on the correctness
    problem (N = 32, T = 128, C = 16): w = 0, w = 2·10⁴, C = 256 at N = 16
    (32 restarts of the recurrence), C = 7 and 11 (channel groups that are
    not whole) and T = 37 (a ragged tile of timesteps)."""
    import numpy as np

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import initialize_subgrids, make_observation

    problems = []
    for label, over in (("w=0", {}), (f"w={STRESS_W:g}", {}),
                        ("C = 256, N = 16", dict(subgrid_size=16, nr_channels=256)),
                        ("C = 7", dict(nr_channels=7)), ("C = 11", dict(nr_channels=11)),
                        ("T = 37", dict(nr_timesteps_subgrid=37))):
        p = IDGParams.correctness_defaults(**over)
        obs, _ = make_observation(p)
        if label == f"w={STRESS_W:g}":
            obs = dataclasses.replace(obs, uvw=np.array(obs.uvw, copy=True))
            obs.uvw[:, :, 2] = STRESS_W
        problems.append((label, p, obs, np.ascontiguousarray(
            initialize_subgrids(p.nr_subgrids, p.nr_correlations, p.subgrid_size))))
    return problems


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("tag")
    ap.add_argument("--drop", choices=sorted(DROPS))
    ap.add_argument("--no-oracle", action="store_true")
    args = ap.parse_args(argv[1:])
    root, tag = args.root, args.tag
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import initialize_subgrids, make_observation, make_perf_observation
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda import build
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.timing import time_kernel

    if not torch.cuda.is_available():
        print("time_direct: no CUDA device is visible", file=sys.stderr)
        return 1
    if args.drop:
        build.NVCC_FLAGS = (*build.NVCC_FLAGS, f"-DIDG_DIRECT_DROP={DROPS[args.drop]}")
        tag = f"{tag} drop-{args.drop}"
    t0 = time.perf_counter()
    build.library()
    print(f"{tag} build {time.perf_counter() - t0:.1f} s", flush=True)
    lines = build.build_log.splitlines()
    stem = re.compile(r"(degridder|gridder)_direct_kernelILi(\d+)ELb(\d)E")
    for i, line in enumerate(lines):
        found = stem.search(line)
        if "Compiling entry" in line and found:
            workload, n, recur = found.groups()
            print(f"{tag} ptxas {workload} cuda_v{int(recur) + 1} N = {n} |",
                  " | ".join(x.strip() for x in lines[i + 2:i + 4]), flush=True)

    def run(workload, version, params, stg, sub):
        fn = getattr(kernels, f"{workload}_{version}")
        return fn(params, stg) if workload == "gridder" else fn(params, stg, sub)

    if not args.drop and not args.no_oracle:
        # and the card test's C = 256 case (tests/test_torch_cuda.py SMALL)
        card = IDGParams(grid_size=128, nr_stations=3, nr_timeslots=2, nr_timesteps_subgrid=16,
                         subgrid_size=16, nr_channels=256)
        obs_c, sub_c = make_observation(card, include_subgrids=True)
        problems = [*direct_oracle_problems(),
                    ("small C = 256", card, obs_c, np.ascontiguousarray(sub_c))]
        for label, p, obs, sub in problems:
            stg, stg_cpu = stage(p, obs, "cuda"), stage(p, obs, "cpu")
            sub_t = torch.from_numpy(sub).cuda()
            oracle = {"gridder": torch.from_numpy(gridder_reference(p, obs)),
                      "degridder": torch.from_numpy(degridder_reference(p, obs, sub))}
            line = []
            for w, v in RUNGS:
                rec = v == "cuda_v2"
                plain = (kernels.gridder_direct_plain(p, stg_cpu, rec) if w == "gridder" else
                         kernels.degridder_direct_plain(p, stg_cpu, torch.from_numpy(sub), rec))
                err, own = (check_error(x, oracle[w], verbose=False).mean_error
                            for x in (run(w, v, p, stg, sub_t), plain))
                line.append(f"{w} {v} {err:.3e} (plain {own:.3e})")
            print(f"{tag} oracle {label}: " + ", ".join(line), flush=True)

    params = IDGParams.from_env()
    stg = stage(params, make_perf_observation(params), "cuda")
    sub = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
    k = 512
    small = slice_staged(stg, 0, k)
    harness = HarnessConfig(nr_warm_up_runs=1, nr_iterations=3, nr_windows=3)
    for workload, version in RUNGS:
        rec = version == "cuda_v2"
        err = ""
        if not args.drop:
            got = run(workload, version, params, small, sub[:k])
            if workload == "gridder":
                want = kernels.gridder_direct_plain(params, small, rec)
            else:
                want = kernels.degridder_direct_plain(params, small, sub[:k], rec)
            err = f", vs plain {check_error(got, want, verbose=False).mean_error:.3e}"
        fn = getattr(kernels, f"{workload}_{version}")
        full = (params, stg) if workload == "gridder" else (params, stg, sub)
        ms = time_kernel(fn, *full, harness=harness).seconds * 1e3
        print(f"{tag} {workload} {version}: {ms:.3f} ms{err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
