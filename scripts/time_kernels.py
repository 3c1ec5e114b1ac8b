#!/usr/bin/env python3
"""Time the port's gridder K1 (both forms), degridder K2 (both forms) and
K10 (vadd) of one checkout on one CUDA card, for A/B comparisons of two
versions of the kernels (the direct rungs: scripts/time_direct.py).

    python scripts/time_kernels.py ROOT TAG [k1,k2,vadd]

ROOT is a checkout of the repository (the current one, or the parent commit
unpacked with `git archive` into a directory that .gitignore lists); its
kernels are built into ROOT/idg_tpu_torch/_build. It prints the ptxas
registers and spills of K1's and K2's instances, then for each chosen
kernel its error against its plain version on the first 512 subgrids of the
default problem (vadd: exact, at n = 2^28) and its time on the full problem
(min over windows of back-to-back launches), vadd with one torch.add beside
it; each line prefixed with TAG. Compare two checkouts in one call, in
turns: parent, change, change, parent.
"""

from __future__ import annotations

import re
import sys
import time


def main(argv) -> int:
    root, tag = argv[1], argv[2]
    chosen = argv[3].split(",") if len(argv) > 3 else ["k1", "k2", "vadd"]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import initialize_subgrids, make_perf_observation
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops import grid as tgrid
    from idg_tpu_torch.ops import vadd as tvadd
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda import build
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.timing import time_kernel

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.library()
    print(f"{tag} build {time.perf_counter() - t0:.1f} s", flush=True)
    lines = build.build_log.splitlines()
    for i, line in enumerate(lines):
        for label, stem in (("K1", "gridder"), ("K2", "degridder")):
            kernel = re.search(rf"\d+{stem}_kernelILi(\d+)ELb(\d)E", line)
            if "Compiling entry" in line and kernel:
                form = "fused" if kernel.group(2) == "1" else "non-fused"
                print(f"{tag} ptxas {label} N = {kernel.group(1)} {form} |",
                      " | ".join(x.strip() for x in lines[i + 2:i + 4]), flush=True)

    harness = HarnessConfig(nr_warm_up_runs=1, nr_iterations=3, nr_windows=3)

    def ms(fn, *args):
        return time_kernel(fn, *args, harness=harness).seconds * 1e3

    if {"k1", "k2"} & set(chosen):
        params = IDGParams.from_env()
        obs = make_perf_observation(params)
        md = obs.metadata
        stg = stage(params, obs, "cuda")
        oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size,
                                                 params.subgrid_size), device="cuda")
        k = 512
        small = slice_staged(stg, 0, k)
        cases = []
        if "k1" in chosen:
            cases += [
                ("gridder_cuda_v6", kernels.gridder_cuda_v6, kernels.gridder_plain,
                 (params, small, 2), (params, stg, 2)),
                ("gridder_cuda_v6_pieces", kernels.gridder_cuda_v6_pieces,
                 kernels.gridder_v6_pieces_plain, (params, small, oyx[:k], 2),
                 (params, stg, oyx, 2)),
            ]
        if "k2" in chosen:
            sub = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
                params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
            pieces = tgrid.pieces_from_subgrids(sub, oyx)
            cases += [
                ("degridder_cuda_v7", kernels.degridder_cuda_v7, kernels.degridder_plain,
                 (params, small, sub[:k], 2), (params, stg, sub, 2)),
                ("degridder_cuda_v7_fused",
                 lambda p, s, sb, r, o: kernels.degridder_cuda_v7(p, s, sb, r, fuse_oyx=o),
                 lambda p, s, sb, r, o: kernels.degridder_plain(
                     p, s, tgrid._finish_extract(sb, o), r),
                 (params, small, pieces[:k], 2, oyx[:k]), (params, stg, pieces, 2, oyx)),
            ]
        for name, kernel, plain, small_args, full_args in cases:
            err = check_error(kernel(*small_args), plain(*small_args), verbose=False).mean_error
            print(f"{tag} {name}: {ms(kernel, *full_args):.3f} ms, vs plain {err:.3e}",
                  flush=True)
        del stg, small
        torch.cuda.empty_cache()

    if "vadd" in chosen:
        n = tvadd.DEFAULT_N
        x, y = tvadd.make_vadd_inputs(n, "cuda")
        exact = bool(torch.equal(kernels.vadd_cuda(x, y), torch.add(x, y)))
        k_ms, lib_ms = ms(kernels.vadd_cuda, x, y), ms(torch.add, x, y)
        print(f"{tag} vadd_cuda (n = {n}): {k_ms:.3f} ms ({tvadd.vadd_gbytes(n) / k_ms:.3f} TB/s), "
              f"torch.add {lib_ms:.3f} ms, exact {exact}", flush=True)
        if not exact:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
