#!/usr/bin/env python3
"""Time the port's gridder K1 (both forms), degridder K2 (both forms), K3
(the fused forms' (i)DFT), K4 (the range grid-add), K9d (degridder cuda_v6)
and K10 (vadd) of one checkout on one CUDA card, for A/B comparisons of two
versions of the kernels (the direct rungs: scripts/time_direct.py).

    [SUBGRID_SIZE=16] python scripts/time_kernels.py ROOT TAG [k1,k2,k1w,k4,polstack,vadd]

ROOT is a checkout of the repository (the current one, or the parent commit
unpacked with `git archive` into a directory that .gitignore lists); its
kernels are built into ROOT/idg_tpu_torch/_build. It prints the ptxas
registers and spills of K1's, K2's, K4's and K9d's instances, then for each
chosen kernel its error against its plain version on the first 512
subgrids of the default problem (the IDGParams env knobs apply; vadd:
exact, at n = 2^28) and its time on the full problem (min over windows of
back-to-back launches): for k1 and k2 both forms and K3's share, the fused
form's time less the non-fused one's, beside one torch.fft.fft2 over the
subgrids; for k1w K1's two forms at the guard's Taylor rank on the inputs
of the cell default.grid-wterm (benchmark/, seed 2700027001); for k4 on
random block-rolled pieces of the block-sorted default and LOFAR-4096
problems (GRID_SIZE=4096, NR_STATIONS=27; against its plain
version on all of LOFAR-4096's, and two launches compared bit for bit),
with its resident blocks an SM where the checkout can query them, the
masked pieces + K6 beside it on LOFAR-4096, and the gridded pipeline's pass
at both problems; for polstack also K9d's errors against the f64 oracle on
the correctness problem at w = 0, rank 4 (w_scale 1000) and C = 48; vadd
with one torch.add beside it. Each line is prefixed with TAG. Compare two
checkouts in one call, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import re
import sys
import time


def main(argv) -> int:
    root, tag = argv[1], argv[2]
    chosen = argv[3].split(",") if len(argv) > 3 else ["k1", "k2", "k1w", "k4", "polstack", "vadd"]
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
        for label, stem in (("K1", r"\d+gridder"), ("K2", r"\d+degridder"),
                            ("K4", "grid_add"), ("K9d", "degridder_polstack")):
            kernel = re.search(rf"{stem}_kernelILi(\d+)E(?:Lb(\d)E)?(?:Lb(\d)E)?(?:Lb(\d)E)?",
                               line)
            if "Compiling entry" in line and kernel:
                form = {"1": " fused", "0": " non-fused"}.get(kernel.group(2), "")
                form += " probed" if kernel.group(3) == "1" else ""
                form += " turned" if kernel.group(4) == "1" else ""
                print(f"{tag} ptxas {label} N = {kernel.group(1)}{form} |",
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
        times = {}
        for name, kernel, plain, small_args, full_args in cases:
            err = check_error(kernel(*small_args), plain(*small_args), verbose=False).mean_error
            times[name] = ms(kernel, *full_args)
            print(f"{tag} {name}: {times[name]:.3f} ms, vs plain {err:.3e}", flush=True)
        # K3's share: each fused form less its non-fused form, beside one
        # torch.fft.fft2 over the same c64[S, P, N, N] subgrids
        fft_ms = ms(torch.fft.fft2, kernels.gridder_cuda_v6(params, stg, 2))
        for fused, base in (("gridder_cuda_v6_pieces", "gridder_cuda_v6"),
                            ("degridder_cuda_v7_fused", "degridder_cuda_v7")):
            if fused in times:
                print(f"{tag} K3 in {fused}: {times[fused] - times[base]:+.3f} ms over "
                      f"{base}; torch.fft.fft2 {fft_ms:.3f} ms (N = {params.subgrid_size})",
                      flush=True)
        del stg, small
        torch.cuda.empty_cache()

    if "k1w" in chosen:
        # K1 both forms at the guard's rank on the w-term cell's inputs
        # (benchmark/recipes/grid_wterm.py, block-sorted as the cell runs
        # them); a checkout without a staged |μ·n| bound takes three TF32
        # passes on every rank
        from benchmark import catalog, passes
        from idg_tpu_torch.ops.api import _resolve

        cell = catalog.load_cell("default.grid-wterm")
        problem = cell.problem
        recipe = catalog.load_recipe(cell.traffic["recipe"])
        inp = recipe.make_inputs(problem, cell.traffic, 2700027001, "cuda")
        obs, params = passes.block_sorted(problem, inp), passes.params(problem)
        del inp
        rank = _resolve("gridder", "cuda_v6", params, obs)[1]
        stg = stage(params, obs, "cuda")
        md = obs.metadata
        oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size,
                                                 params.subgrid_size), device="cuda")
        del obs
        bound = getattr(stg, "mu_n_bound", None)
        try:
            from idg_tpu_torch.ops.precision import gridder_three_pass_ranks, tf32_passes
            tiles = tf32_passes(gridder_three_pass_ranks(bound, rank), rank)
        except ImportError:
            tiles = 3 * rank
        print(f"{tag} k1w: rank {rank}, |mu n| bound {bound}, {tiles} TF32 passes a tile",
              flush=True)
        k = 512
        small = slice_staged(stg, 0, k)
        for name, kernel, plain, small_args, full_args in (
                ("gridder_cuda_v6", kernels.gridder_cuda_v6, kernels.gridder_plain,
                 (params, small, rank), (params, stg, rank)),
                ("gridder_cuda_v6_pieces", kernels.gridder_cuda_v6_pieces,
                 kernels.gridder_v6_pieces_plain, (params, small, oyx[:k], rank),
                 (params, stg, oyx, rank))):
            err = check_error(kernel(*small_args), plain(*small_args), verbose=False).mean_error
            print(f"{tag} k1w {name} rank {rank}: {ms(kernel, *full_args):.3f} ms, "
                  f"vs plain {err:.3e}", flush=True)
        del stg, small
        torch.cuda.empty_cache()

    if "k4" in chosen:
        import contextlib
        import io

        from idg_tpu_torch import cli

        gen = torch.Generator(device="cuda").manual_seed(11)
        occupancy = getattr(kernels, "grid_add_blocks_per_sm", None)
        print(f"{tag} K4 blocks an SM: " + (", ".join(
            f"N = {n} {occupancy(n)}" for n in (32, 16)) if occupancy else "no query"), flush=True)
        for label, over in (("default", {}), ("LOFAR-4096", dict(grid_size=4096,
                                                                 nr_stations=27))):
            params = IDGParams.from_env(**over)
            g, n = params.grid_size, params.subgrid_size
            md = make_perf_observation(params).metadata
            _, cx, cy = tgrid.sorted_block_coords(md.coord_x, md.coord_y, g, n)
            tiles = torch.randn((params.nr_subgrids, params.nr_correlations, n, n),
                                dtype=torch.complex64, device="cuda", generator=gen)
            oyx = torch.as_tensor(tgrid.roll_offsets(cx, cy, g, n), device="cuda")
            plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
            k = 512 if label == "default" else params.nr_subgrids
            plan_k = tgrid.plan_grid_add_ranges(cx[:k], cy[:k], g, n)
            got = kernels.grid_add_cuda(tiles[:k], oyx[:k], plan_k, g)
            err = check_error(got, kernels.grid_add_plain(tiles[:k], oyx[:k], plan_k, g),
                              verbose=False).mean_error
            same = bool(torch.equal(got, kernels.grid_add_cuda(tiles[:k], oyx[:k], plan_k, g)))
            del got
            line = (f"{tag} grid_add_cuda {label}: {ms(kernels.grid_add_cuda, tiles, oyx, plan, g):.3f}"
                    f" ms, vs plain on {k} subgrids {err:.3e}, two launches identical {same}")
            if label != "default":
                line += ", mask + K6 {:.3f} ms".format(ms(
                    lambda: kernels.grid_add_pieces_cuda(
                        tgrid._mask_pieces(tiles, oyx[:, 0], oyx[:, 1]), plan)))
            print(line, flush=True)
            del tiles
            torch.cuda.empty_cache()
            with contextlib.redirect_stdout(io.StringIO()):
                res = cli._pipeline_one("grid", params=params)
            print(f"{tag} gridded pipeline {label}: {res.seconds * 1e3:.3f} ms/pass, grid stage "
                  f"{res.grid_seconds * 1e3:.3f} ms", flush=True)
            del res
            torch.cuda.empty_cache()

    if "polstack" in chosen:
        import dataclasses

        from idg_tpu_torch.data import make_observation, make_w_observation
        from idg_tpu_torch.models.reference import degridder_reference
        from idg_tpu_torch.ops.api import run_degridder

        # against the f64 oracle: the correctness problem at w = 0, rank 4
        # and C = 48 (the recurrence restarts at c = 16 and 32)
        base = IDGParams.correctness_defaults()
        params_w, obs_w, _ = make_w_observation(base, w_scale=1000.0)
        params_c = dataclasses.replace(base, nr_channels=48)
        for label, p, obs in (("w=0", base, make_observation(base)[0]),
                              ("rank 4", params_w, obs_w),
                              ("C = 48", params_c, make_observation(params_c)[0])):
            sb = initialize_subgrids(p.nr_subgrids, p.nr_correlations, p.subgrid_size)
            got = run_degridder(p, obs, sb, "cuda_v6", device="cuda")
            err = check_error(got, degridder_reference(p, obs, sb), verbose=False).mean_error
            print(f"{tag} oracle degridder cuda_v6 {label}: {err:.4e}", flush=True)
        params = IDGParams.from_env()
        stg = stage(params, make_perf_observation(params), "cuda", with_vis=False)
        sub = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
            params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
        small = slice_staged(stg, 0, 512)
        err = check_error(kernels.degridder_cuda_v6(params, small, sub[:512], 2),
                          kernels.degridder_polstack_plain(params, small, sub[:512], 2),
                          verbose=False).mean_error
        print(f"{tag} degridder_cuda_v6: {ms(kernels.degridder_cuda_v6, params, stg, sub, 2):.3f} "
              f"ms, vs plain {err:.3e}", flush=True)
        del stg, small, sub
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
