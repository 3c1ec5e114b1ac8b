"""idg_tpu_torch CLI: the reference's per-kernel executables, one command.

The reference builds one executable per kernel (tests/CMakeLists.txt:4-38);
each runs performance mode with no args or correctness mode with `-c`
(tests/gridder_common.cpp:126-140). Here one CLI selects workload, version,
mode and device, and honors the same env vars.

  python -m idg_tpu_torch run --workload gridder --version cuda_v6 --mode check
  python -m idg_tpu_torch run --workload degridder --version cuda_v7 --mode perf
  python -m idg_tpu_torch pipeline --direction grid
  python -m idg_tpu_torch pipeline --direction degrid --no-fuse --suffix _nofuse
  python -m idg_tpu_torch list
  python -m idg_tpu_torch info
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _perf_one(workload: str, version: str, w_rank: int | None = None,
              params=None, device: str = "cuda") -> float:
    """Performance mode (p_run_gridder_ semantics, app/CUDA/util.cpp:172-249):
    stage once, time bare kernel launches, print and write the CSV. Returns
    the min-of-windows seconds per launch."""
    from .config import HarnessConfig, IDGParams
    from .data import initialize_subgrids, make_perf_observation
    from .ops.api import resolve_device, staged_runner
    from .utils.costs import workload_costs
    from .utils.printing import print_device_info, print_parameters
    from .utils.report import device_name, report, report_csv
    from .utils.timing import time_kernel

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("perf mode times the card; it needs --device cuda")
    if params is None:
        params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    print_device_info()
    obs = make_perf_observation(params)
    print_parameters(params)
    subgrids = None
    if workload == "degridder":
        subgrids = initialize_subgrids(
            params.nr_subgrids, params.nr_correlations, params.subgrid_size
        )
    fn, args = staged_runner(workload, version, params, obs, subgrids,
                             w_rank=w_rank, device=dev)
    timing = time_kernel(fn, *args, harness=harness)
    gflops, gbytes, mvis = workload_costs(params)
    name = f"{workload}_{version}"
    report(name, timing.seconds, gflops, gbytes, mvis, seconds_std=timing.seconds_std)
    report_csv(name, device_name(), timing.seconds, gflops, gbytes, mvis,
               output_path=harness.output_path, seconds_std=timing.seconds_std)
    return timing.seconds


def _check_one(workload: str, version: str, device: str = "cuda"):
    """Correctness mode (`-c` semantics, tests/gridder_common.cpp:43-124).
    Returns the CompareResult, true iff the 1e-5 gate passed."""
    from .config import IDGParams
    from .data import initialize_subgrids, make_observation
    from .models.reference import degridder_reference, gridder_reference
    from .ops.api import resolve_device, run_degridder, run_gridder
    from .utils.compare import compare_subgrids, compare_visibilities
    from .utils.printing import print_parameters

    dev = resolve_device(device)
    params = IDGParams.correctness_defaults()
    print_parameters(params)
    obs, _ = make_observation(params)
    if workload == "gridder":
        print(">>> Run gridder on host (golden reference)")
        golden = gridder_reference(params, obs)
        print(f">>> Run gridder on {dev} ({version})")
        got = run_gridder(params, obs, version=version, device=dev)
        result = compare_subgrids(golden, got)
    else:
        subgrids = initialize_subgrids(
            params.nr_subgrids, params.nr_correlations, params.subgrid_size
        )
        print(">>> Run degridder on host (golden reference)")
        golden = degridder_reference(params, obs, subgrids)
        print(f">>> Run degridder on {dev} ({version})")
        got = run_degridder(params, obs, subgrids, version=version, device=dev)
        result = compare_visibilities(golden, got)
    return result


@dataclasses.dataclass(frozen=True)
class PipelineResult:
    name: str              # CSV/report name, pipeline_[degrid_]<version><suffix>
    seconds: float         # min-window seconds per pass
    kernel_seconds: float  # the gridder/degridder kernel's share
    grid_seconds: float    # the grid stage's share
    output: object         # one pass's result: c64[P, G, G] grid or c64[S, T, C, P] visibilities


def _pipeline_one(direction: str = "grid", version: str | None = None,
                  w_rank: int | None = None, no_fuse: bool = False, suffix: str = "",
                  device: str = "cuda") -> PipelineResult:
    """One end-to-end pass, timed on the card (cmd_pipeline semantics of
    idg_tpu/cli.py:545-822). direction=grid: gridder with the fused iDFT
    epilogue → block-rolled pieces → range grid-add (K4) into [P, G, G].
    direction=degrid: range extraction (K5) → pieces → degridder with the
    fused forward-DFT prologue. With no_fuse, the non-fused kernel and a
    torch producer (roll phases and the DFT as matmuls, ops/grid.py) sit
    between the kernel and K4/K5. The observation's metadata is
    block-sorted first (free on the host). Prints the stage split and
    writes the CSV with grid_stage_ms/grid_stage_pct rows."""
    import numpy as np
    import torch

    from .config import HarnessConfig, IDGParams
    from .data import make_perf_observation
    from .ops.api import (gridded_pipeline_parts, resolve_device,
                          staged_degridder_consumer,
                          staged_degridder_pieces_chunk_consumers, staged_runner)
    from .ops.cuda.grid import grid_add_cuda, grid_extract_cuda
    from .ops.grid import (_finish_extract, pieces_from_subgrids, plan_grid_add_ranges,
                           roll_offsets, sort_observation_blocks)
    from .utils.costs import grid_costs, workload_costs
    from .utils.printing import print_device_info, print_parameters
    from .utils.report import device_name, report, report_csv
    from .utils.timing import time_kernel

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the pipeline times the card; it needs --device cuda")
    params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    print_device_info()
    print_parameters(params)
    g, n = params.grid_size, params.subgrid_size
    if g % n:
        raise ValueError(f"the pipeline needs GRID_SIZE % SUBGRID_SIZE == 0 (got {g} % {n})")
    obs, _ = sort_observation_blocks(make_perf_observation(params), g, n)
    md = obs.metadata
    oyx = roll_offsets(md.coord_x, md.coord_y, g, n)
    oyx_dev = torch.as_tensor(oyx, device=dev)
    degrid = direction == "degrid"
    version = version or ("cuda_v7" if degrid else "cuda_v6")
    torch.cuda.reset_peak_memory_stats(dev)

    if degrid:
        rng = np.random.default_rng(11)
        p = params.nr_correlations
        grid = torch.complex(*(torch.as_tensor(rng.normal(size=(p, g, g)).astype(np.float32))
                               for _ in range(2))).to(dev)
        cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device=dev)
                  for c in (md.coord_x, md.coord_y))
        if no_fuse:
            kfn, version = staged_degridder_consumer(params, obs, version, w_rank, dev)

            def grid_stage(gr):
                return _finish_extract(grid_extract_cuda(gr, cx, cy, n), oyx_dev)
        else:
            consumers, _, version = staged_degridder_pieces_chunk_consumers(
                params, obs, version, oyx, w_rank, dev)
            if consumers is None:
                raise ValueError(f"degridder {version} has no fused prologue; use --no-fuse")
            (kfn,) = consumers

            def grid_stage(gr):
                return grid_extract_cuda(gr, cx, cy, n)

        def pass_fn(gr):
            return kfn(grid_stage(gr))

        pass_args = (grid,)
        t_grid = time_kernel(grid_stage, grid, harness=harness).seconds
        kname = "degridder"
    else:
        plan = plan_grid_add_ranges(md.coord_x, md.coord_y, g, n)
        runs = plan.lens[0, :plan.nb]
        print(f"    range plan: {plan.nb} blocks, longest run w = {plan.w}, mean run "
              f"{runs.mean():.2f} ({runs[runs > 0].mean():.2f} over "
              f"{int((runs > 0).sum())} occupied blocks)")
        if no_fuse:
            kfn, pass_args = staged_runner("gridder", version, params, obs,
                                           w_rank=w_rank, device=dev)

            def pass_fn(*a):
                return grid_add_cuda(pieces_from_subgrids(kfn(*a), oyx_dev), oyx_dev, plan, g)
        else:
            kfn, pass_args, gfn, version, plan = gridded_pipeline_parts(
                params, obs, version, w_rank, plan, dev)
            if kfn is None:
                raise ValueError(f"gridder {version} has no fused epilogue; use --no-fuse")

            def pass_fn(*a):
                return gfn(kfn(*a))

        t_kernel = time_kernel(kfn, *pass_args, harness=harness).seconds
        kname = "gridder"
    print(f"    staging: peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          "allocated on the device")

    timing = time_kernel(pass_fn, *pass_args, harness=harness)
    if degrid:
        t_grid = min(t_grid, timing.seconds)
        t_kernel = max(timing.seconds - t_grid, 0.0)
    else:
        t_grid = max(timing.seconds - t_kernel, 0.0)
    output = pass_fn(*pass_args)
    torch.cuda.synchronize(dev)
    gflops, gbytes, mvis = workload_costs(params)
    ggflops, ggbytes, _ = grid_costs(params)
    gflops, gbytes = gflops + ggflops, gbytes + ggbytes
    name = f"pipeline_{'degrid_' if degrid else ''}{version}{suffix}"
    print(f"    stage split: {kname} {t_kernel*1e3:.1f} ms "
          f"({100*t_kernel/timing.seconds:.0f}%), grid stage "
          f"{t_grid*1e3:.1f} ms ({100*t_grid/timing.seconds:.0f}%)")
    report(name, timing.seconds, gflops, gbytes, mvis, seconds_std=timing.seconds_std)
    report_csv(name, device_name(), timing.seconds, gflops, gbytes, mvis,
               output_path=harness.output_path, seconds_std=timing.seconds_std,
               extra={"grid_stage_ms": t_grid * 1e3,
                      "grid_stage_pct": 100 * t_grid / timing.seconds})
    return PipelineResult(name, timing.seconds, t_kernel, t_grid, output)


def cmd_pipeline(args) -> int:
    _pipeline_one(args.direction, args.version, args.w_rank, args.no_fuse, args.suffix,
                  args.device)
    return 0


def cmd_run(args) -> int:
    if args.mode == "perf":
        _perf_one(args.workload, args.version, args.w_rank, device=args.device)
        return 0
    return 0 if _check_one(args.workload, args.version, args.device).passed else 1


def cmd_list(args) -> int:
    from .ops.registry import list_kernels

    for entry in list_kernels():
        print(f"{entry.workload:>10s}  {entry.version:<16s} [{entry.family}]  {entry.description}")
    return 0


def cmd_info(args) -> int:
    from .utils.printing import print_device_info

    print_device_info()
    return 0


def main(argv=None) -> int:
    from .ops.api import DeviceUnavailable

    parser = argparse.ArgumentParser(prog="python -m idg_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run one kernel in perf or check mode")
    p_run.add_argument("--workload", choices=["gridder", "degridder"], required=True)
    p_run.add_argument("--version", default=None,
                       help="registry version (default: cuda_v6 / cuda_v7)")
    p_run.add_argument("--mode", choices=["perf", "check"], default="perf")
    p_run.add_argument("--device", default="cuda",
                       help="cuda (the kernels) or cpu (their plain PyTorch versions)")
    p_run.add_argument("--w-rank", type=int, default=None,
                       help="w-term Taylor rank override (1 is exact for w==0 data)")
    p_run.set_defaults(fn=cmd_run)

    p_pipe = sub.add_parser(
        "pipeline",
        help="end-to-end pass: gridder -> iDFT -> grid accumulation, or "
             "grid extraction -> DFT -> degridder (perf only, on the card)")
    p_pipe.add_argument("--direction", choices=["grid", "degrid"], default="grid")
    p_pipe.add_argument("--version", default=None,
                        help="kernel version (default cuda_v6 gridder / cuda_v7 degridder)")
    p_pipe.add_argument("--w-rank", type=int, default=None)
    p_pipe.add_argument("--no-fuse", action="store_true",
                        help="run the non-fused kernel and a torch producer (roll "
                             "phases + DFT matmuls) at the stage boundary (A/B)")
    p_pipe.add_argument("--suffix", default="", help="extra CSV/report name suffix")
    p_pipe.add_argument("--device", default="cuda", help="cuda (the pipeline times the card)")
    p_pipe.set_defaults(fn=cmd_pipeline)

    sub.add_parser("list", help="list registered kernels").set_defaults(fn=cmd_list)
    sub.add_parser("info", help="print device info").set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    if args.command == "run" and args.version is None:
        args.version = "cuda_v6" if args.workload == "gridder" else "cuda_v7"
    try:
        return args.fn(args)
    except DeviceUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
