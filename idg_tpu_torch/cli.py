"""idg_tpu_torch CLI: the reference's per-kernel executables, one command.

The reference builds one executable per kernel (tests/CMakeLists.txt:4-38);
each runs performance mode with no args or correctness mode with `-c`
(tests/gridder_common.cpp:126-140). Here one CLI selects workload, version,
mode and device, and honors the same env vars.

  python -m idg_tpu_torch run --workload gridder --version cuda_v6 --mode check
  python -m idg_tpu_torch run --workload degridder --version cuda_v7 --mode perf
  python -m idg_tpu_torch list
  python -m idg_tpu_torch info
"""

from __future__ import annotations

import argparse
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

    sub.add_parser("list", help="list registered kernels").set_defaults(fn=cmd_list)
    sub.add_parser("info", help="print device info").set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    if getattr(args, "version", "") is None:
        args.version = "cuda_v6" if args.workload == "gridder" else "cuda_v7"
    try:
        return args.fn(args)
    except DeviceUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
