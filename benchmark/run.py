"""Run one cell of the port's benchmark once and print one JSON line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a `workloads` entry of BENCHMARK.json. With --trace 0 the line
holds the cell's end-to-end metrics; with --trace 1 the window runs under
torch.profiler and the line holds its per-layer metrics, `busy_s`,
`window_s` and a breakdown. The last lines on standard error, and the
line's last key, `compared`, give each number that decides `correct` with
its limit. Exit codes: 0 a result was printed, 2 bad arguments, 3 no card
(or fewer than the cell needs), 4 JAX or the JAX package was loaded,
5 the program is missing.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Compiled bytecode of every module this process imports (torch's too) is
# kept in the checkout, at a fixed path, also where the environment asks
# Python to write none: only the first run of a checkout compiles torch's
# sources, which otherwise takes most of the set-up and most of its spread.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")
# import the benchmark as a package from the checkout's root, not its
# modules from this directory (where they could shadow the standard library)
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import idg_tpu_torch  # the program under test
    except ImportError as exc:
        print(f"error: the program idg_tpu_torch cannot be imported: {exc}", file=sys.stderr)
        return 5
    where = pathlib.Path(idg_tpu_torch.__file__).resolve().parent
    if where != ROOT / "idg_tpu_torch":
        print(f"error: idg_tpu_torch comes from {where}, not from this checkout", file=sys.stderr)
        return 5
    from benchmark import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START)
    except harness.NoDevice as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 3
    except harness.BannedModules as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
