"""Readings that set the limits of `correct`: for each seed, the program's
numbers and the control's, at the cell's own size, in one process.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 [--control N]

For each seed it makes the cell's inputs, and
  - runs the port's set-up and one pass of the timed recipe
    (benchmark/recipes/<recipe>.py) and compares it with the float64
    reference as a run does;
  - runs the control (on the first N seeds with --control N): the plain
    reference in the program's place with every product's operands in
    TF32 (reference.tf32), the step below the configuration's float32,
    compared with the float64 reference the same way.
One JSON line a seed: {"seed", "program": {...}, "control": {...}}. The
benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])


def readings(cell, seed: int, device, ctl: bool = True) -> dict:
    import torch

    from benchmark import catalog, compare, harness, reference

    recipe = catalog.load_recipe(cell.traffic["recipe"])
    inp = recipe.make_inputs(cell.problem, cell.traffic, seed, device)
    row = {"seed": seed}
    t = time.perf_counter()
    ref = recipe.expected(cell.problem, inp)
    row["reference_s"] = time.perf_counter() - t
    pass_obj = recipe.build(cell.problem, inp, device)
    out = pass_obj()
    harness._sync(torch.device(device))
    del pass_obj
    row["program"] = compare.numbers(out, ref)
    del out
    if ctl:
        t = time.perf_counter()
        out = recipe.expected(cell.problem, inp, rounding=reference.tf32)
        row["control_s"] = time.perf_counter() - t
        row["control"] = compare.numbers(out, ref)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=None,
                    help="run the control on the first N seeds only (default: all)")
    args = ap.parse_args(argv)
    import torch

    from benchmark import catalog, harness

    cell = catalog.load_cell(args.workload)
    try:
        device = harness.check_device(cell.chips)
    except harness.NoDevice as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 3
    from idg_tpu_torch.ops.cuda import build

    build.library()
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        row = readings(cell, seed, device, ctl=args.control is None or i < args.control)
        row["workload"] = cell.name
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
