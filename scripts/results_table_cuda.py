#!/usr/bin/env python
"""Render a markdown results table from the port's res/ CSVs.

The counterpart of scripts/results_table.py for the `-cuda.csv` files that
idg_tpu_torch writes (utils/report.py): the same columns and options. A
file is `<device>-<benchmark>-cuda.csv`, the device name with its spaces
and slashes as '-' (e.g. NVIDIA-H100-80GB-HBM3), the benchmark a gridder or
degridder rung, a pipeline, a grid stage or vadd.

Usage: python scripts/results_table_cuda.py [--filter SUBSTR] [--dir res]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

NAME = re.compile(r"(.+?)-((?:de)?gridder_.*|grid_.*|pipeline_.*|vadd.*)-cuda\.csv")
COLUMNS = ("ms", "ms_stddev", "MVis/s", "GFLOP/s", "GB/s", "roofline_pct")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="res")
    ap.add_argument("--filter", default="")
    args = ap.parse_args(argv)

    rows = []
    for path in sorted(glob.glob(os.path.join(glob.escape(args.dir), "*-cuda.csv"))):
        m = NAME.fullmatch(os.path.basename(path))
        if not m:
            continue
        bench = m.group(2)
        if args.filter and args.filter not in bench:
            continue
        with open(path) as f:
            metrics = dict(line.split(",", 1) for line in f.read().strip().splitlines())
        rows.append((bench, *(metrics.get(c, "") for c in COLUMNS)))
    print("| benchmark | ms | ±ms | MVis/s | GFLOP/s | GB/s | roofline % |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print("| " + " | ".join(str(x) for x in r) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
