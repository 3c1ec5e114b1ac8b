"""Console + CSV result reporting.

Same derived metrics, console line and CSV schema as the reference
(app/common/common.cpp:27-98): runtime ms, GFLOP/s, GB/s, FLOP/Byte, MVis/s,
and W / GFLOP/s/W / MVis/J, plus the JAX package's roofline_pct
(utils/roofline.py) where the device is known. CSV files are written to
$OUTPUT_PATH as ``<device>-<name>-cuda.csv``, the reference's own
extension. Power is not read yet, so the energy rows are written as ``n/a``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..config import get_env_var

CSV_EXT = "-cuda.csv"


def _metrics(seconds, gflops, gbytes, mvis, seconds_std=None, roofline=None):
    rows = [("ms", seconds * 1e3)]
    if seconds_std is not None:
        rows.append(("ms_stddev", seconds_std * 1e3))
    if gflops:
        rows.append(("GFLOP/s", gflops / seconds))
    if gbytes:
        rows.append(("GB/s", gbytes / seconds))
    if gflops and gbytes:
        rows.append(("FLOP/Byte", gflops / gbytes))
    if mvis:
        rows.append(("MVis/s", mvis / seconds))
    if roofline is not None:
        rows.append(("roofline_pct", 100.0 * roofline))
    return rows


def report(
    name: str,
    seconds: float,
    gflops: float = 0.0,
    gbytes: float = 0.0,
    mvis: float = 0.0,
    seconds_std: Optional[float] = None,
    roofline: Optional[float] = None,
) -> None:
    """Console one-liner (common.cpp:27-56 format, plus the ±σ noise bound
    and the roofline %)."""
    head = f"{name:>20s}: {seconds * 1e3:7.2f} ms"
    if seconds_std is not None:
        head += f" (±{seconds_std * 1e3:.2f})"
    parts = [head]
    for label, value in _metrics(seconds, gflops, gbytes, mvis, roofline=roofline)[1:]:
        parts.append(f"{value:7.2f} {label}")
    print(", ".join(parts))


def report_csv(
    name: str,
    device_name: str,
    seconds: float,
    gflops: float = 0.0,
    gbytes: float = 0.0,
    mvis: float = 0.0,
    output_path: Optional[str] = None,
    seconds_std: Optional[float] = None,
    extra: Optional[dict] = None,
    roofline: Optional[float] = None,
) -> str:
    """CSV emitter (common.cpp:58-98). `extra` rows (label → value, e.g. a
    pipeline's grid_stage_ms) follow the reference's. Returns the written
    path."""
    path = output_path if output_path is not None else get_env_var("OUTPUT_PATH", ".")
    print(f"Saving output in {path}")
    os.makedirs(path, exist_ok=True)
    device_name = re.sub(r"[/ ]", "-", device_name)
    file_path = os.path.join(path, f"{device_name}-{name}{CSV_EXT}")
    print(file_path)
    with open(file_path, "w") as f:
        for label, value in _metrics(seconds, gflops, gbytes, mvis, seconds_std, roofline):
            f.write(f"{label},{value:.4g}\n" if label == "ms_stddev"
                    else f"{label},{value:.2f}\n")
        # The reference fills these from a power sensor
        # (app/CUDA/util.cpp:131-155); the port does not read power yet.
        for label in ("W", "GFLOP/s/W", "MVis/J"):
            f.write(f"{label},n/a\n")
        for label, value in (extra or {}).items():
            f.write(f"{label},{value:.2f}\n")
    return file_path


def device_name() -> str:
    """Device identifier for CSV filenames: the CUDA device name, as the
    reference uses."""
    return torch.cuda.get_device_name(0)
