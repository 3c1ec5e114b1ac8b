"""Parameter table and device banner.

Mirrors app/common/print.cpp:3-60 (parameter table) and app/CUDA/util.cpp:
25-45 (device info), as ``idg_tpu/utils/printing.py`` does for the TPU.
"""

from __future__ import annotations

import subprocess

import torch

from ..config import IDGParams


def print_parameters(params: IDGParams) -> None:
    """Parameter table (print.cpp:3-60 layout)."""
    rows = [
        ("Number of stations", params.nr_stations),
        ("Number of channels", params.nr_channels),
        ("Number of timesteps", params.nr_timesteps_subgrid),
        ("Number of correlations", params.nr_correlations),
        ("Number of timeslots", params.nr_timeslots),
        ("Imagesize", params.image_size),
        ("Grid size", params.grid_size),
        ("Subgrid size", params.subgrid_size),
        ("W step size", params.w_step),
        ("Number of baselines", params.nr_baselines),
        ("Number of subgrids", params.nr_subgrids),
        ("Total number of timesteps", params.total_nr_timesteps),
    ]
    print("-----------")
    print("PARAMETERS:")
    for label, value in rows:
        print(f"{label:<30s}== {value:>10}")
    print("-----------")


def nvidia_smi_power_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (one line per card).
    Raises if nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def print_device_info() -> None:
    """Device banner: name, SM count, clocks-free properties and memory
    from torch.cuda.get_device_properties, plus the nvidia-smi name and
    power limit that every kept number is quoted beside."""
    print("Device info")
    print(f"{'torch':<30s}== {torch.__version__:>10s}")
    if not torch.cuda.is_available():
        print(f"{'CUDA device':<30s}== {'none':>10s}")
        return
    props = torch.cuda.get_device_properties(0)
    print(f"{'Name':<30s}== {props.name:>10s}")
    print(f"{'Device count':<30s}== {torch.cuda.device_count():>10d}")
    print(f"{'Compute capability':<30s}== {props.major:>8d}.{props.minor}")
    print(f"{'Multiprocessors':<30s}== {props.multi_processor_count:>10d}")
    print(f"{'Device memory (GiB)':<30s}== {props.total_memory / 2**30:>10.2f}")
    print(f"{'CUDA runtime':<30s}== {str(torch.version.cuda):>10s}")
    print(f"{'nvidia-smi name, power.limit':<30s}== {nvidia_smi_power_line()}")
