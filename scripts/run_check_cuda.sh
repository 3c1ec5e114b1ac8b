#!/usr/bin/env bash
# Sweep every registered kernel version of the PyTorch/CUDA port in
# correctness mode (the reference's `-c` flag across all executables, its
# scripts/run_check_cuda.sh). Extra arguments go to the sweep
# (e.g. --device cpu for the plain versions).
set -euo pipefail
cd "$(dirname "$0")/.."
export OUTPUT_PATH="${OUTPUT_PATH:-res}"
python -m idg_tpu_torch sweep --workloads gridder,degridder --versions all --mode check "$@"
