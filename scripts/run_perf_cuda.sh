#!/usr/bin/env bash
# Sweep every registered kernel version of the PyTorch/CUDA port in
# performance mode on the card: the counterpart of run_perf_tpu.sh, under
# the reference's own name (its scripts/run_perf_cuda.sh loops the gridder
# v1..v8 and degridder v1..v6 executables).
#
# Env: OUTPUT_PATH (CSV destination, default ./res), plus the usual
# GRID_SIZE / NR_STATIONS / ... problem-size and NR_* harness vars.
# Extra arguments go to the sweep (e.g. --versions cuda_v6,cuda_v7 --fullsize).
set -euo pipefail
cd "$(dirname "$0")/.."
export OUTPUT_PATH="${OUTPUT_PATH:-res}"
mkdir -p "$OUTPUT_PATH"
python -m idg_tpu_torch sweep --workloads gridder,degridder --versions all --mode perf "$@"
