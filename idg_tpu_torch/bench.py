"""Headline benchmark: gridder + degridder throughput on one CUDA card.

    python -m idg_tpu_torch.bench

Prints ONE JSON line with the keys of the JAX package's bench.py: the
gridder (`cuda_v6`) as metric/value/unit/vs_baseline, the degridder
(`cuda_v7`) as degridder_*, and the gridded pipeline (the gridder with its
fused iDFT epilogue, then the range grid-add into the [P, G, G] grid) as
pipeline_*. The kernels are timed launch-only and the pipeline pass by
pass, on the default problem (IDGParams.from_env(): 24,500 subgrids,
50.2 MVis). One GRIDDER_VERSION feeds the headline and the pipeline. Baseline
anchors are the reference's published V100 numbers: CUDA gridder_reference
42.93 MVis/s, degridder_reference 28.03 MVis/s
(res/{gridder,degridder}/Tesla_V100-*-cuda.csv). No kernel ladder and no
retry: a failing kernel, or a host without a card, exits non-zero.

Env knobs: NR_ITERATIONS / NR_WARM_UP_RUNS / NR_WINDOWS and the reference's
problem-size vars (GRID_SIZE, NR_STATIONS, ...).
"""

from __future__ import annotations

import json
import sys

V100_GRIDDER_REFERENCE_MVIS_S = 42.93
V100_DEGRIDDER_REFERENCE_MVIS_S = 28.03

GRIDDER_VERSION = "cuda_v6"
DEGRIDDER_VERSION = "cuda_v7"


def main() -> int:
    import torch

    from .config import HarnessConfig, IDGParams
    from .data import initialize_subgrids, make_perf_observation
    from .ops.api import gridded_pipeline_parts, staged_runner
    from .ops.grid import sort_observation_blocks
    from .utils.costs import workload_costs
    from .utils.timing import time_kernel

    if not torch.cuda.is_available():
        print("bench: no CUDA device is visible", file=sys.stderr)
        return 2
    params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    obs = make_perf_observation(params)
    _, _, mvis = workload_costs(params)

    fn, args = staged_runner("gridder", GRIDDER_VERSION, params, obs)
    gridder_s = time_kernel(fn, *args, harness=harness).seconds
    del fn, args
    subgrids = initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size
    )
    fn, args = staged_runner("degridder", DEGRIDDER_VERSION, params, obs, subgrids)
    degridder_s = time_kernel(fn, *args, harness=harness).seconds
    del fn, args, subgrids

    obs_sorted, _ = sort_observation_blocks(obs, params.grid_size, params.subgrid_size)
    pfn, pargs, gfn, pipeline_version, _ = gridded_pipeline_parts(
        params, obs_sorted, GRIDDER_VERSION)
    if pfn is None:
        raise ValueError(f"gridder {GRIDDER_VERSION} has no fused pipeline form")
    pipeline_s = time_kernel(lambda *a: gfn(pfn(*a)), *pargs, harness=harness).seconds

    line = {
        "metric": f"gridder_{GRIDDER_VERSION}_throughput",
        "value": round(mvis / gridder_s, 2),
        "unit": "MVis/s",
        "vs_baseline": round(mvis / gridder_s / V100_GRIDDER_REFERENCE_MVIS_S, 3),
        "degridder_metric": f"degridder_{DEGRIDDER_VERSION}_throughput",
        "degridder_value": round(mvis / degridder_s, 2),
        "degridder_unit": "MVis/s",
        "degridder_vs_baseline": round(
            mvis / degridder_s / V100_DEGRIDDER_REFERENCE_MVIS_S, 3
        ),
        "pipeline_metric": f"pipeline_{pipeline_version}_throughput",
        "pipeline_value": round(mvis / pipeline_s, 2),
        "pipeline_unit": "MVis/s",
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
