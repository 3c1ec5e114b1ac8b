"""Headline benchmark: gridder + degridder throughput on one CUDA card.

    python -m idg_tpu_torch.bench
    BENCH_DEGRIDDER_KERNEL=cuda_v6 python -m idg_tpu_torch.bench

Prints ONE JSON line with the keys of the JAX package's bench.py: the
gridder as metric/value/unit/vs_baseline, the degridder as degridder_*, and
the gridded pipeline (the gridder with its fused iDFT epilogue, then the
range grid-add into the [P, G, G] grid) as pipeline_*. The kernels are
timed launch-only and the pipeline pass by pass, on the default problem
(IDGParams.from_env(): 24,500 subgrids, 50.2 MVis). One gridder version
feeds the headline and the pipeline; a gridder with no fused pipeline form
leaves the pipeline_* fields out, with one stderr line saying why. Baseline
anchors are the reference's published V100 numbers: CUDA gridder_reference
42.93 MVis/s, degridder_reference 28.03 MVis/s
(res/{gridder,degridder}/Tesla_V100-*-cuda.csv). No kernel ladder and no
retry: an unknown or failing version, or a host without a card, exits
non-zero.

Env knobs (the JAX package's, bench.py:79-89, 168-178):
  BENCH_KERNEL            gridder version (default cuda_v6)
  BENCH_DEGRIDDER_KERNEL  degridder version (default cuda_v7)
  BENCH_W_RANK            Taylor rank override for both (default: the
                          guard's rank for the observation)
and NR_ITERATIONS / NR_WARM_UP_RUNS / NR_WINDOWS and the reference's
problem-size vars (GRID_SIZE, NR_STATIONS, ...).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

V100_GRIDDER_REFERENCE_MVIS_S = 42.93
V100_DEGRIDDER_REFERENCE_MVIS_S = 28.03

GRIDDER_VERSION = "cuda_v6"
DEGRIDDER_VERSION = "cuda_v7"


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    gridder: str
    degridder: str
    w_rank: int | None


def bench_config(env=None) -> BenchConfig:
    """The versions and rank the env asks for. Raises ValueError on a
    version that is not registered or a rank that is not an integer."""
    from .ops.registry import get_kernel

    env = os.environ if env is None else env
    config = BenchConfig(env.get("BENCH_KERNEL") or GRIDDER_VERSION,
                         env.get("BENCH_DEGRIDDER_KERNEL") or DEGRIDDER_VERSION, None)
    for workload, version in (("gridder", config.gridder), ("degridder", config.degridder)):
        try:
            get_kernel(workload, version)
        except KeyError as exc:
            raise ValueError(exc.args[0]) from None
    rank = env.get("BENCH_W_RANK")
    if rank:
        try:
            config = dataclasses.replace(config, w_rank=int(rank))
        except ValueError:
            raise ValueError(f"BENCH_W_RANK={rank!r} is not an integer") from None
    return config


def pipeline_fields(params, obs, version: str, w_rank, harness, mvis, device="cuda") -> dict:
    """The pipeline_* fields: one gridded pass of `version` through
    api.gridded_pipeline_parts (the `pipeline` command's recipe), timed pass
    by pass. A version with no fused form gives {} and one stderr line (the
    JAX package's _bench_pipeline returns {} there); the bench does not
    substitute the --no-fuse composition."""
    from .ops.api import gridded_pipeline_parts
    from .ops.grid import sort_observation_blocks
    from .utils.timing import time_kernel

    obs_sorted, _ = sort_observation_blocks(obs, params.grid_size, params.subgrid_size)
    pfn, pargs, gfn, resolved, _ = gridded_pipeline_parts(
        params, obs_sorted, version, w_rank=w_rank, device=device)
    if pfn is None:
        print(f"bench: pipeline_* left out: gridder {resolved} has no fused pipeline form",
              file=sys.stderr)
        return {}
    seconds = time_kernel(lambda *a: gfn(pfn(*a)), *pargs, harness=harness).seconds
    return {"pipeline_metric": f"pipeline_{resolved}_throughput",
            "pipeline_value": round(mvis / seconds, 2),
            "pipeline_unit": "MVis/s"}


def main() -> int:
    import torch

    from .config import HarnessConfig, IDGParams
    from .data import initialize_subgrids, make_perf_observation
    from .ops.api import staged_runner
    from .utils.costs import workload_costs
    from .utils.timing import time_kernel

    try:
        config = bench_config()
    except ValueError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("bench: no CUDA device is visible", file=sys.stderr)
        return 2
    params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    obs = make_perf_observation(params)
    _, _, mvis = workload_costs(params)

    fn, args = staged_runner("gridder", config.gridder, params, obs, w_rank=config.w_rank)
    gridder_s = time_kernel(fn, *args, harness=harness).seconds
    del fn, args
    subgrids = initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size
    )
    fn, args = staged_runner("degridder", config.degridder, params, obs, subgrids,
                             w_rank=config.w_rank)
    degridder_s = time_kernel(fn, *args, harness=harness).seconds
    del fn, args, subgrids

    line = {
        "metric": f"gridder_{config.gridder}_throughput",
        "value": round(mvis / gridder_s, 2),
        "unit": "MVis/s",
        "vs_baseline": round(mvis / gridder_s / V100_GRIDDER_REFERENCE_MVIS_S, 3),
        "degridder_metric": f"degridder_{config.degridder}_throughput",
        "degridder_value": round(mvis / degridder_s, 2),
        "degridder_unit": "MVis/s",
        "degridder_vs_baseline": round(
            mvis / degridder_s / V100_DEGRIDDER_REFERENCE_MVIS_S, 3
        ),
    }
    line.update(pipeline_fields(params, obs, config.gridder, config.w_rank, harness, mvis))
    line["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
