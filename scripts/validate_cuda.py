#!/usr/bin/env python
"""Write VALIDATION_H100.md: every registered rung of the PyTorch/CUDA port
(idg_tpu_torch) against the f64 oracle at the reference's check-mode problem
(tests/gridder_common.cpp:54-64), on the standard w = 0 data and on
make_w_observation's nonzero-w data; the grid stage's range kernels against
the scatter / gather formulations; and both fused pipelines against their
--no-fuse compositions. The counterpart of scripts/validate_tpu.py.

    python scripts/validate_cuda.py [--device cuda] [--versions v,...] [--out VALIDATION_H100.md]

It runs on the card unless --device cpu is given, which takes the plain
PyTorch versions instead of the kernels (without a card, --device cuda
exits 2). A FAILED or ERROR row stays in the table, and the script then
exits 1. On the card `-m cuda tests/test_torch_cuda.py` runs it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GATE = 1e-5          # the reference's normalized-RMS gate (tests/test_util.hpp:84)
GRID_GATE = 1e-4     # the grid stage's max-elementwise gate, over max |reference|


def failed(rows) -> list:
    """The rows of a section that did not pass."""
    return [r for r in rows if "| FAILED |" in r or "| ERROR |" in r]


def _row(*cells) -> str:
    return "| " + " | ".join(str(c) for c in cells) + " |"


def run_section(params, obs, subgrids, device="cuda", only=None) -> list:
    """Every registered rung through the public API (the guards active, as
    a user meets them) against the f64 oracle, one row each: workload,
    version, the rung that ran (`_fb` where the guard fell back, as the
    CLI's perf names say), verdict and mean error."""
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops.api import _resolve, run_degridder, run_gridder
    from idg_tpu_torch.ops.registry import list_kernels
    from idg_tpu_torch.utils.compare import check_error

    golden = {"gridder": gridder_reference(params, obs),
              "degridder": degridder_reference(params, obs, subgrids)}
    rows = []
    for e in list_kernels():
        if only is not None and e.version not in only:
            continue
        ran = "-"
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # a fallback is named in the row
                resolved, _ = _resolve(e.workload, e.version, params, obs)
                ran = resolved + ("_fb" if resolved != e.version else "")
                if e.workload == "gridder":
                    got = run_gridder(params, obs, e.version, device=device)
                else:
                    got = run_degridder(params, obs, subgrids, e.version, device=device)
            r = check_error(got, golden[e.workload], verbose=False)
            verdict, err = ("PASSED" if r.passed else "FAILED"), f"{r.mean_error:.3e}"
        except Exception as exc:  # noqa: BLE001 — the row records it, the exit code says it
            verdict, err = "ERROR", f"{type(exc).__name__}: {str(exc)[:80]}"
        rows.append(_row(e.workload, e.version, ran, verdict, err))
        print(rows[-1], flush=True)
    return rows


def _max_rel(a, b) -> float:
    """max |a − b| over max |a|."""
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


def _grid_row(label, a, b, gate=GRID_GATE) -> str:
    err = _max_rel(a, b)
    return _row(label, "PASSED" if err < gate else "FAILED", f"{err:.3e}")


def grid_stage_section(device="cuda", params=None, streamed_params=None) -> list:
    """The range kernels against the torch formulations, on the card, max
    error over max |reference|: the range grid-add (K4, with the iDFT)
    against the periodic scatter `subgrids_to_grid`, the range extraction
    (K5, with the DFT) against the gather `grid_to_subgrids`, at
    scripts/validate_tpu.py's problem (14 stations, 512², S = 1,820) unless
    `params` says otherwise; then the streamed grid-add of the 16384² path
    (masked pieces, then K7 per group of blocks where the plan merges, else
    K6 per block) against the fused K4, on a sparse problem of the same
    grid (`streamed_params`, 4 stations and 4 timeslots by default, 24
    subgrids)."""
    import numpy as np
    import torch

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import initialize_subgrids, make_perf_observation
    from idg_tpu_torch.ops import grid as tgrid

    params = params or IDGParams.from_env(nr_stations=14, grid_size=512)
    streamed_params = streamed_params or IDGParams.from_env(
        nr_stations=4, nr_timeslots=4, grid_size=params.grid_size)
    rows = []

    def sorted_problem(p):
        g, n = p.grid_size, p.subgrid_size
        obs, order = tgrid.sort_observation_blocks(make_perf_observation(p), g, n)
        md = obs.metadata
        cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device=device)
                  for c in (md.coord_x, md.coord_y))
        sub = torch.as_tensor(initialize_subgrids(p.nr_subgrids, p.nr_correlations, n)[order],
                              device=device)
        return tgrid.plan_grid_add_ranges(md.coord_x, md.coord_y, g, n), cx, cy, sub

    g, n = params.grid_size, params.subgrid_size
    plan, cx, cy, sub = sorted_problem(params)
    label = f"{g}², S = {params.nr_subgrids}"
    rows.append(_grid_row(f"range grid-add K4 vs subgrids_to_grid ({label})",
                          tgrid.subgrids_to_grid(sub, cx, cy, g, True),
                          tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, True, plan=plan)))
    print(rows[-1], flush=True)
    del sub
    rng = np.random.default_rng(3)
    grid = torch.complex(*(torch.as_tensor(rng.normal(size=(params.nr_correlations, g, g))
                                           .astype(np.float32)) for _ in range(2))).to(device)
    rows.append(_grid_row(f"range extraction K5 vs grid_to_subgrids ({label})",
                          tgrid.grid_to_subgrids(grid, cx, cy, n, True),
                          tgrid.grid_to_subgrids_ranges(grid, cx, cy, n, True)))
    print(rows[-1], flush=True)
    del grid

    plan, cx, cy, sub = sorted_problem(streamed_params)
    mplan = tgrid.merged_plan_for(plan)
    route = "K6 per block" if mplan is None else f"K7, m = {mplan.m}"
    bands = tgrid.subgrids_to_grid_ranges_streamed(sub, cx, cy, g, True, plan=plan)
    rows.append(_grid_row(
        f"streamed grid-add ({route}) vs fused K4 ({g}², S = {streamed_params.nr_subgrids})",
        tgrid.subgrids_to_grid_ranges(sub, cx, cy, g, True, plan=plan), torch.cat(bands, dim=1)))
    print(rows[-1], flush=True)
    return rows


def _rel_rms(a, b) -> float:
    """RMS of a − b over the RMS of a."""
    return float((a - b).abs().pow(2).mean().sqrt()) / max(
        float(a.abs().pow(2).mean().sqrt()), 1e-30)


def fused_section(device="cuda") -> list:
    """Both fused pipelines against their --no-fuse compositions at the
    check problem, normalized RMS, 1e-5 gate: the gridder with the fused
    iDFT epilogue (K1 + K3) into the range grid-add K4, against the
    non-fused K1, the torch producer and K4; the range extraction K5 into
    the degridder's fused DFT prologue (K2 + K3), against K5, the torch
    (i)DFT and the non-fused K2."""
    import numpy as np
    import torch

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import make_observation
    from idg_tpu_torch.ops import grid as tgrid
    from idg_tpu_torch.ops.api import (gridded_pipeline_parts, staged_degridder_consumer,
                                       staged_degridder_pieces_chunk_consumers, staged_runner)

    params = IDGParams.correctness_defaults()
    g, n = params.grid_size, params.subgrid_size
    obs, _ = tgrid.sort_observation_blocks(make_observation(params)[0], g, n)
    md = obs.metadata
    cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device=device)
              for c in (md.coord_x, md.coord_y))
    rows = []

    pfn, pargs, gfn, version, plan = gridded_pipeline_parts(params, obs, "cuda_v6",
                                                            device=device)
    fused = gfn(pfn(*pargs))
    kfn, kargs = staged_runner("gridder", version, params, obs, device=device)
    plain = tgrid.subgrids_to_grid_ranges(kfn(*kargs), cx, cy, g, plan=plan)
    err = _rel_rms(plain, fused)
    rows.append(_row(f"gridder {version} fused iDFT pieces -> range grid-add",
                     "PASSED" if err <= GATE else "FAILED", f"{err:.3e}"))
    print(rows[-1], flush=True)

    rng = np.random.default_rng(7)
    grid = torch.complex(*(torch.as_tensor(rng.normal(size=(params.nr_correlations, g, g))
                                           .astype(np.float32)) for _ in range(2))).to(device)
    oyx = tgrid.roll_offsets(md.coord_x, md.coord_y, g, n)
    (consumer,), _, version = staged_degridder_pieces_chunk_consumers(
        params, obs, "cuda_v7", oyx, device=device)
    fused = consumer(tgrid.grid_to_subgrids_ranges(grid, cx, cy, n, True, pieces=True))
    kfn, _ = staged_degridder_consumer(params, obs, version, device=device)
    plain = kfn(tgrid.grid_to_subgrids_ranges(grid, cx, cy, n, True))
    err = _rel_rms(plain, fused)
    rows.append(_row(f"range extraction pieces -> degridder {version} fused DFT prologue",
                     "PASSED" if err <= GATE else "FAILED", f"{err:.3e}"))
    print(rows[-1], flush=True)
    return rows


def header(device) -> list:
    """The table's first lines: the card's name and power limit as
    nvidia-smi gives them, and the torch and CUDA versions."""
    import torch

    from idg_tpu_torch.utils.printing import nvidia_smi_power_line

    card = (f"`{nvidia_smi_power_line()}` (nvidia-smi name, power.limit)"
            if device.type == "cuda" else "none: --device cpu, the plain PyTorch versions")
    return [
        "# Hardware validation of the PyTorch/CUDA port",
        "",
        f"- card: {card}",
        f"- torch {torch.__version__}, CUDA {torch.version.cuda}",
        "- written by `python scripts/validate_cuda.py` (the counterpart of",
        "  scripts/validate_tpu.py, whose TPU table is res/VALIDATION.md)",
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain PyTorch versions)")
    ap.add_argument("--versions", default=None,
                    help="comma-separated version filter of the rung sections (default: all)")
    ap.add_argument("--out", default=str(ROOT / "VALIDATION_H100.md"))
    args = ap.parse_args(argv)
    only = set(args.versions.split(",")) if args.versions else None

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import initialize_subgrids, make_observation, make_w_observation
    from idg_tpu_torch.ops.api import DeviceUnavailable, resolve_device

    try:
        device = resolve_device(args.device)
    except DeviceUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    lines = header(device)
    print("\n".join(lines), flush=True)

    params = IDGParams.correctness_defaults()
    obs, _ = make_observation(params)
    subgrids = initialize_subgrids(params.nr_subgrids, params.nr_correlations,
                                   params.subgrid_size)
    rung_head = ["| workload | version | runs as | result | error |", "|---|---|---|---|---|"]
    rows = run_section(params, obs, subgrids, device, only)
    lines += ["", "## Standard data (w = 0, the reference generators)", "",
              "Every registered rung through the public API against the f64 oracle, at",
              "the 1e-5 normalized-RMS gate (tests/test_util.hpp:84); the guards",
              "(channel-spacing fallback, w-rank escalation) are active as a user meets them.",
              "", *rung_head, *rows]

    wparams, wobs, wsub = make_w_observation(params, include_subgrids=True)
    wrows = run_section(wparams, wobs, wsub, device, only)
    rows += wrows
    lines += ["", "## Nonzero-w data (make_w_observation: w tracks and w-plane metadata, "
              f"w_step = {wparams.w_step:.4g})", "",
              "The w-free rank-1 rungs (gridder cuda_v7, degridder cuda_v8) fall back to",
              "cuda_v4 here (`_fb`): the guard, not the raw kernel, is what is validated.",
              "", *rung_head, *wrows]

    grows = grid_stage_section(device)
    rows += grows
    lines += ["", "## Grid stage (range kernels vs the torch scatter / gather)", "",
              f"Max elementwise error over max |reference|, gate {GRID_GATE:g}.", "",
              "| comparison | result | max-rel error |", "|---|---|---|", *grows, "",
              "JAX's streamed extraction (grid_to_subgrids_ranges_streamed) is not in the",
              "port: K5 reads the whole grid (ROADMAP, \"Left out\")."]

    frows = fused_section(device)
    rows += frows
    lines += ["", "## Fused grid-stage compositions (check problem)", "",
              f"Normalized RMS against the --no-fuse composition, gate {GATE:g}.", "",
              "| composition | result | error |", "|---|---|---|", *frows]

    lines += ["", "## Mesh path", "",
              "scripts/validate_tpu.py's mesh section waits for the port's multi-device",
              "layer (ROADMAP Queue 1)."]
    pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out}", flush=True)
    bad = failed(rows)
    if bad:
        print(f"{len(bad)} row(s) did not pass", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
