#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is
non-zero:
  1. device   the card's name and `nvidia-smi` name/power limit; exactly one
              visible CUDA device
  2. build    every CUDA kernel from idg_tpu_torch/csrc, with ptxas's report
  3. check    cuda_v6 / cuda_v7 against the f64 oracle at the 1e-5 gate, on
              the correctness-mode observation (w = 0) and on a w != 0
              observation where the API escalates the Taylor rank
  4. compare  each kernel against its plain PyTorch version on the card, on
              the first 512 subgrids of the default problem (1e-5 gate), and
              both timed on the full default problem
  5. perf     the main path: the CLI's perf mode for both kernels at the full
              default problem (24,500 subgrids), launch-only timing; every
              wrapper's launch count is reset before and read after
  6. grid     the grid stage on the block-sorted default problem: the fused
              gridder (K1 + K3 epilogue), the range grid-add (K4; its ptxas
              registers and spills, which must be none, and its resident
              blocks an SM), the range extraction (K5, exact) and the fused
              degridder (K2 + K3 prologue) each against its plain version on
              the first 512 subgrids (1e-5 gate), and each timed both ways on
              the full problem, where two launches of K4 must give the same
              grid bit for bit; K3 (inside the fused forms, on the TF32 tensor
              cores), both directions, against the plain (i)DFT and roll
              on the full problem, and the fused forms' time over the
              non-fused ones at N = 32 and 16 beside one torch.fft.fft2
              over the same subgrids, with K3's bound on the TF32 peak (one
              JSON row a direction); both fused pipelines against the f64
              oracle on a 40-subgrid problem
  7. pipeline the `pipeline` command, grid and degrid, at the full default
              problem; launch counts reset before and read after each, and
              every kernel of its path must have launched; then each against
              its --no-fuse composition (1e-5 gate on the outputs over
              max |ref|)
  8. grid-add the piece grid-add K6 (LOFAR-4096 masked pieces), K4 on the
              same problem's block-rolled pieces (its own JSON row,
              grid_add_cuda_lofar4096; two launches bit for bit), the merged
              grid-add K7 (16384², m = 64, one stripe with wrap misses), the
              piece scatter K11a (default problem) and the slot gather K11b
              (LOFAR-4096) each against its plain version on the card (1e-5
              gate), then each timed both ways at its full problem, with the
              masked pieces + K6 (the JAX dispatch's sparse route) timed
              beside K4; then every path of the `grid` command that reaches a
              grid-add kernel (default, --no-fft, --method pallas, LOFAR-4096
              with and without --method pallas, 16384² to-grid and
              to-subgrids) with counted launches, LOFAR-4096's on K4 and not
              K6; then phase 7 at LOFAR-4096 (GRID_SIZE=4096
              NR_STATIONS=27), whose grid pipeline must take K4 and not K6
  9. direct   the exact full-phase rungs cuda_v1 / cuda_v2 of both workloads
              (K8a, K9a; the complex MAC on TF32 mma.sync): ptxas registers
              and spills and the cuobjdump HMMA count of all eight instances
              (each must be there, run on the tensor cores and not spill);
              against the f64 oracle with no guard engaged at w = 0,
              w = 2·10⁴, C = 256 (N = 16), C = 7, C = 11 and T = 37, within
              4e-6 (DIRECT_ORACLE_GATE, or 1.15× the plain version's own
              error where that is past it), and the w-free rungs (gridder cuda_v7,
              degridder cuda_v8) at w = 0 and through their fallback to
              cuda_v4 at w != 0; K8a, K9a (v1, v2; 3e-6) and K10 (vadd)
              against their plain versions (first 512 default subgrids; vadd
              exactly, at n = 2^28), then timed both ways on the full problem (the plain
              direct versions one call); `sweep --mode check` over every
              version (25: the 15 cuda_* rungs and the ten torch_*); both pipelines with --no-fuse --version cuda_v1
              (counted launches; refused without --no-fuse); then this
              slice's main path, perf mode for the four
              direct versions and `vadd` with and without --cuda, with
              counted launches, and the phase's seconds
 10. separable the separable rungs cuda_v3 / cuda_v4 / cuda_v5 of both
              workloads (K8b, K8c, K9b, K9c; v4 and v5 on bf16 wgmma, v5
              with the channel recurrence): ptxas registers and spills of
              every instance (each must be there) and the cuobjdump HGMMA
              count of every v4 and v5 instance (each must have some); each
              rung against the f64 oracle at w = 0 (within 10% of their
              earlier errors, SEPARABLE_W0_ERRORS), at rank 4 (w_scale
              1000) and on a ragged V = 37·7, and cuda_v5 on non-uniform
              wavenumbers resolving to cuda_v4, with counted launches; v3,
              v4 and v5 against their plain versions at every rank 1–6
              (N = 16 and 32, small problem); each kernel against its plain version
              on the first 512 default subgrids (1e-5 gate), then timed both
              ways on the full problem (the plain version one call); then
              this slice's main path, perf mode for the six versions with
              counted launches, and the phase's seconds
 11. polstack the pol-stacked degridder cuda_v6 (K9d, bf16 wgmma, channel
              recurrence): ptxas registers and spills and the cuobjdump
              HGMMA count of each instance (both must be there, on wgmma,
              with no spill); against the f64 oracle at w = 0, at rank 4
              (w_scale 1000) and at C = 48 (the recurrence resyncs), each
              within 1.1× its error before the redesign
              (K9D_ORACLE_ERRORS), and on non-uniform wavenumbers resolving
              to cuda_v4 with one counted launch; against its plain version
              at every rank 1–6 (N = 16 and 32, small problem); K9d against its plain
              version on the first 512 default subgrids (1e-5 gate), both
              timed on the full problem (the plain version one call); this
              slice's main path, perf mode with counted launches and the
              roofline %; `python -m idg_tpu_torch.bench` with
              BENCH_DEGRIDDER_KERNEL=cuda_v6; and the phase's seconds
 12. redesign the redesigned K1 (gridder cuda_v6, TF32 wgmma) and K10: ptxas
              registers and spills and the cuobjdump HGMMA count of every
              K1 instance (each must have some, each fused instance more
              than its non-fused one: K3; N = 32 takes the turned product,
              N = 16 the transposed one); K1, both forms, at N = 32 and 16,
              against the f64 oracle at w = 0, at rank 4, at C = 48, on
              non-uniform wavenumbers (cuda_v6, no fallback) and on a
              ragged V, with counted launches (4e-6; N = 16, whose float32
              plain version itself misses that, 1e-5), and against its
              plain version at every rank 1-6 on w != 0 data (3e-6); K1,
              both forms, against its plain version on the first 512
              default subgrids (3e-6) and timed;
              K10 exactly against torch.add at n = 2^28 and at sizes off
              its chunk boundaries, aligned and misaligned, then timed
              beside torch.add; and the phase's seconds
 13. K2       the redesigned K2 (degridder cuda_v7, TF32 wgmma): ptxas
              registers and spills and the cuobjdump HGMMA count of every
              instance (each must have some, each fused instance more than
              its non-fused one: K3); both forms against the f64
              oracle at w = 0, at rank 4, at C = 48, on non-uniform
              wavenumbers (cuda_v7, no fallback) and on a ragged V, with
              counted launches (K2_ORACLE_GATE); both forms against their
              plain versions on the first 512 default subgrids
              (K2_PLAIN_GATE) and timed; and the phase's seconds
 14. ladder   the compiler ladder (torch_reference, torch_v1–v4 of both
              workloads; PyTorch on the card, no hand-written kernel, none
              of whose launch counts may move): each rung through the API
              against the f64 oracle (1e-5) at w = 0 and on
              make_w_observation's data, and against its cuda_* neighbour of
              the same function (LADDER_NEIGHBOURS, 1e-5); perf mode of each
              at the full widths on the default problem with 0 warm-ups, 1 iteration and 1 window; then
              `run --sustain 5` for gridder cuda_v6 (K1) and degridder
              cuda_v7 (K2), sustained ms beside min-of-windows, launches,
              window and drift, the launch count rising by the launches the
              window reports plus the 2 + NR_WARM_UP_RUNS before it; then
              scripts/validate_cuda.py's sections (every rung at w = 0 and
              w != 0, the grid stage, the fused pipelines), any row not
              PASSED raising; and the phase's seconds
 15. mesh     the multi-device layer (idg_tpu_torch/parallel/) at a world of
              one on NCCL, on the default problem: (a) the staged rungs
              sharded_gridder_staged (cuda_v6) and sharded_degridder_staged
              (cuda_v7) against api.staged_runner unsharded; (b) the
              per-rank range recipe (K1's fused form into K4, all_reduce)
              against `pipeline --direction grid`'s grid, and the
              reduce_scatter + all_gather pair into K5 and K2 against the
              replicated path, with counted launches (K1, K2, K4, never K6);
              each bit for bit, or within the 1e-5 gate with the difference
              printed; (c) `scaling --mesh-sizes 1` of the four workloads
              beside this run's single-device times, the gap being the
              wrapper's; (d) parallel/parity.py's replicated all-reduce
              pipeline on two gloo ranks sharing the card under torchrun
              (parity only, no time); each part's seconds
 16. trace    the trace hook: with IDG_PROFILE_DIR set, `pipeline --direction
              grid` and `--direction degrid` at the default problem, `scaling
              --workload pipeline --grid-method ranges --mesh-sizes 1` with
              NR_WINDOWS=1, and the ladder rung `run --workload gridder
              --version torch_v1` (one window of one pass), launch counts
              reset before each; every trace read by
              scripts/trace_tools_cuda.py: its top device operations a pass,
              the stream's idle share, its longest gaps with their host
              events and its idle time by host event; it raises when a
              kernel the counters saw launch inside the traced windows is
              missing from the trace, when K1's fused form, K4, K5 or K2's
              fused form appears a number of times other than its launches
              there, or (but for the ladder rung) when the trace's device
              span a pass is more than 5% from time_kernel's CUDA-event
              seconds a pass over the same windows; its seconds
Phases 1-8 print their seconds under [time], as does phase 9's check sweep
and the run as a whole. Then a JSON line of per-kernel results (each with its bound from
idg_tpu_torch/utils/roofline.py: the larger of its bytes over 3.35 TB/s and
its operations over the FP32, bf16 or TF32 peak; and the time of one PyTorch call
computing the same function where there is one), the `nvidia-smi` line, and
last the result line
{"ok": true, "device": {...}}. Perf CSVs go to $OUTPUT_PATH, by default a
fresh temporary directory.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GATE = 1e-5
COMPARE_SUBGRIDS = 512
LOFAR_4096 = dict(grid_size=4096, nr_stations=27)    # north-star config 3
GRID_16384 = dict(grid_size=16384)                    # config 5's grid on one card
STRESS_W = 2.0e4     # a w no Taylor rank reaches (tests/test_guards.py:171-185)
DIRECT = (("gridder", "cuda_v1"), ("gridder", "cuda_v2"),
          ("degridder", "cuda_v1"), ("degridder", "cuda_v2"))
SEPARABLE = tuple((w, f"cuda_v{i}") for w in ("gridder", "degridder") for i in (3, 4, 5))
RESYNC_CHANNELS = 48   # the channel recurrence restarts exactly at c = 16 and 32
K1_ORACLE_GATE = 4e-6  # K1 (TF32, three passes) against the f64 oracle
K1_PLAIN_GATE = 3e-6   # K1 against its float32 plain version, 512 default subgrids
K2_ORACLE_GATE = 4e-6  # K2 (TF32, three passes) against the f64 oracle
K2_PLAIN_GATE = 3e-6   # K2 against its float32 plain version, 512 default subgrids
DIRECT_ORACLE_GATE = 4e-6  # K8a and K9a (TF32, three passes) against the f64 oracle,
DIRECT_PLAIN_SLACK = 1.15  # or this × their plain version's (CPU) own error where past that
DIRECT_PLAIN_GATE = 3e-6   # K8a and K9a against their plain versions, 512 default subgrids
# K9d's mean errors against the f64 oracle before its redesign (NVIDIA H100
# 80GB HBM3, 700 W); the redesigned kernel stays within K9D_ORACLE_SLACK× them
K9D_ORACLE_ERRORS = {"w=0": 5.626e-06, "rank 4 (w_scale 1000)": 5.628e-06,
                     f"C = {RESYNC_CHANNELS} (resync)": 7.002e-06}
K9D_ORACLE_SLACK = 1.1
# the compiler ladder's rungs, each with the cuda_* rung of the same function
LADDER_NEIGHBOURS = {"torch_reference": "cuda_v1", "torch_v1": "cuda_v1",
                     "torch_v2": "cuda_v1", "torch_v3": "cuda_v2", "torch_v4": "cuda_v3"}
SUSTAIN_S = 5.0          # `run --sustain` window of K1 and K2
TRACE_SPAN_SLACK = 0.05  # a trace's device span a pass against the CUDA-event seconds
# each wrapper's kernel in a trace: its __global__ name and, for the two
# forms of K1 and K2, whether the instance is the fused one (None: any)
TRACE_KERNELS = {
    "gridder_cuda_v6": ("gridder_kernel", False),
    "gridder_cuda_v6_pieces": ("gridder_kernel", True),
    "degridder_cuda_v7": ("degridder_kernel", False),   # its non-fused launches
    "degridder_cuda_v7_fused": ("degridder_kernel", True),
    "grid_add_cuda": ("grid_add_kernel", None),
    "grid_extract_cuda": ("grid_extract_kernel", None),
    "grid_add_pieces_cuda": ("grid_add_pieces_kernel", None),
    "grid_add_merged_cuda": ("grid_add_merged_kernel", None),
    "grid_add_scatter_cuda": ("grid_add_scatter_kernel", None),
    "grid_add_slots_cuda": ("grid_add_slots_kernel", None),
    "gridder_cuda_v1": ("gridder_direct_kernel", None),
    "gridder_cuda_v2": ("gridder_direct_kernel", None),
    "degridder_cuda_v1": ("degridder_direct_kernel", None),
    "degridder_cuda_v2": ("degridder_direct_kernel", None),
    "vadd_cuda": ("vadd_kernel", None),
    **{f"{w}_cuda_v{i}": (f"{w}_sep_v{i}_kernel", None)
       for w in ("gridder", "degridder") for i in (3, 4, 5)},
    "degridder_cuda_v6": ("degridder_polstack_kernel", None),
}
# the kernels whose count in a trace must equal their launches in its windows
TRACE_EXACT = ("gridder_cuda_v6_pieces", "grid_add_cuda", "grid_extract_cuda",
               "degridder_cuda_v7_fused")
# K3's two rows: the form of the fused kernel it runs in, the form's
# non-fused kernel, and the TPU function it replaces
K3_FORMS = (("k3_in_gridder_cuda_v6_pieces", "gridder_cuda_v6_pieces"),
            ("k3_in_degridder_cuda_v7_fused", "degridder_cuda_v7_fused"))
# the separable rungs' mean errors against the f64 oracle at w = 0 before
# their redesign (NVIDIA H100 80GB HBM3, 700 W); the redesigned kernels stay
# within 10% of them
SEPARABLE_W0_ERRORS = {("gridder", "cuda_v3"): 2.673e-06, ("gridder", "cuda_v4"): 2.775e-06,
                       ("gridder", "cuda_v5"): 8.645e-06,
                       ("degridder", "cuda_v3"): 6.824e-07, ("degridder", "cuda_v4"): 7.024e-06,
                       ("degridder", "cuda_v5"): 7.121e-06}


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors given, or of every tensor field of a staging."""
    import dataclasses

    import torch

    total = 0
    for obj in objs:
        if dataclasses.is_dataclass(obj):
            total += tensor_bytes(*(getattr(obj, f.name) for f in dataclasses.fields(obj)))
        elif isinstance(obj, torch.Tensor):
            total += obj.nbytes
    return total


def kernel_row(name, source, replaces, max_abs, ms, plain_ms, nbytes, flops,
               unit="fp32", library_ms=None) -> dict:
    """One entry of the JSON `kernels` line. `nbytes` reads each input once
    and writes each output once; `flops` are the operations of this call,
    done on `unit` ("fp32", the CUDA cores, or "bf16" / "tf32", the tensor
    cores); the bound comes from idg_tpu_torch/utils/roofline.py."""
    from idg_tpu_torch.utils.roofline import bound_seconds

    bound_s, bound_by = bound_seconds(flops, nbytes, unit)
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                bound_by=bound_by, library_ms=library_ms)


def model_flops(params, fused: bool = False) -> float:
    """The reference's operation model of one gridder/degridder pass
    (utils/costs.py), with the grid stage's (i)DFT for a fused form."""
    from idg_tpu_torch.utils.costs import grid_costs, workload_costs

    return 1e9 * (workload_costs(params)[0] + (grid_costs(params)[0] if fused else 0.0))


def window_index(cy, cx, oy, ox, n: int, g: int, p: int):
    """i64[S·P·N·N]: the flat [P·G·G] grid index of each pixel of the
    block-rolled pieces of the subgrids at corners (cy, cx) rolled by
    (oy, ox): piece row y sits at grid row (cy + (y − oy) mod N) mod G."""
    import torch

    i = torch.arange(n, device=cy.device)
    rows = (cy[:, None].long() + (i[None, :] - oy[:, None].long()) % n) % g
    cols = (cx[:, None].long() + (i[None, :] - ox[:, None].long()) % n) % g
    pix = rows[:, :, None] * g + cols[:, None, :]
    pols = torch.arange(p, device=cy.device)[None, :, None, None] * g * g
    return (pols + pix[:, None]).reshape(-1)


def index_add_grid(pieces, idx, size: int):
    """The library yardstick of a grid-add: one index_add_ of every piece
    pixel into a fresh flat grid of `size` complex values."""
    import torch

    grid = torch.zeros(size, dtype=torch.complex64, device=pieces.device)
    torch.view_as_real(grid).index_add_(0, idx, torch.view_as_real(pieces.reshape(-1)))
    return grid


def run_blocks(starts, lens, nrows: int):
    """i64[nrows]: the block each piece row is added into by a range plan's
    runs, and ncols for the rows in no run (summed into a spare block)."""
    ncols = starts.shape[1]
    out = np.full(nrows, ncols, np.int64)
    for q in range(starts.shape[0]):
        ln = lens[q].astype(np.int64)
        if not ln.sum():
            continue
        first = np.cumsum(ln) - ln
        out[np.repeat(starts[q].astype(np.int64) - first, ln) + np.arange(ln.sum())] = \
            np.repeat(np.arange(ncols), ln)
    return out


def index_add_blocks(pieces, blocks, nblocks: int):
    """The library yardstick of a block-aligned grid-add: one index_add_ of
    each piece into its block, c64[nblocks + 1, P·N·N] (the grid's blocks
    before the layout permute; the spare block takes rows in no block)."""
    import torch

    out = torch.zeros((nblocks + 1, pieces[0].numel()), dtype=torch.complex64,
                      device=pieces.device)
    torch.view_as_real(out).index_add_(0, blocks,
                                       torch.view_as_real(pieces.reshape(pieces.shape[0], -1)))
    return out


def launch_counts() -> dict:
    """Every wrapper's launch count, by the kernel names of the JSON line."""
    from idg_tpu_torch.ops import cuda as k

    counts = {w.__name__: w.launches for w in k.KERNELS}
    counts["degridder_cuda_v7_fused"] = k.degridder_cuda_v7.fused_launches
    return counts


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def phase_done(label: str, t0: float) -> float:
    """Print the seconds since t0 under [time]; return the clock now."""
    phase("time", f"{label}: {time.perf_counter() - t0:.1f} s")
    return time.perf_counter()


def device_ms(fn, *args, harness) -> float:
    from idg_tpu_torch.utils.timing import time_kernel

    return time_kernel(fn, *args, harness=harness).seconds * 1e3


def compare(name: str, got, want, exact: bool = False, tag: str = "grid",
            gate: float = GATE) -> float:
    """Gate `got` (kernel, on the card) against `want` (plain version), mean
    error at most `gate`; returns the max abs error. Raises on a miss or a
    non-finite value."""
    import torch

    from idg_tpu_torch.utils.compare import check_error

    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(got) if got.is_complex() else got).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    want = want.to(got.device)
    max_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    if exact:
        ok = max_abs == 0.0
        msg = f"max_abs_err {max_abs:.3e} (exact)"
    else:
        res = check_error(got, want, verbose=False)
        ok = res.passed and res.mean_error <= gate
        msg = (f"mean_error {res.mean_error:.3e} (gate {gate:g}), max_abs_err "
               f"{max_abs:.3e}, max |reference| {scale:.3e}")
    phase(tag, f"{name}: {msg} {'PASSED' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{name} disagrees with its reference")
    return max_abs


def kernels_vs_plain(rows, tag, cases, timing, plain_timing, flops, unit="fp32", gate=GATE):
    """Each case (name, kernel, plain, small_args, full_args, source,
    replaces): the kernel against its plain version on the small arguments
    (mean error at most `gate`), finite on the full ones, both timed there;
    appends its JSON entry, with `flops` operations done on `unit` (a name,
    or a function of the kernel's name; no library call computes these
    functions)."""
    import torch

    for name, kernel, plain, small_args, full_args, source, replaces in cases:
        max_abs = compare(f"{name} vs plain on {COMPARE_SUBGRIDS} subgrids", kernel(*small_args),
                          plain(*small_args), tag=tag, gate=gate)
        full = kernel(*full_args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(torch.view_as_real(full)).all()):
            raise RuntimeError(f"{name}: non-finite output on the full problem")
        nbytes = tensor_bytes(*full_args) + full.nbytes
        del full
        k_ms = device_ms(kernel, *full_args, harness=timing)
        p_ms = device_ms(plain, *full_args, harness=plain_timing)
        phase(tag, f"{name} full problem ({full_args[1].nr_subgrids} subgrids): kernel "
                   f"{k_ms:.3f} ms, plain {p_ms:.3f} ms")
        rows.append(kernel_row(name, source, replaces, max_abs, k_ms, p_ms, nbytes, flops,
                               unit(name) if callable(unit) else unit))


def k4_report() -> None:
    """Print K4's ptxas registers and spills per instance (csrc/grid_add.cu)
    and its resident blocks an SM; raise if an instance is missing or
    spills."""
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.cuda import build

    lines = build.build_log.splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        found = re.search(r"grid_add_kernelILi(\d+)E", line)
        if "Compiling entry" in line and found:
            ptxas[found.group(1)] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
    for n in ("32", "16"):
        phase("grid", f"K4 (grid_add_kernel<{n}>): {kernels.grid_add_blocks_per_sm(int(n))} "
                      f"blocks an SM; ptxas {ptxas.get(n, 'missing')}")
    if sorted(ptxas) != ["16", "32"] or any(" 0 bytes spill stores" not in line
                                            for line in ptxas.values()):
        raise RuntimeError("K4: an instance is missing from ptxas's report or spills")


def same_twice(name: str, first, second, tag: str) -> None:
    """Raise unless two launches gave the same output bit for bit."""
    import torch

    torch.cuda.synchronize()
    same = bool(torch.equal(first, second))
    phase(tag, f"{name}: two launches give the same grid bit for bit: {same}")
    if not same:
        raise RuntimeError(f"{name} is not deterministic")


def grid_stage_phase(rows, timing, plain_timing):
    """Phase 6: each grid-stage kernel against its plain version on the
    card, then timed both ways on the full block-sorted default problem;
    both fused pipelines against the f64 oracle on a small problem."""
    import torch

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import make_observation, make_perf_observation
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops import grid as tgrid
    from idg_tpu_torch.ops.api import (gridded_pipeline_parts,
                                       staged_degridder_pieces_chunk_consumers)
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda.grid import _home_corners
    from idg_tpu_torch.utils import roofline
    from idg_tpu_torch.utils.roofline import bound_seconds

    # the fused pipelines against the f64 oracle, 40 subgrids at N = 32
    params = IDGParams(grid_size=256, nr_stations=5, nr_timeslots=4, nr_timesteps_subgrid=32,
                       nr_channels=8)
    g, n = params.grid_size, params.subgrid_size
    obs, _ = tgrid.sort_observation_blocks(make_observation(params)[0], g, n)
    md = obs.metadata
    pfn, pargs, gfn, _, _ = gridded_pipeline_parts(params, obs)
    want = tgrid.subgrids_to_grid(torch.from_numpy(gridder_reference(params, obs)),
                                  md.coord_x, md.coord_y, g)
    compare("gridded pipeline vs f64 oracle (40 subgrids)", gfn(pfn(*pargs)), want)
    grid = torch.complex(*(torch.from_numpy((np.random.default_rng(11).normal(
        size=(4, g, g)) / n**2).astype(np.float32)) for _ in range(2)))
    oyx = tgrid.roll_offsets(md.coord_x, md.coord_y, g, n)
    (consumer,), _, _ = staged_degridder_pieces_chunk_consumers(params, obs, oyx=oyx)
    pieces = tgrid.grid_to_subgrids_ranges(grid.cuda(), md.coord_x, md.coord_y, n, pieces=True)
    want = degridder_reference(params, obs, tgrid.grid_to_subgrids(
        grid, md.coord_x, md.coord_y, n).numpy())
    compare("degrid pipeline vs f64 oracle (40 subgrids)", consumer(pieces),
            torch.from_numpy(want))

    # each kernel against its plain version: 512 sorted subgrids, then timed.
    # The grid is normal(0, 1)/N², so the visibilities are O(1) like the
    # reference's correctness data (check_error's metric grows with the
    # square root of the values' magnitude).
    params = IDGParams.from_env()
    g, n = params.grid_size, params.subgrid_size
    obs, _ = tgrid.sort_observation_blocks(make_perf_observation(params), g, n)
    md = obs.metadata
    torch.cuda.reset_peak_memory_stats()
    stg = stage(params, obs, "cuda")
    phase("grid", f"block-sorted staging (time gather path): peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on the device")
    oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, g, n), device="cuda")
    cx, cy = (torch.as_tensor(np.asarray(c, np.int32), device="cuda")
              for c in (md.coord_x, md.coord_y))
    plan = tgrid.plan_grid_add_ranges(md.coord_x, md.coord_y, g, n)
    k = COMPARE_SUBGRIDS
    small = slice_staged(stg, 0, k)
    plan_k = tgrid.plan_grid_add_ranges(md.coord_x[:k], md.coord_y[:k], g, n)
    grid = torch.complex(*(torch.as_tensor((np.random.default_rng(11).normal(
        size=(4, g, g)) / n**2).astype(np.float32), device="cuda") for _ in range(2)))
    pieces = kernels.gridder_cuda_v6_pieces(params, stg, oyx, 2)
    xpieces = kernels.grid_extract_cuda(grid, cx, cy, n)
    torch.cuda.synchronize()
    cases = (
        ("gridder_cuda_v6_pieces", kernels.gridder_cuda_v6_pieces,
         kernels.gridder_v6_pieces_plain, (params, small, oyx[:k], 2), (params, stg, oyx, 2),
         "idg_tpu_torch/csrc/gridder.cu", "idg_tpu/ops/pallas/gridder.py:942", False),
        ("grid_add_cuda", kernels.grid_add_cuda, kernels.grid_add_plain,
         (pieces[:k], oyx[:k], plan_k, g), (pieces, oyx, plan, g),
         "idg_tpu_torch/csrc/grid_add.cu", "idg_tpu/ops/grid.py:923", False),
        ("grid_extract_cuda", kernels.grid_extract_cuda, kernels.grid_extract_plain,
         (grid, cx[:k], cy[:k], n), (grid, cx, cy, n),
         "idg_tpu_torch/csrc/grid_extract.cu", "idg_tpu/ops/grid.py:1228", True),
        ("degridder_cuda_v7_fused", lambda *a: kernels.degridder_cuda_v7(*a[:4], fuse_oyx=a[4]),
         lambda *a: kernels.degridder_plain(*a[:2], tgrid._finish_extract(a[2], a[4]), a[3]),
         (params, small, xpieces[:k], 2, oyx[:k]), (params, stg, xpieces, 2, oyx),
         "idg_tpu_torch/csrc/degridder.cu", "idg_tpu/ops/pallas/degridder.py:1022", False),
    )
    # operations and the library yardstick per kernel: the grid-add as one
    # index_add_ of every piece pixel, the extraction as one gather
    p = params.nr_correlations
    hcy, hcx = _home_corners(plan, oyx)
    add_idx = window_index(hcy, hcx, oyx[:, 0], oyx[:, 1], n, g, p)
    ecy, ecx = cy.long() % g, cx.long() % g
    extract_idx = window_index(ecy, ecx, ecy % n, ecx % n, n, g, p)
    units = {"gridder_cuda_v6_pieces": roofline.unit("gridder", "cuda_v6"),      # TF32
             "degridder_cuda_v7_fused": roofline.unit("degridder", "cuda_v7")}   # TF32
    flops = {"gridder_cuda_v6_pieces": model_flops(params, True),
             "grid_add_cuda": 2.0 * pieces.numel(), "grid_extract_cuda": 0.0,
             "degridder_cuda_v7_fused": model_flops(params, True)}
    library = {"grid_add_cuda": lambda: index_add_grid(pieces, add_idx, p * g * g),
               "grid_extract_cuda": lambda: torch.view_as_real(grid).reshape(-1, 2)[extract_idx]}
    k4_report()
    times = {}
    for name, kernel, plain, small_args, full_args, source, replaces, exact in cases:
        max_abs = compare(f"{name} vs plain on {k} subgrids", kernel(*small_args),
                          plain(*small_args), exact)
        full = kernel(*full_args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(torch.view_as_real(full)).all()):
            raise RuntimeError(f"{name}: non-finite output on the full problem")
        if name == "grid_add_cuda":
            same_twice(name, full, kernel(*full_args), "grid")
        nbytes = tensor_bytes(*full_args) + full.nbytes
        del full
        k_ms = device_ms(kernel, *full_args, harness=timing)
        p_ms = device_ms(plain, *full_args, harness=plain_timing)
        lib_ms = device_ms(library[name], harness=timing) if name in library else None
        times[name] = k_ms
        phase("grid", f"{name} full problem ({params.nr_subgrids} subgrids): kernel "
                      f"{k_ms:.3f} ms, plain {p_ms:.3f} ms"
                      + (f", library {lib_ms:.3f} ms" if lib_ms is not None else ""))
        rows.append(kernel_row(name, source, replaces, max_abs, k_ms, p_ms, nbytes,
                               flops[name], units.get(name, "fp32"), library_ms=lib_ms))
    del add_idx, extract_idx

    # K3 runs inside the fused kernels, on the TF32 tensor cores: check each
    # direction on the full problem against the plain (i)DFT + roll of the
    # same non-fused kernel's subgrids, and time what the fused forms cost
    # over the non-fused ones in this call, at N = 32 (the default problem)
    # and N = 16, beside one torch.fft.fft2 over the same subgrids. K3's
    # bound is its operations alone (it moves no bytes of its own): the
    # two-stage DFT's 2·P·8·N³ FLOP a subgrid at the TF32 peak, and its own
    # three-pass floor
    sub = kernels.gridder_cuda_v6(params, stg, 2)
    k3_abs = {"k3_in_gridder_cuda_v6_pieces": compare(
        "K3 (inverse, in the fused gridder) vs plain on the full problem", pieces,
        tgrid.pieces_from_subgrids(sub, oyx))}
    k3_abs["k3_in_degridder_cuda_v7_fused"] = compare(
        "K3 (forward, in the fused degridder) vs plain on the full problem",
        kernels.degridder_cuda_v7(params, stg, xpieces, 2, fuse_oyx=oyx),
        kernels.degridder_cuda_v7(params, stg, tgrid._finish_extract(xpieces, oyx), 2))
    k3_plain = {"k3_in_gridder_cuda_v6_pieces": device_ms(
        tgrid.pieces_from_subgrids, sub, oyx, harness=plain_timing),
        "k3_in_degridder_cuda_v7_fused": device_ms(
        tgrid._finish_extract, xpieces, oyx, harness=plain_timing)}
    del stg, small, pieces, xpieces, grid, sub
    torch.cuda.empty_cache()
    for n_k3 in (32, 16):
        p_k3 = IDGParams.from_env(subgrid_size=n_k3)
        obs_k3, _ = tgrid.sort_observation_blocks(make_perf_observation(p_k3), g, n_k3)
        md_k3 = obs_k3.metadata
        stg = stage(p_k3, obs_k3, "cuda")
        oyx = torch.as_tensor(tgrid.roll_offsets(md_k3.coord_x, md_k3.coord_y, g, n_k3),
                              device="cuda")
        sub = kernels.gridder_cuda_v6(p_k3, stg, 2)
        xpieces = tgrid.pieces_from_subgrids(sub, oyx)
        ms_k3 = {"gridder_cuda_v6": device_ms(kernels.gridder_cuda_v6, p_k3, stg, 2,
                                              harness=timing),
                 "gridder_cuda_v6_pieces": device_ms(kernels.gridder_cuda_v6_pieces, p_k3,
                                                     stg, oyx, 2, harness=timing),
                 "degridder_cuda_v7": device_ms(kernels.degridder_cuda_v7, p_k3, stg, sub, 2,
                                                harness=timing),
                 "degridder_cuda_v7_fused": device_ms(
                     lambda *a: kernels.degridder_cuda_v7(*a[:4], fuse_oyx=a[4]), p_k3, stg,
                     xpieces, 2, oyx, harness=timing)}
        lib_ms = device_ms(torch.fft.fft2, sub, harness=timing)
        k3_flops = 2.0 * p * 8 * n_k3**3 * p_k3.nr_subgrids
        k3_s, k3_by = bound_seconds(k3_flops, 0, "tf32")
        phase("grid", f"K3 (N = {n_k3}, {p_k3.nr_subgrids} subgrids): bound {k3_s * 1e3:.3f} ms "
                      f"({k3_by}, TF32; three passes {3 * k3_s * 1e3:.3f} ms), library "
                      f"(torch.fft.fft2 over c64{list(sub.shape)}) {lib_ms:.3f} ms")
        for name, fused in K3_FORMS:
            base = fused.replace("_pieces", "").replace("_fused", "")
            inc = ms_k3[fused] - ms_k3[base]
            phase("grid", f"K3 in {fused} (N = {n_k3}): {ms_k3[fused]:.3f} ms, non-fused form "
                          f"{ms_k3[base]:.3f} ms ({inc:+.3f} ms); torch.fft.fft2 {lib_ms:.3f} ms")
            if n_k3 == params.subgrid_size:
                rows.append(kernel_row(name, "idg_tpu_torch/csrc/dft.cuh",
                                            "idg_tpu/ops/pallas/gridder.py:118", k3_abs[name],
                                            inc, k3_plain[name], 0, k3_flops, "tf32",
                                            library_ms=lib_ms))
        del stg, sub, xpieces
        torch.cuda.empty_cache()


def pipeline_phase(rows, params=None, row_names=None):
    """Phase 7 (and its LOFAR-4096 run in phase 8): the `pipeline` command,
    each direction with counted launches, then against its --no-fuse form.
    The grid direction must take K4 (grid_add_cuda) and not K6. A kernel's
    launches go to its JSON row, or to the row `row_names` gives for it.
    Returns each direction's seconds per pass."""
    import torch

    from idg_tpu_torch import cli
    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.costs import workload_costs

    _, _, mvis = workload_costs(params or IDGParams.from_env())
    path = {"grid": ("gridder_cuda_v6_pieces", "grid_add_cuda"),
            "degrid": ("grid_extract_cuda", "degridder_cuda_v7_fused")}
    absent = {"grid": {"grid_add_pieces_cuda"}, "degrid": set()}
    by_name = {row["name"]: row for row in rows}
    row_names = row_names or {}
    seconds = {}
    for direction, names in path.items():
        from idg_tpu_torch.ops import cuda as kernels

        kernels.reset_launch_counts()
        res = cli._pipeline_one(direction, params=params)
        counts = launch_counts()
        launches = {name: counts[name] for name in names}
        phase("pipeline", f"{res.name}: {res.seconds * 1e3:.3f} ms/pass, "
                          f"{mvis / res.seconds:.2f} MVis/s; kernel "
                          f"{res.kernel_seconds * 1e3:.3f} ms, grid stage "
                          f"{res.grid_seconds * 1e3:.3f} ms; launches {launches}")
        for name, n in launches.items():
            by_name[row_names.get(name, name)]["launches"] += n
            if n == 0:
                raise RuntimeError(f"{name} was never launched on the {direction} pipeline")
        for name, fused in K3_FORMS:   # K3 launches with its fused form
            if fused in launches and name in by_name:
                by_name[name]["launches"] += launches[fused]
        for name in absent[direction]:
            if counts[name]:
                raise RuntimeError(f"{name} launched on the {direction} pipeline, which "
                                   f"takes {names}")
        ref = cli._pipeline_one(direction, no_fuse=True, suffix="_nofuse", params=params)
        # gated on both outputs over max|ref|, which makes check_error's metric
        # a normalized RMS: the CLI's degrid grid is normal(0, 1), so the
        # visibilities reach ~1e3, where the raw metric (printed too) grows
        # with their magnitude
        scale = float(ref.output.abs().max())
        raw = check_error(res.output, ref.output, verbose=False)
        ok = check_error(res.output / scale, ref.output / scale, verbose=False)
        phase("pipeline", f"{res.name} vs {ref.name} ({ref.seconds * 1e3:.3f} ms/pass): "
                          f"mean_error {ok.mean_error:.3e} over max |ref| {scale:.3e} "
                          f"(gate {GATE:g}; raw {raw.mean_error:.3e}) "
                          f"{'PASSED' if ok.passed else 'FAILED'}")
        if not ok.passed:
            raise RuntimeError(f"{res.name} disagrees with its --no-fuse composition")
        seconds[direction] = res.seconds
        del res, ref
        torch.cuda.empty_cache()
    return seconds


def grid_add_phase(rows, timing, plain_timing):
    """Phase 8: K6, K4 (LOFAR-4096, its own JSON row), K7, K11a and K11b
    against their plain versions at the shapes the `grid` command and the
    LOFAR-4096 pipeline give them, timed both ways; then the command's
    grid-add paths with counted launches, and the LOFAR-4096 pipelines."""
    import torch

    from idg_tpu_torch import cli
    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import make_perf_observation
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops import grid as tgrid
    from idg_tpu_torch.ops.cuda.grid import _home_corners

    gen = torch.Generator(device="cuda").manual_seed(11)

    def problem(**over):
        """Block-sorted coords of the perf problem, random image-domain tiles
        on the card (random, so that a misrouted piece cannot hide), and the
        tiles' quadrant and masked pieces."""
        params = IDGParams.from_env(**over)
        g, n = params.grid_size, params.subgrid_size
        md = make_perf_observation(params).metadata
        _, cx, cy = tgrid.sorted_block_coords(md.coord_x, md.coord_y, g, n)
        tiles = torch.randn((params.nr_subgrids, params.nr_correlations, n, n),
                            dtype=torch.complex64, device="cuda", generator=gen)
        oyx = torch.as_tensor(tgrid.roll_offsets(cx, cy, g, n), device="cuda")
        return params, cx, cy, tiles, oyx

    def case(name, kernel, plain, args, source, replaces, library, detail=""):
        """Kernel against plain, both timed, and the library yardstick
        (`library`, no arguments): one index_add_ of each piece into its
        block, or of every piece pixel into the grid (K4)."""
        got = kernel(*args)
        max_abs = compare(f"{name} vs plain{detail}", got, plain(*args), tag="grid-add")
        nbytes = tensor_bytes(args[0]) + got.nbytes
        del got
        k_ms = device_ms(kernel, *args, harness=timing)
        p_ms = device_ms(plain, *args, harness=plain_timing)
        lib_ms = device_ms(library, harness=timing)
        phase("grid-add", f"{name}{detail}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                          f"library {lib_ms:.3f} ms")
        rows.append(kernel_row(name, source, replaces, max_abs, k_ms, p_ms, nbytes,
                               2.0 * args[0].numel(), library_ms=lib_ms))

    def slot_library(quad, splan):
        blocks = torch.as_tensor(splan.piece_blocks.astype(np.int64), device="cuda")
        return lambda: index_add_blocks(quad, blocks, splan.nby * splan.nbx)

    def run_library(masked, plan):
        blocks = torch.as_tensor(run_blocks(plan.starts, plan.lens, masked.shape[0]),
                                 device="cuda")
        return lambda: index_add_blocks(masked, blocks, plan.nb)

    # K11a on the default problem's quadrant pieces (the --method pallas path)
    params, cx, cy, tiles, oyx = problem()
    g, n = params.grid_size, params.subgrid_size
    splan = tgrid.plan_grid_add(cx, cy, g, n)
    quad = tgrid._quadrant_pieces(tiles, cy, cx, g)
    case("grid_add_scatter_cuda", kernels.grid_add_scatter_cuda, kernels.grid_add_scatter_plain,
         (quad, splan), "idg_tpu_torch/csrc/grid_add_slots.cu", "idg_tpu/ops/grid.py:1819",
         slot_library(quad, splan), f" ({g}², {quad.shape[0]} pieces, atomics)")
    del quad, tiles
    torch.cuda.empty_cache()

    # K6 and K11b on LOFAR-4096; K4 on the same problem's block-rolled
    # pieces (the route its `grid` command and pipeline take), its library
    # yardstick one index_add_ of every piece pixel, beside the masked
    # pieces + K6 (the JAX dispatch's sparse route)
    params, cx, cy, tiles, oyx = problem(**LOFAR_4096)
    g, n = params.grid_size, params.subgrid_size
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    occupied = int((plan.lens[:, :plan.nb].sum(axis=0) > 0).sum())
    phase("grid-add", f"LOFAR-4096: S = {params.nr_subgrids}, {plan.nb} blocks, {occupied} "
                      f"occupied, route {tgrid.ranges_route(plan)}")
    masked = tgrid._mask_pieces(tiles, oyx[:, 0], oyx[:, 1])
    case("grid_add_pieces_cuda", kernels.grid_add_pieces_cuda, kernels.grid_add_pieces_plain,
         (masked, plan), "idg_tpu_torch/csrc/grid_add_pieces.cu", "idg_tpu/ops/grid.py:616",
         run_library(masked, plan), f" (LOFAR-4096 masked pieces, {masked.shape[0]})")
    del masked
    hcy, hcx = _home_corners(plan, oyx)
    add_idx = window_index(hcy, hcx, oyx[:, 0], oyx[:, 1], n, g, params.nr_correlations)
    case("grid_add_cuda_lofar4096", kernels.grid_add_cuda, kernels.grid_add_plain,
         (tiles, oyx, plan, g), "idg_tpu_torch/csrc/grid_add.cu", "idg_tpu/ops/grid.py:923",
         lambda: index_add_grid(tiles, add_idx, params.nr_correlations * g * g),
         f" (LOFAR-4096 block-rolled pieces, {tiles.shape[0]})")
    del add_idx
    same_twice("grid_add_cuda_lofar4096", kernels.grid_add_cuda(tiles, oyx, plan, g),
               kernels.grid_add_cuda(tiles, oyx, plan, g), "grid-add")
    k6_ms = device_ms(lambda t: kernels.grid_add_pieces_cuda(
        tgrid._mask_pieces(t, oyx[:, 0], oyx[:, 1]), plan), tiles, harness=timing)
    k4_ms = next(row["ms"] for row in rows if row["name"] == "grid_add_cuda_lofar4096")
    phase("grid-add", f"LOFAR-4096 grid stage on the same pieces: K4 {k4_ms:.3f} ms (taken), "
                      f"mask + K6 (the JAX dispatch's sparse route) {k6_ms:.3f} ms")
    splan = tgrid.plan_grid_add(cx, cy, g, n)
    quad = tgrid._quadrant_pieces(tiles, cy, cx, g)
    case("grid_add_slots_cuda", kernels.grid_add_slots_cuda, kernels.grid_add_slots_plain,
         (quad, splan), "idg_tpu_torch/csrc/grid_add_slots.cu", "idg_tpu/ops/grid.py:2028",
         slot_library(quad, splan), f" (LOFAR-4096, cap {splan.cap})")
    del quad, tiles
    torch.cuda.empty_cache()

    # K7 on 16384²: one stripe with wrap misses compared, every stripe timed
    params, cx, cy, tiles, oyx = problem(**GRID_16384)
    g, n = params.grid_size, params.subgrid_size
    plan = tgrid.plan_grid_add_ranges(cx, cy, g, n)
    mplan = tgrid.merged_plan_for(plan)
    if mplan is None or mplan.m != 64:
        raise RuntimeError("16384²: the merged plan should take m = 64")
    masked = tgrid._mask_pieces(tiles, oyx[:, 0], oyx[:, 1])
    del tiles
    stripe = (tgrid.MAX_RANGE_BLOCKS // plan.nbx) * plan.nbx
    lo = int(mplan.miss_blocks[0]) // stripe * stripe
    phase("grid-add", f"16384²: m = {mplan.m}, wm = {mplan.wm}, {len(mplan.miss_rows)} wrap "
                      f"misses, {int((mplan.gocc > 0).sum())} of {mplan.gocc.size} groups "
                      f"occupied, {plan.nb // stripe} stripes of {stripe} blocks")
    max_abs = compare(f"grid_add_merged_cuda vs plain (16384² stripe [{lo}, {lo + stripe}))",
                      kernels.grid_add_merged_cuda(masked, plan, mplan, lo, lo + stripe),
                      kernels.grid_add_merged_plain(masked, plan, mplan, lo, lo + stripe),
                      tag="grid-add")

    def all_stripes(fn):
        def run(pieces):
            for s0 in range(0, plan.nb, stripe):
                fn(pieces, plan, mplan, s0, s0 + stripe)
        return run

    k_ms = device_ms(all_stripes(kernels.grid_add_merged_cuda), masked, harness=timing)
    p_ms = device_ms(all_stripes(kernels.grid_add_merged_plain), masked, harness=plain_timing)
    lib_ms = device_ms(run_library(masked, plan), harness=timing)
    phase("grid-add", f"grid_add_merged_cuda, all {plan.nb // stripe} stripes: kernel "
                      f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (zero-filled bands included), "
                      f"library {lib_ms:.3f} ms")
    rows.append(kernel_row("grid_add_merged_cuda", "idg_tpu_torch/csrc/grid_add_merged.cu",
                           "idg_tpu/ops/grid.py:788", max_abs, k_ms, p_ms,
                           masked.nbytes + params.nr_correlations * g * g * 8,
                           2.0 * masked.numel(), library_ms=lib_ms))
    del masked
    torch.cuda.empty_cache()

    # the `grid` command's paths through the new kernels, counted launches
    by_name = {row["name"]: row for row in rows}
    # (label, problem, options, the kernel it must launch and its JSON row)
    paths = (
        ("grid", {}, {}, "grid_add_cuda", "grid_add_cuda"),
        ("grid --no-fft --method ranges", {}, dict(no_fft=True, method="ranges"),
         "grid_add_pieces_cuda", "grid_add_pieces_cuda"),
        ("grid --method pallas", {}, dict(method="pallas"), "grid_add_scatter_cuda",
         "grid_add_scatter_cuda"),
        ("LOFAR-4096 grid --method pallas", LOFAR_4096, dict(method="pallas"),
         "grid_add_slots_cuda", "grid_add_slots_cuda"),
        ("LOFAR-4096 grid", LOFAR_4096, {}, "grid_add_cuda", "grid_add_cuda_lofar4096"),
        ("16384² grid", GRID_16384, {}, "grid_add_merged_cuda", "grid_add_merged_cuda"),
        ("16384² grid --direction to-subgrids", GRID_16384, dict(direction="to-subgrids"),
         "grid_extract_cuda", "grid_extract_cuda"),
    )
    for label, over, kwargs, name, row in paths:
        kernels.reset_launch_counts()
        res = cli._grid_one(params=IDGParams.from_env(**over), **kwargs)
        launches = {k: v for k, v in launch_counts().items() if v}
        outputs = res.output if isinstance(res.output, (list, tuple)) else [res.output]
        finite = all(bool(torch.isfinite(torch.view_as_real(o)).all()) for o in outputs)
        phase("grid-add", f"{label}: {res.name} {res.seconds * 1e3:.3f} ms ({res.method}); "
                          f"launches {launches}; output finite {finite}")
        if not launches.get(name):
            raise RuntimeError(f"{name} was never launched on `{label}`")
        if row == "grid_add_cuda_lofar4096" and launches.get("grid_add_pieces_cuda"):
            raise RuntimeError(f"`{label}` launched K6; its grid-add is K4")
        if not finite:
            raise RuntimeError(f"`{label}` gave a non-finite output")
        by_name[row]["launches"] += launches.get(name, 0)
        del res, outputs
        torch.cuda.empty_cache()

    # both LOFAR-4096 pipelines against their --no-fuse compositions
    pipeline_phase(rows, IDGParams.from_env(**LOFAR_4096),
                   row_names={"grid_add_cuda": "grid_add_cuda_lofar4096"})


def direct_oracle_problems():
    """(label, params, observation, subgrids) of the direct rungs' oracle
    gate (DIRECT_ORACLE_GATE) on the correctness problem (N = 32, T = 128,
    C = 16): w = 0, w = 2·10⁴, C = 256 at N = 16 (32 restarts of the
    recurrence), C = 7 and 11 (channel groups that are not whole) and T = 37
    (a ragged tile of timesteps)."""
    import dataclasses

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import initialize_subgrids, make_observation

    base = IDGParams.correctness_defaults()
    problems = []
    for label, over in (("w=0", {}), (f"w={STRESS_W:g}", {}),
                        ("C = 256, N = 16", dict(subgrid_size=16, nr_channels=256)),
                        ("C = 7", dict(nr_channels=7)), ("C = 11", dict(nr_channels=11)),
                        ("T = 37", dict(nr_timesteps_subgrid=37))):
        p = dataclasses.replace(base, **over)
        obs, _ = make_observation(p)
        if label.startswith("w=") and label != "w=0":
            uvw = np.array(obs.uvw, copy=True)
            uvw[:, :, 2] = STRESS_W
            obs = dataclasses.replace(obs, uvw=uvw)
        sub = np.ascontiguousarray(initialize_subgrids(p.nr_subgrids, p.nr_correlations,
                                                       p.subgrid_size))
        problems.append((label, p, obs, sub))
    return problems


def direct_phase(rows, timing):
    """Phase 9: the exact full-phase rungs (K8a, K9a), the w-free rungs and
    K10: ptxas lines and HMMA counts of the direct instances; against the
    f64 oracle, against their plain versions on the card, timed; the check
    sweep over every version; then perf mode for the four direct versions
    and `vadd` both ways, with counted launches."""
    import contextlib
    import io
    import warnings

    import torch

    from idg_tpu_torch import cli
    from idg_tpu_torch.bench import V100_DEGRIDDER_REFERENCE_MVIS_S, V100_GRIDDER_REFERENCE_MVIS_S
    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import (initialize_subgrids, make_observation,
                                    make_perf_observation, make_w_observation)
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops import vadd as tvadd
    from idg_tpu_torch.ops.api import _resolve, run_degridder, run_gridder
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.utils import roofline
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.costs import workload_costs

    t_start = time.perf_counter()
    # K8a and K9a on the TF32 tensor cores (mma.sync): every instance there,
    # none spilling
    instance_report("direct", "K8a", r"\d+gridder_direct_kernel", "HMMA",
                    ("cuda_v1", "cuda_v2"), no_spill=True)
    instance_report("direct", "K9a", r"\d+degridder_direct_kernel", "HMMA",
                    ("cuda_v1", "cuda_v2"), no_spill=True)

    # against the f64 oracle: the direct rungs on the direct gate's problems
    # with no guard engaged (DIRECT_ORACLE_GATE), the w-free rungs at w = 0
    # as themselves and at w != 0 (w_scale 1000) through their fallback
    params = IDGParams.correctness_defaults()
    obs0, _ = make_observation(params)
    sub = initialize_subgrids(params.nr_subgrids, params.nr_correlations, params.subgrid_size)
    params_w, obs_w, _ = make_w_observation(params, w_scale=1000.0)

    def oracle_check(label, workload, version, p, obs, resolves_to, warns, sub=sub,
                     plain=None):
        """The rung through the API against the oracle (1e-5); with `plain`,
        the direct rungs' plain version on the CPU, within DIRECT_ORACLE_GATE,
        or DIRECT_PLAIN_SLACK × the plain version's own error where that is
        past it (and past 1e-5 only where the plain version is)."""
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            resolved = _resolve(workload, version, p, obs)
            if workload == "gridder":
                got, want = run_gridder(p, obs, version, device="cuda"), gridder_reference(p, obs)
            else:
                got = run_degridder(p, obs, sub, version, device="cuda")
                want = degridder_reference(p, obs, sub)
        res = check_error(got, want, verbose=False)
        messages = [str(w.message) for w in record]
        ok = res.passed and resolved[0] == resolves_to and (
            any(warns in m for m in messages) if warns else not messages)
        detail = f"(gate {GATE:g})"
        if plain is not None:
            # the rung's definition sets the bound: where its own float32
            # phases miss the 1e-5 gate (the gridders at C = 256), so may it
            own = check_error(plain, want, verbose=False)
            bound = max(DIRECT_ORACLE_GATE, DIRECT_PLAIN_SLACK * own.mean_error)
            ok = (res.passed or not own.passed) and res.mean_error <= bound and (
                resolved[0] == resolves_to and not messages)
            detail = f"(bound {bound:.3e}; plain version {own.mean_error:.3e})"
        phase("direct", f"{workload} {version} {label}: resolved {resolved}, mean_error "
                        f"{res.mean_error:.3e} {detail}, warnings {len(messages)} "
                        f"{'PASSED' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"{workload} {version} {label} failed: {messages}")

    for label, p, obs, sub_p in direct_oracle_problems():
        stg_p = stage(p, obs, "cpu")   # the plain versions in float32 CPU ops
        for workload, version in DIRECT:
            rec = version == "cuda_v2"
            if workload == "gridder":
                plain = kernels.gridder_direct_plain(p, stg_p, rec)
            else:
                plain = kernels.degridder_direct_plain(p, stg_p, torch.from_numpy(sub_p), rec)
            oracle_check(label, workload, version, p, obs, version, None, sub=sub_p,
                         plain=plain)
        del stg_p
    for workload, rung, fallback in (("gridder", "cuda_v7", "cuda_v4"),
                                     ("degridder", "cuda_v8", "cuda_v4")):
        oracle_check("w=0", workload, rung, params, obs0, rung, None)
        oracle_check("w!=0 (w_scale 1000)", workload, rung, params_w, obs_w, fallback, "w-free")

    # each kernel against its plain version on the first 512 subgrids of the
    # default problem, then both timed on the full problem; the plain direct
    # versions materialize a phasor per (visibility, pixel): one timed call
    params = IDGParams.from_env()
    stg = stage(params, make_perf_observation(params), "cuda")
    sub_t = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
    k = COMPARE_SUBGRIDS
    small = slice_staged(stg, 0, k)
    plain_once = HarnessConfig(nr_warm_up_runs=0, nr_iterations=1, nr_windows=1)
    cases = []
    for rec, v in ((False, "v1"), (True, "v2")):
        cases += [
            (f"gridder_cuda_{v}", getattr(kernels, f"gridder_cuda_{v}"),
             lambda p, s, rec=rec: kernels.gridder_direct_plain(p, s, rec),
             (params, small), (params, stg),
             "idg_tpu_torch/csrc/gridder_direct.cu", "idg_tpu/ops/pallas/gridder.py:334"),
            (f"degridder_cuda_{v}", getattr(kernels, f"degridder_cuda_{v}"),
             lambda p, s, sb, rec=rec: kernels.degridder_direct_plain(p, s, sb, rec),
             (params, small, sub_t[:k]), (params, stg, sub_t),
             "idg_tpu_torch/csrc/degridder_direct.cu", "idg_tpu/ops/pallas/degridder.py:127"),
        ]
    # the plain direct versions: one timed call; the kernels' products run
    # on the TF32 tensor cores, their bound on its peak
    kernels_vs_plain(rows, "direct", cases, timing, plain_once, model_flops(params),
                     unit=lambda name: roofline.unit(*name.split("_", 1)),
                     gate=DIRECT_PLAIN_GATE)
    del stg, small, sub_t
    torch.cuda.empty_cache()

    n = tvadd.DEFAULT_N
    x, y = tvadd.make_vadd_inputs(n, "cuda")
    max_abs = compare(f"vadd_cuda vs plain (n = {n})", kernels.vadd_cuda(x, y),
                      tvadd.vadd_plain(x, y), exact=True, tag="direct")
    k_ms = device_ms(kernels.vadd_cuda, x, y, harness=timing)
    p_ms = device_ms(tvadd.vadd_plain, x, y, harness=timing)
    lib_ms = device_ms(torch.add, x, y, harness=timing)
    phase("direct", f"vadd_cuda (n = {n}, {tvadd.vadd_gbytes(n):.3f} GB): kernel {k_ms:.3f} ms "
                    f"({tvadd.vadd_gbytes(n) / k_ms:.3f} TB/s), plain {p_ms:.3f} ms, "
                    f"library (torch.add) {lib_ms:.3f} ms")
    rows.append(kernel_row("vadd_cuda", "idg_tpu_torch/csrc/vadd.cu", "idg_tpu/ops/vadd.py:22",
                           max_abs, k_ms, p_ms, 3 * x.nbytes, float(n), library_ms=lib_ms))
    del x, y
    torch.cuda.empty_cache()

    # the check sweep over every registered version, through the CLI
    t_sweep = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["sweep", "--mode", "check"])
    for line in out.getvalue().splitlines():
        if line.startswith(("===", ">>> Result", "!!!", "FAILED")):
            phase("direct", f"sweep: {line}")
    if rc != 0:
        raise RuntimeError(f"sweep --mode check exited {rc}")
    phase_done("phase 9's check sweep", t_sweep)

    # the direct rungs have no fused form: the pipelines take them with
    # --no-fuse and refuse them without
    for direction, name in (("grid", "gridder_cuda_v1"), ("degrid", "degridder_cuda_v1")):
        kernels.reset_launch_counts()
        res = cli._pipeline_one(direction, version="cuda_v1", no_fuse=True, suffix="_nofuse")
        launched = launch_counts()[name]
        finite = bool(torch.isfinite(torch.view_as_real(res.output)).all())
        phase("direct", f"{res.name}: {res.seconds * 1e3:.3f} ms/pass, kernel "
                        f"{res.kernel_seconds * 1e3:.3f} ms; {name} launches {launched}; "
                        f"output finite {finite}")
        if not launched or not finite:
            raise RuntimeError(f"pipeline --direction {direction} --no-fuse --version cuda_v1 failed")
        del res
        try:
            cli._pipeline_one(direction, version="cuda_v1")
        except ValueError as exc:
            phase("direct", f"pipeline --direction {direction} --version cuda_v1: refused ({exc})")
        else:
            raise RuntimeError(f"pipeline --direction {direction} took cuda_v1 without --no-fuse")
        torch.cuda.empty_cache()

    # the main path of this slice: perf mode for the direct versions and
    # vadd both ways, counts set to 0 just before and read just after
    _, _, mvis = workload_costs(params)
    kernels.reset_launch_counts()
    seconds = {f"{w}_{v}": cli._perf_one(w, v) for w, v in DIRECT}
    vadd_s = {"vadd_cuda": cli._vadd_one(n, cuda=True), "vadd": cli._vadd_one(n)}
    counts = launch_counts()
    by_name = {row["name"]: row for row in rows}
    anchors = {"gridder": V100_GRIDDER_REFERENCE_MVIS_S,
               "degridder": V100_DEGRIDDER_REFERENCE_MVIS_S}   # the naive reference kernels
    for name, s in seconds.items():
        anchor = anchors[name.split("_")[0]]
        phase("perf", f"{name}: {s * 1e3:.3f} ms/pass, {mvis / s:.2f} MVis/s "
                      f"({mvis / s / anchor:.1f}x the V100 naive {anchor}), "
                      f"launches {counts[name]}")
    phase("perf", f"vadd --cuda {vadd_s['vadd_cuda'] * 1e3:.3f} ms, vadd (plain x + y) "
                  f"{vadd_s['vadd'] * 1e3:.3f} ms; launches {counts['vadd_cuda']}")
    for name in [*seconds, "vadd_cuda"]:
        by_name[name]["launches"] = counts[name]
        if counts[name] == 0:
            raise RuntimeError(f"{name} was never launched on the main path")
    phase("direct", f"phase 9: {time.perf_counter() - t_start:.1f} s")


def separable_phase(rows, timing):
    """Phase 10: the separable rungs cuda_v3/v4/v5 of both workloads (K8b,
    K8c, K9b, K9c): ptxas lines of every instance and HGMMA counts of the
    v4 and v5 ones; against the f64 oracle at w = 0, at rank 4 and on a
    ragged V, cuda_v5's fallback to cuda_v4 on non-uniform channels; v3, v4
    and v5 against their plain versions at every rank; each kernel against its
    plain version and timed, then perf mode for the six versions with
    counted launches."""
    import dataclasses
    import warnings

    import torch

    from idg_tpu_torch import cli
    from idg_tpu_torch.bench import V100_DEGRIDDER_REFERENCE_MVIS_S, V100_GRIDDER_REFERENCE_MVIS_S
    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import (initialize_subgrids, make_observation,
                                    make_perf_observation, make_w_observation)
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.api import _resolve, run_degridder, run_gridder
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda import build
    from idg_tpu_torch.ops.cuda.gridder_separable import plain_precisions
    from idg_tpu_torch.utils import roofline
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.costs import workload_costs

    t_start = time.perf_counter()
    # ptxas's lines of every instance (rung × N), and the HGMMA count of
    # each cuda_v4 and cuda_v5 instance: all twelve must be there, and v4
    # and v5 must run on the tensor cores' wgmma
    stem = re.compile(r"(degridder|gridder)_sep_v(\d)_kernelILi(\d+)E")
    lines = build.build_log.splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        found = stem.search(line)
        if "Compiling entry" in line and found:
            ptxas[found.groups()] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
    hgmma = {stem.search(name).groups(): count
             for name, count in sass_counts(str(build.build()), stem.pattern, "HGMMA").items()}
    for workload, version in SEPARABLE:
        for n in ("16", "32"):
            key = (workload, version[-1], n)
            phase("separable", f"ptxas {workload} {version} N = {n}: "
                               f"{ptxas.get(key, 'missing')}; {hgmma.get(key, 0)} HGMMA")
            if key not in ptxas or (version != "cuda_v3") != (hgmma.get(key, 0) > 0):
                raise RuntimeError(f"{workload} {version} N = {n}: instance missing, or "
                                   f"HGMMA where none belongs ({hgmma.get(key, 0)})")

    # against the f64 oracle on the correctness problem: w = 0, rank 4
    # (w_scale 1000), a ragged V (T = 37, C = 7), and cuda_v5 on non-uniform
    # wavenumbers, which must resolve to cuda_v4 and launch its kernel
    params = IDGParams.correctness_defaults()
    obs0, _ = make_observation(params)
    sub = initialize_subgrids(params.nr_subgrids, params.nr_correlations, params.subgrid_size)
    params_w, obs_w, _ = make_w_observation(params, w_scale=1000.0)
    params_r = dataclasses.replace(params, nr_timesteps_subgrid=37, nr_channels=7)
    obs_r, _ = make_observation(params_r)
    k = np.array(obs0.wavenumbers, copy=True)
    k[-1] *= 1.05
    obs_nu = dataclasses.replace(obs0, wavenumbers=k)
    checks = [(w, v, label, p, o, v) for w, v in SEPARABLE
              for label, p, o in (("w=0", params, obs0), ("rank 4 (w_scale 1000)", params_w, obs_w),
                                  ("ragged V = 37·7", params_r, obs_r))]
    checks += [(w, "cuda_v5", "non-uniform channels", params, obs_nu, "cuda_v4")
               for w in ("gridder", "degridder")]
    for workload, version, label, p, obs, resolves_to in checks:
        kernels.reset_launch_counts()
        sb = sub if p is not params_r else initialize_subgrids(
            p.nr_subgrids, p.nr_correlations, p.subgrid_size)
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            resolved = _resolve(workload, version, p, obs)
            if workload == "gridder":
                got, want = run_gridder(p, obs, version, device="cuda"), gridder_reference(p, obs)
            else:
                got = run_degridder(p, obs, sb, version, device="cuda")
                want = degridder_reference(p, obs, sb)
        torch.cuda.synchronize()
        launched = {name: n for name, n in launch_counts().items() if n}
        res = check_error(got, want, verbose=False)
        earlier = SEPARABLE_W0_ERRORS.get((workload, version)) if label == "w=0" else None
        ok = (res.passed and resolved[0] == resolves_to
              and launched == {f"{workload}_{resolves_to}": 1}
              and (resolved[1] or 2) >= (4 if "rank 4" in label else 2)
              and any("uniform channel" in str(w.message) for w in record) == (
                  resolves_to != version)
              and (earlier is None or res.mean_error <= 1.1 * earlier))
        vs = "" if earlier is None else f", {res.mean_error / earlier:.3f}x the earlier {earlier:.3e}"
        phase("separable", f"{workload} {version} {label}: resolved {resolved}, mean_error "
                           f"{res.mean_error:.3e} (gate {GATE:g}{vs}), launches {launched} "
                           f"{'PASSED' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"{workload} {version} {label} failed")

    # v3, v4 and v5 against their plain versions at every rank 1–6 on a
    # small w ≠ 0 problem, N = 16 and 32 (the kernels group the ranks)
    for n in (16, 32):
        p = IDGParams(grid_size=128, subgrid_size=n, nr_stations=3, nr_timeslots=2,
                      nr_timesteps_subgrid=16, nr_channels=7)
        p, obs, sb = make_w_observation(p, w_scale=1000.0, include_subgrids=True)
        stg_g, stg_c = stage(p, obs, "cuda"), stage(p, obs, "cpu")
        sb_c = torch.as_tensor(np.ascontiguousarray(sb))
        worst = 0.0
        for rank in range(1, 7):
            for workload, version in SEPARABLE:
                kernel = getattr(kernels, f"{workload}_{version}")
                if workload == "gridder":
                    got, want = kernel(p, stg_g, rank), kernel(p, stg_c, rank)
                else:
                    got, want = kernel(p, stg_g, sb_c.cuda(), rank), kernel(p, stg_c, sb_c, rank)
                torch.cuda.synchronize()
                err = check_error(got, want, verbose=False).mean_error
                worst = max(worst, err)
                if err > GATE:
                    raise RuntimeError(f"{workload} {version} N = {n} rank {rank} disagrees "
                                       f"with its plain version: {err:.3e}")
        phase("separable", f"v3, v4, v5 vs plain at every rank 1-6, N = {n}: worst mean_error "
                           f"{worst:.3e} (gate {GATE:g}) PASSED")

    # each kernel against its plain version on the first 512 default
    # subgrids, then both timed on the full problem (the plain version one
    # call); v4/v5 do their products on the tensor cores
    params = IDGParams.from_env()
    stg = stage(params, make_perf_observation(params), "cuda")
    sub_t = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
    small = slice_staged(stg, 0, COMPARE_SUBGRIDS)
    plain_once = HarnessConfig(nr_warm_up_runs=0, nr_iterations=1, nr_windows=1)
    sources = {"cuda_v3": "idg_tpu_torch/csrc/{}_sep_fp32.cu",
               "cuda_v4": "idg_tpu_torch/csrc/{}_sep_bf16.cu",
               "cuda_v5": "idg_tpu_torch/csrc/{}_sep_bf16.cu"}
    replaced = {"gridder": ({"cuda_v5": "idg_tpu/ops/pallas/gridder.py:708"},
                            "idg_tpu/ops/pallas/gridder.py:525"),
                "degridder": ({"cuda_v5": "idg_tpu/ops/pallas/degridder.py:559"},
                              "idg_tpu/ops/pallas/degridder.py:307")}
    cases = []
    for workload, version in SEPARABLE:
        kernel = getattr(kernels, f"{workload}_{version}")
        source = sources[version].format(workload)
        special, replaces = replaced[workload]
        rec = version == "cuda_v5"
        prec = plain_precisions(version, 2)
        if workload == "gridder":
            def plain(p, s, r, prec=prec, rec=rec):
                return kernels.gridder_separable_plain(p, s, r, prec, rec)
            small_args, full_args = (params, small, 2), (params, stg, 2)
        else:
            def plain(p, s, sb, r, prec=prec, rec=rec):
                return kernels.degridder_separable_plain(p, s, sb, r, prec, rec)
            small_args = (params, small, sub_t[:COMPARE_SUBGRIDS], 2)
            full_args = (params, stg, sub_t, 2)
        cases.append((f"{workload}_{version}", kernel, plain, small_args, full_args, source,
                      special.get(version, replaces)))
    kernels_vs_plain(rows, "separable", cases, timing, plain_once, model_flops(params),
                     unit=lambda name: roofline.unit(*name.split("_", 1)))
    del stg, small, sub_t
    torch.cuda.empty_cache()

    # the main path of this slice: perf mode for the six versions through
    # the CLI, counts set to 0 just before and read just after
    _, _, mvis = workload_costs(params)
    kernels.reset_launch_counts()
    seconds = {f"{w}_{v}": cli._perf_one(w, v) for w, v in SEPARABLE}
    counts = launch_counts()
    by_name = {row["name"]: row for row in rows}
    anchors = {"gridder": V100_GRIDDER_REFERENCE_MVIS_S,
               "degridder": V100_DEGRIDDER_REFERENCE_MVIS_S}
    for name, s in seconds.items():
        anchor = anchors[name.split("_")[0]]
        phase("perf", f"{name}: {s * 1e3:.3f} ms/pass, {mvis / s:.2f} MVis/s "
                      f"({mvis / s / anchor:.1f}x the V100 naive {anchor}), "
                      f"launches {counts[name]}")
        by_name[name]["launches"] = counts[name]
        if counts[name] == 0:
            raise RuntimeError(f"{name} was never launched on the main path")
    phase("separable", f"phase 10: {time.perf_counter() - t_start:.1f} s")


def polstack_phase(rows, timing):
    """Phase 11: the pol-stacked degridder cuda_v6 (K9d, tensor cores):
    ptxas lines of its instances; against the f64 oracle at w = 0, at rank
    4 and at C = 48, and on non-uniform wavenumbers resolving to cuda_v4,
    with counted launches; K9d against its plain version and timed; then
    perf mode with counted launches, and the bench with
    BENCH_DEGRIDDER_KERNEL=cuda_v6."""
    import dataclasses
    import subprocess
    import warnings

    import torch

    from idg_tpu_torch import cli
    from idg_tpu_torch.bench import V100_DEGRIDDER_REFERENCE_MVIS_S
    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import (initialize_subgrids, make_observation,
                                    make_perf_observation, make_w_observation)
    from idg_tpu_torch.models.reference import degridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.api import _resolve, run_degridder
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda import build
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.costs import workload_costs
    from idg_tpu_torch.utils.report import device_name
    from idg_tpu_torch.utils.roofline import roofline_fraction

    t_start = time.perf_counter()
    # ptxas's lines and the HGMMA count of both instances: each must be
    # there, on the bf16 tensor cores' wgmma, with no spill
    stem = re.compile(r"degridder_polstack_kernelILi(\d+)E")
    lines = build.build_log.splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        kernel = stem.search(line)
        if "Compiling entry" in line and kernel:
            ptxas[kernel.group(1)] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
    counts = {stem.search(name).group(1): count
              for name, count in sass_counts(str(build.build()), stem.pattern, "HGMMA").items()}
    for n in sorted(set(ptxas) | set(counts)):
        phase("polstack", f"degridder cuda_v6 N = {n}: {counts.get(n, 0)} HGMMA; ptxas "
                          f"{ptxas.get(n, 'missing')}")
    if (sorted(ptxas) != ["16", "32"] or sorted(counts) != ["16", "32"]
            or not all(counts.values())
            or any(" 0 bytes spill stores" not in line for line in ptxas.values())):
        raise RuntimeError(f"K9d's instances are not both on wgmma without a spill: {counts}")

    # against the f64 oracle on the correctness problem: w = 0, rank 4
    # (w_scale 1000), 48 channels (the recurrence resyncs at c = 16, 32),
    # each within K9D_ORACLE_SLACK× its error before the redesign, and
    # non-uniform wavenumbers, which must resolve to cuda_v4 and launch its
    # kernel once
    params = IDGParams.correctness_defaults()
    obs0, _ = make_observation(params)
    sub = initialize_subgrids(params.nr_subgrids, params.nr_correlations, params.subgrid_size)
    params_w, obs_w, _ = make_w_observation(params, w_scale=1000.0)
    params_c = dataclasses.replace(params, nr_channels=RESYNC_CHANNELS)
    obs_c, _ = make_observation(params_c)
    k = np.array(obs0.wavenumbers, copy=True)
    k[-1] *= 1.05
    obs_nu = dataclasses.replace(obs0, wavenumbers=k)
    for label, p, obs, resolves_to in (
            ("w=0", params, obs0, "cuda_v6"), ("rank 4 (w_scale 1000)", params_w, obs_w, "cuda_v6"),
            (f"C = {RESYNC_CHANNELS} (resync)", params_c, obs_c, "cuda_v6"),
            ("non-uniform channels", params, obs_nu, "cuda_v4")):
        kernels.reset_launch_counts()
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            resolved = _resolve("degridder", "cuda_v6", p, obs)
            got = run_degridder(p, obs, sub, "cuda_v6", device="cuda")
        torch.cuda.synchronize()
        launched = {name: n for name, n in launch_counts().items() if n}
        res = check_error(got, degridder_reference(p, obs, sub), verbose=False)
        bound = K9D_ORACLE_SLACK * K9D_ORACLE_ERRORS.get(label, GATE / K9D_ORACLE_SLACK)
        ok = (res.passed and res.mean_error <= bound and resolved[0] == resolves_to
              and launched == {f"degridder_{resolves_to}": 1}
              and (resolved[1] or 2) >= (4 if "rank 4" in label else 2)
              and any("uniform channel" in str(w.message) for w in record) == (
                  resolves_to != "cuda_v6"))
        phase("polstack", f"degridder cuda_v6 {label}: resolved {resolved}, mean_error "
                          f"{res.mean_error:.3e} (gate {bound:.3e}), launches {launched} "
                          f"{'PASSED' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"degridder cuda_v6 {label} failed")

    # K9d against its plain version at every rank 1–6 on a small w ≠ 0
    # problem, N = 16 and 32 (four ranks a group at N = 32: ranks 5 and 6
    # walk the tiles twice)
    for n in (16, 32):
        p = IDGParams(grid_size=128, subgrid_size=n, nr_stations=3, nr_timeslots=2,
                      nr_timesteps_subgrid=16, nr_channels=7)
        p, obs, sb = make_w_observation(p, w_scale=1000.0, include_subgrids=True)
        stg_g, stg_c = stage(p, obs, "cuda", with_vis=False), stage(p, obs, "cpu", with_vis=False)
        sb_c = torch.as_tensor(np.ascontiguousarray(sb))
        worst = 0.0
        for rank in range(1, 7):
            got = kernels.degridder_cuda_v6(p, stg_g, sb_c.cuda(), rank)
            torch.cuda.synchronize()
            err = check_error(got, kernels.degridder_cuda_v6(p, stg_c, sb_c, rank),
                              verbose=False).mean_error
            worst = max(worst, err)
            if err > GATE:
                raise RuntimeError(f"degridder cuda_v6 N = {n} rank {rank} disagrees with its "
                                   f"plain version: {err:.3e}")
        phase("polstack", f"degridder cuda_v6 vs plain at every rank 1-6, N = {n}: worst "
                          f"mean_error {worst:.3e} (gate {GATE:g}) PASSED")

    # K9d against its plain version on the first 512 default subgrids, then
    # both timed on the full problem (the plain version one call)
    params = IDGParams.from_env()
    stg = stage(params, make_perf_observation(params), "cuda", with_vis=False)
    sub_t = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
    small = slice_staged(stg, 0, COMPARE_SUBGRIDS)
    plain_once = HarnessConfig(nr_warm_up_runs=0, nr_iterations=1, nr_windows=1)
    case = ("degridder_cuda_v6", kernels.degridder_cuda_v6,
            lambda p, s, sb, r: kernels.degridder_polstack_plain(p, s, sb, r),
            (params, small, sub_t[:COMPARE_SUBGRIDS], 2), (params, stg, sub_t, 2),
            "idg_tpu_torch/csrc/degridder_polstack.cu", "idg_tpu/ops/pallas/degridder.py:821")
    kernels_vs_plain(rows, "polstack", [case], timing, plain_once, model_flops(params),
                     unit="bf16")
    del stg, small, sub_t
    torch.cuda.empty_cache()

    # the main path of this slice: perf mode through the CLI, counts set to
    # 0 just before and read just after
    gflops, gbytes, mvis = workload_costs(params)
    kernels.reset_launch_counts()
    seconds = cli._perf_one("degridder", "cuda_v6")
    launched = launch_counts()["degridder_cuda_v6"]
    share = roofline_fraction(gflops / seconds, gflops, gbytes, device_name(), "degridder",
                              "cuda_v6")
    phase("perf", f"degridder_cuda_v6: {seconds * 1e3:.3f} ms/pass, {mvis / seconds:.2f} MVis/s "
                  f"({mvis / seconds / V100_DEGRIDDER_REFERENCE_MVIS_S:.1f}x the V100 naive "
                  f"{V100_DEGRIDDER_REFERENCE_MVIS_S}), roofline_pct "
                  f"{'n/a' if share is None else f'{100 * share:.2f}'}, launches {launched}")
    next(row for row in rows if row["name"] == "degridder_cuda_v6")["launches"] = launched
    if launched == 0:
        raise RuntimeError("degridder_cuda_v6 was never launched on the main path")

    # the bench with the new rung, in its own process
    torch.cuda.empty_cache()
    env = dict(os.environ, BENCH_DEGRIDDER_KERNEL="cuda_v6", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "idg_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    phase("polstack", f"bench (BENCH_DEGRIDDER_KERNEL=cuda_v6), exit {out.returncode}: {last}")
    if out.returncode != 0 or json.loads(last or "{}").get(
            "degridder_metric") != "degridder_cuda_v6_throughput":
        raise RuntimeError(f"bench with cuda_v6 failed: {out.stderr[-2000:]}")
    phase("polstack", f"phase 11: {time.perf_counter() - t_start:.1f} s")


def sass_counts(library: str, pattern: str, opcode: str) -> dict:
    """{function: count of `opcode` instructions} over the functions of the
    built library whose mangled name matches `pattern`, from
    `cuobjdump --dump-sass` (beside nvcc in the toolkit)."""
    import subprocess

    from idg_tpu_torch.ops.cuda import build

    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-sass", library], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if re.search(pattern, name):
                counts[name] = 0
            else:
                name = None
        elif name is not None and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return counts


def redesign_phase(rows, timing):
    """Phase 12: the redesigned K1 (gridder cuda_v6, TF32 wgmma) and K10
    (vadd): ptxas lines and HGMMA counts of every K1 instance; K1, both
    forms, at N = 32 (the turned product) and N = 16, against the f64 oracle
    at w = 0, rank 4, C = 48, on non-uniform wavenumbers (no fallback) and
    on a ragged V, with counted launches (N = 16 at the check mode's gate,
    GATE), and against its plain version at every rank 1-6 on w != 0 data;
    K1 against its plain version on the
    first 512 default subgrids; K10 exactly
    against torch.add at n = 2^28 and at sizes off its chunk boundaries,
    aligned and misaligned; then both timed."""
    import dataclasses

    import torch

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import make_observation, make_perf_observation, make_w_observation
    from idg_tpu_torch.models.reference import gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops import grid as tgrid
    from idg_tpu_torch.ops import vadd as tvadd
    from idg_tpu_torch.ops.api import _resolve
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.utils.compare import check_error

    t_start = time.perf_counter()
    # every instance's registers and spills: N = 32 takes the turned product
    # (two consumer warpgroups, setmaxnreg in the tile loop), N = 16 the
    # transposed one
    instance_report("redesign", "K1", r"\d+gridder_kernel", flag_adds=True)

    # K1, both forms, against the f64 oracle on the correctness problem, at
    # N = 32 and N = 16
    problems = []
    for n_sub in (32, 16):
        params = IDGParams.correctness_defaults(subgrid_size=n_sub)
        obs0, _ = make_observation(params)
        params_w, obs_w, _ = make_w_observation(params, w_scale=1000.0)
        params_c = dataclasses.replace(params, nr_channels=RESYNC_CHANNELS)
        obs_c, _ = make_observation(params_c)
        k = np.array(obs0.wavenumbers, copy=True)
        k[-1] *= 1.05
        obs_nu = dataclasses.replace(obs0, wavenumbers=k)
        params_r = dataclasses.replace(params, nr_timesteps_subgrid=37, nr_channels=7)
        obs_r, _ = make_observation(params_r)
        problems += [(f"N = {n_sub} {label}", p, obs) for label, p, obs in (
            ("w=0", params, obs0), ("rank 4 (w_scale 1000)", params_w, obs_w),
            (f"C = {RESYNC_CHANNELS}", params_c, obs_c), ("non-uniform channels", params, obs_nu),
            ("ragged V = 37·7", params_r, obs_r))]
    for label, p, obs in problems:
        version, rank = _resolve("gridder", "cuda_v6", p, obs)
        rank = rank or 2
        md = obs.metadata
        oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, p.grid_size,
                                                 p.subgrid_size))
        stg = stage(p, obs, "cuda")
        kernels.reset_launch_counts()
        sub = kernels.gridder_cuda_v6(p, stg, rank)
        pieces = kernels.gridder_cuda_v6_pieces(p, stg, oyx.cuda(), rank)
        torch.cuda.synchronize()
        launched = {name: n for name, n in launch_counts().items() if n}
        oracle = torch.from_numpy(gridder_reference(p, obs))
        oracle_f = tgrid.pieces_from_subgrids(oracle, oyx)
        err = check_error(sub, oracle, verbose=False).mean_error
        err_f = check_error(pieces, oracle_f, verbose=False).mean_error
        # N = 16 at the check mode's gate: its float32 plain version itself
        # misses K1_ORACLE_GATE on this problem (printed beside)
        gate = K1_ORACLE_GATE if p.subgrid_size == 32 else GATE
        plain = ""
        if p.subgrid_size != 32:
            own = check_error(kernels.gridder_plain(p, stage(p, obs, "cpu"), rank), oracle,
                              verbose=False).mean_error
            plain = f", plain version (CPU) {own:.3e}"
        ok = (version == "cuda_v6" and max(err, err_f) <= gate
              and (rank >= 4) == ("rank 4" in label)
              and launched == {"gridder_cuda_v6": 1, "gridder_cuda_v6_pieces": 1})
        phase("redesign", f"K1 {label}: resolved ({version}, {rank}), mean_error {err:.3e}, "
                          f"fused {err_f:.3e} (gate {gate:g}{plain}), launches {launched} "
                          f"{'PASSED' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"K1 {label} failed")

    # K1, both forms, against its plain version at every rank 1-6 on the
    # correctness problem's w != 0 data, at N = 32 and N = 16
    for n_sub in (32, 16):
        p, obs, _ = make_w_observation(IDGParams.correctness_defaults(subgrid_size=n_sub),
                                       w_scale=1000.0)
        md = obs.metadata
        oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, p.grid_size, n_sub),
                              device="cuda")
        stg = stage(p, obs, "cuda")
        errs = []
        for rank in range(1, 7):
            errs.append(max(
                check_error(kernels.gridder_cuda_v6(p, stg, rank),
                            kernels.gridder_plain(p, stg, rank), verbose=False).mean_error,
                check_error(kernels.gridder_cuda_v6_pieces(p, stg, oyx, rank),
                            kernels.gridder_v6_pieces_plain(p, stg, oyx, rank),
                            verbose=False).mean_error))
        ok = max(errs) <= K1_PLAIN_GATE
        phase("redesign", f"K1 N = {n_sub} vs plain at ranks 1-6, both forms: mean_error "
                          + ", ".join(f"{e:.3e}" for e in errs)
                          + f" (gate {K1_PLAIN_GATE:g}) {'PASSED' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"K1 N = {n_sub} disagrees with its plain version at some rank")
        del stg

    # K1 against its plain version on the first 512 default subgrids, both
    # forms, then both timed on the full problem
    params = IDGParams.from_env()
    obs = make_perf_observation(params)
    md = obs.metadata
    stg = stage(params, obs, "cuda")
    oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size,
                                             params.subgrid_size), device="cuda")
    small = slice_staged(stg, 0, COMPARE_SUBGRIDS)
    for name, kernel, plain, small_args, full_args in (
            ("gridder_cuda_v6", kernels.gridder_cuda_v6, kernels.gridder_plain,
             (params, small, 2), (params, stg, 2)),
            ("gridder_cuda_v6_pieces", kernels.gridder_cuda_v6_pieces,
             kernels.gridder_v6_pieces_plain, (params, small, oyx[:COMPARE_SUBGRIDS], 2),
             (params, stg, oyx, 2))):
        got = kernel(*small_args)
        torch.cuda.synchronize()
        err = check_error(got, plain(*small_args), verbose=False).mean_error
        ms = device_ms(kernel, *full_args, harness=timing)
        phase("redesign", f"{name} vs plain on {COMPARE_SUBGRIDS} subgrids: mean_error "
                          f"{err:.3e} (gate {K1_PLAIN_GATE:g}); full problem {ms:.3f} ms "
                          f"{'PASSED' if err <= K1_PLAIN_GATE else 'FAILED'}")
        if err > K1_PLAIN_GATE:
            raise RuntimeError(f"{name} disagrees with its plain version")
    del stg, small
    torch.cuda.empty_cache()

    # K10 exactly against torch.add: n = 2^28, then sizes off every chunk
    # boundary (2048 floats a chunk), aligned and misaligned
    for n, offset in ((tvadd.DEFAULT_N, 0), (3, 0), (2048, 0), (2048 * 397 + 4, 0),
                      (2048 * 397 + 5, 0), (2048 * 397 + 5, 1), (tvadd.DEFAULT_N - 1, 2)):
        x, y = tvadd.make_vadd_inputs(n + offset, "cuda")
        x, y = x[offset:], y[offset:]
        compare(f"vadd_cuda vs torch.add (n = {n}, offset {offset})", kernels.vadd_cuda(x, y),
                torch.add(x, y), exact=True, tag="redesign")
        del x, y
    n = tvadd.DEFAULT_N
    x, y = tvadd.make_vadd_inputs(n, "cuda")
    k_ms = device_ms(kernels.vadd_cuda, x, y, harness=timing)
    lib_ms = device_ms(torch.add, x, y, harness=timing)
    phase("redesign", f"vadd_cuda (n = {n}): {k_ms:.3f} ms ({tvadd.vadd_gbytes(n) / k_ms:.3f} "
                      f"TB/s), torch.add {lib_ms:.3f} ms")
    del x, y
    torch.cuda.empty_cache()
    phase("redesign", f"phase 12: {time.perf_counter() - t_start:.1f} s")


def instance_report(tag: str, label: str, kernel: str, opcode: str = "HGMMA",
                    forms=("non-fused", "fused"), no_spill: bool = False,
                    flag_adds: bool = False, turned: int = 0) -> None:
    """Print ptxas's registers and spills and the cuobjdump count of `opcode`
    of each (N, flag) instance of `kernel` (a mangled name's stem, e.g.
    "16degridder_kernel"; the flag kFuse or kRecur, named by `forms`); raise
    unless all four are there and run on the tensor cores, with `no_spill`
    if one spills, and with `flag_adds` unless each flagged instance has
    more `opcode` instructions than its unflagged one (K3 on the tensor
    cores in the fused forms). K2's instances with a fourth flag, kTurned,
    set (the turned product at N = 32 up to rank 2) are `turned` more, held
    to the same and to no spill. The probed instances of K1 and K2 (a third
    flag, kProbe, set) are printed beside, and counted in none of these."""
    from idg_tpu_torch.ops.cuda import build

    stem = re.compile(rf"{kernel}ILi(\d+)ELb(\d)E(?:Lb0E(?:Lb(\d)E)?)?E")
    probed = re.compile(rf"{kernel}ILi(\d+)ELb1ELb1E(?:Lb(\d)E)?E")

    def key(found):
        return found.group(1), found.group(2), found.group(3) or "0"

    def name(key):
        return f"{label} N = {key[0]} {forms[int(key[1])]}{' turned' if key[2] == '1' else ''}"

    lines = build.build_log.splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        found = stem.search(line)
        if "Compiling entry" in line and found:
            ptxas[key(found)] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
        found = probed.search(line)
        if "Compiling entry" in line and found:
            phase(tag, f"{name((found.group(1), '1', found.group(2) or '0'))} probed: ptxas "
                       + " | ".join(x.strip() for x in lines[i + 2:i + 4]))
    counts = {key(stem.search(fn)): count
              for fn, count in sass_counts(str(build.build()), stem.pattern, opcode).items()}
    for k in sorted(set(ptxas) | set(counts)):
        phase(tag, f"{name(k)}: {counts.get(k, 0)} {opcode}; ptxas {ptxas.get(k, 'missing')}")
    want = 4 + turned
    if len(counts) != want or len(ptxas) != want or not all(counts.values()):
        raise RuntimeError(f"{label}'s instances do not all run on the tensor cores: {counts}")
    spills = [k for k, line in ptxas.items() if " 0 bytes spill stores" not in line]
    if (no_spill or turned) and [k for k in spills if no_spill or k[2] == "1"]:
        raise RuntimeError(f"{label}'s instances {spills} spill")
    if flag_adds and not all(counts[(n, "1", t)] > counts[(n, "0", t)] for n, _, t in counts):
        raise RuntimeError(f"{label}'s fused instances do not add {opcode}: {counts}")


def k2_phase(rows, timing):
    """Phase 13: the redesigned K2 (degridder cuda_v7, TF32 wgmma): ptxas
    lines and HGMMA counts of every instance, the turned ones (N = 32 up to
    rank 2) too; both forms (non-fused, fused) of both products (turned at
    N = 32 up to rank 2, the pol-stacked one elsewhere) against the f64
    oracle at w = 0, rank 4, C = 48, on non-uniform wavenumbers (no
    fallback) and on a ragged V, at N = 32 and N = 16 (N = 16 at the check
    mode's gate, GATE, as phase 12 holds K1), with counted launches; both
    forms against their plain versions on the first 512 default subgrids at
    ranks 1, 2 (turned) and 4, then timed at rank 2."""
    import dataclasses

    import torch

    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import (initialize_subgrids, make_observation,
                                    make_perf_observation, make_w_observation)
    from idg_tpu_torch.models.reference import degridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops import grid as tgrid
    from idg_tpu_torch.ops.api import _resolve
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.utils.compare import check_error

    def product(n, rank):
        return "turned" if n == 32 and rank <= 2 else "pol-stacked"

    t_start = time.perf_counter()
    instance_report("K2", "K2", r"\d+degridder_kernel", flag_adds=True, turned=2)

    # both forms against the f64 oracle on the correctness problem; the
    # fused form takes the subgrids' pieces (inverse DFT and roll), which
    # its prologue turns back
    problems = []
    for n_sub in (32, 16):
        params = IDGParams.correctness_defaults(subgrid_size=n_sub)
        obs0, _ = make_observation(params)
        params_w, obs_w, _ = make_w_observation(params, w_scale=1000.0)
        params_c = dataclasses.replace(params, nr_channels=RESYNC_CHANNELS)
        obs_c, _ = make_observation(params_c)
        k = np.array(obs0.wavenumbers, copy=True)
        k[-1] *= 1.05
        obs_nu = dataclasses.replace(obs0, wavenumbers=k)
        params_r = dataclasses.replace(params, nr_timesteps_subgrid=37, nr_channels=7)
        obs_r, _ = make_observation(params_r)
        problems += [(f"N = {n_sub} {label}", p, obs) for label, p, obs in (
            ("w=0", params, obs0), ("rank 4 (w_scale 1000)", params_w, obs_w),
            (f"C = {RESYNC_CHANNELS}", params_c, obs_c), ("non-uniform channels", params, obs_nu),
            ("ragged V = 37·7", params_r, obs_r))]
    for label, p, obs in problems:
        version, rank = _resolve("degridder", "cuda_v7", p, obs)
        rank = rank or 2
        md = obs.metadata
        oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, p.grid_size,
                                                 p.subgrid_size))
        sub = np.ascontiguousarray(initialize_subgrids(p.nr_subgrids, p.nr_correlations,
                                                       p.subgrid_size))
        pieces = tgrid.pieces_from_subgrids(torch.from_numpy(sub), oyx)
        stg = stage(p, obs, "cuda", with_vis=False)
        kernels.reset_launch_counts()
        got = kernels.degridder_cuda_v7(p, stg, torch.from_numpy(sub).cuda(), rank)
        got_f = kernels.degridder_cuda_v7(p, stg, pieces.cuda(), rank, fuse_oyx=oyx.cuda())
        torch.cuda.synchronize()
        launched = {name: n for name, n in launch_counts().items() if n}
        oracle = degridder_reference(p, obs, sub)
        err = check_error(got, oracle, verbose=False).mean_error
        err_f = check_error(got_f, oracle, verbose=False).mean_error
        # N = 16 at the check mode's gate, its float32 plain version's own
        # error printed beside (phase 12's rule for K1)
        gate = K2_ORACLE_GATE if p.subgrid_size == 32 else GATE
        plain = ""
        if p.subgrid_size != 32:
            own = check_error(kernels.degridder_plain(p, stage(p, obs, "cpu", with_vis=False),
                                                      torch.from_numpy(sub), rank),
                              oracle, verbose=False).mean_error
            plain = f", plain version (CPU) {own:.3e}"
        ok = (version == "cuda_v7" and max(err, err_f) <= gate
              and (rank >= 4) == ("rank 4" in label)
              and launched == {"degridder_cuda_v7": 2, "degridder_cuda_v7_fused": 1})
        phase("K2", f"K2 {label} ({product(p.subgrid_size, rank)}): resolved ({version}, "
                    f"{rank}), mean_error {err:.3e}, fused {err_f:.3e} (gate {gate:g}{plain}), "
                    f"launches {launched} {'PASSED' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"K2 {label} failed")

    # both forms against their plain versions on the first 512 default
    # subgrids at ranks 1 and 2 (turned) and 4 (pol-stacked), then timed at
    # rank 2
    params = IDGParams.from_env()
    obs = make_perf_observation(params)
    md = obs.metadata
    stg = stage(params, obs, "cuda", with_vis=False)
    sub = torch.as_tensor(np.ascontiguousarray(initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size)), device="cuda")
    oyx = torch.as_tensor(tgrid.roll_offsets(md.coord_x, md.coord_y, params.grid_size,
                                             params.subgrid_size), device="cuda")
    pieces = tgrid.pieces_from_subgrids(sub, oyx)
    n = COMPARE_SUBGRIDS
    small = slice_staged(stg, 0, n)
    for rank in (1, 2, 4):
        for name, kernel, plain, small_args, full_args in (
                ("degridder_cuda_v7", kernels.degridder_cuda_v7, kernels.degridder_plain,
                 (params, small, sub[:n], rank), (params, stg, sub, rank)),
                ("degridder_cuda_v7_fused",
                 lambda p, s, sb, r, o: kernels.degridder_cuda_v7(p, s, sb, r, fuse_oyx=o),
                 lambda p, s, sb, r, o: kernels.degridder_plain(p, s, tgrid._finish_extract(sb, o),
                                                                r),
                 (params, small, pieces[:n], rank, oyx[:n]), (params, stg, pieces, rank, oyx))):
            got = kernel(*small_args)
            torch.cuda.synchronize()
            err = check_error(got, plain(*small_args), verbose=False).mean_error
            timed = ""
            if rank == 2:
                timed = f"; full problem {device_ms(kernel, *full_args, harness=timing):.3f} ms"
            phase("K2", f"{name} rank {rank} ({product(params.subgrid_size, rank)}) vs plain on "
                        f"{n} subgrids: mean_error {err:.3e} (gate {K2_PLAIN_GATE:g}){timed} "
                        f"{'PASSED' if err <= K2_PLAIN_GATE else 'FAILED'}")
            if err > K2_PLAIN_GATE:
                raise RuntimeError(f"{name} disagrees with its plain version at rank {rank}")
    del stg, small, sub, pieces
    torch.cuda.empty_cache()
    phase("K2", f"phase 13: {time.perf_counter() - t_start:.1f} s")


def validate_module():
    """scripts/validate_cuda.py, imported as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("validate_cuda",
                                                  ROOT / "scripts" / "validate_cuda.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ladder_phase():
    """Phase 14: the compiler ladder on the card (against the oracle and
    its cuda_* neighbours, then perf mode at the full widths), the
    sustained window of K1 and K2 through `run --sustain`, and
    scripts/validate_cuda.py's sections."""
    import warnings
    from unittest import mock

    import torch

    from idg_tpu_torch import cli
    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import make_observation, make_w_observation
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.api import _resolve, run_degridder, run_gridder
    from idg_tpu_torch.utils import timing as ttiming
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.costs import workload_costs

    t_start = time.perf_counter()
    ladder = [(w, v) for w in ("gridder", "degridder") for v in LADDER_NEIGHBOURS]

    # each rung against the oracle and its cuda_* neighbour, at w = 0 and w != 0
    params = IDGParams.correctness_defaults()
    obs0, sub0 = make_observation(params, include_subgrids=True)
    params_w, obs_w, sub_w = make_w_observation(params, include_subgrids=True)
    kernels.reset_launch_counts()
    for label, p, obs, sub in (("w=0", params, obs0, sub0), ("w!=0", params_w, obs_w, sub_w)):
        oracle = {"gridder": gridder_reference(p, obs),
                  "degridder": degridder_reference(p, obs, sub)}

        def run(workload, version):
            if workload == "gridder":
                return run_gridder(p, obs, version, device="cuda")
            return run_degridder(p, obs, sub, version, device="cuda")

        for workload, version in ladder:
            neighbour = LADDER_NEIGHBOURS[version]
            with warnings.catch_warnings(record=True) as record:
                warnings.simplefilter("always")
                resolved = _resolve(workload, version, p, obs)
                got = run(workload, version)
                near = run(workload, neighbour)
            fell_back = [str(w.message) for w in record if "falling back" in str(w.message)]
            res = check_error(got, oracle[workload], verbose=False)
            apart = check_error(got, near, verbose=False)
            finite = bool(torch.isfinite(torch.view_as_real(got)).all())
            ok = (res.passed and apart.passed and finite and resolved[0] == version
                  and not fell_back)
            phase("ladder", f"{workload} {version} {label}: resolved {resolved}, mean_error "
                            f"{res.mean_error:.3e} (gate {GATE:g}); against {neighbour} "
                            f"{apart.mean_error:.3e} {'PASSED' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"{workload} {version} {label} failed")

    # perf mode at the full widths, two launches a rung; the ladder is PyTorch
    # and launches no hand-written kernel
    perf = IDGParams.from_env()
    _, _, mvis = workload_costs(perf)
    t_perf = time.perf_counter()
    one_window = {"NR_WARM_UP_RUNS": "0", "NR_ITERATIONS": "1", "NR_WINDOWS": "1"}
    with mock.patch.dict(os.environ, one_window):
        for workload, version in ladder:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            s = cli._perf_one(workload, version, params=perf)
            launched = {name: n for name, n in launch_counts().items() if n}
            phase("ladder", f"{workload}_{version}: {s * 1e3:.3f} ms/pass, {mvis / s:.2f} MVis/s "
                            f"({perf.nr_subgrids} subgrids; {time.perf_counter() - t0:.1f} s "
                            f"with staging); kernel launches {launched or 'none'}")
            if launched:
                raise RuntimeError(f"{workload} {version} launched hand-written kernels")
            torch.cuda.empty_cache()
    phase("ladder", f"perf of the ten rungs: {time.perf_counter() - t_perf:.1f} s")

    # run --sustain for K1 and K2: the launch count rises by the launches the
    # window reports and the 2 + NR_WARM_UP_RUNS before it
    windows = []
    sustained, timed = ttiming.time_kernel_sustained, ttiming.time_kernel

    def counted_sustained(fn, *args, **kw):
        before = sum(launch_counts().values())
        res = sustained(fn, *args, **kw)
        windows.append((res, sum(launch_counts().values()) - before))
        return res

    def noted_time(fn, *args, **kw):
        res = timed(fn, *args, **kw)
        windows.append(res)
        return res

    warm = HarnessConfig.from_env().nr_warm_up_runs
    for workload, version, name in (("gridder", "cuda_v6", "gridder_cuda_v6"),
                                    ("degridder", "cuda_v7", "degridder_cuda_v7")):
        windows.clear()
        kernels.reset_launch_counts()
        ttiming.time_kernel_sustained, ttiming.time_kernel = counted_sustained, noted_time
        try:
            rc = cli.main(["run", "--workload", workload, "--version", version,
                           "--sustain", str(SUSTAIN_S)])
        finally:
            ttiming.time_kernel_sustained, ttiming.time_kernel = sustained, timed
        (headline, (sus, counted)) = windows
        ok = (rc == 0 and counted == sus.launches + 2 + warm and sus.launches >= 10
              and launch_counts()[name] > counted)
        phase("sustain", f"{name}: sustained {sus.seconds * 1e3:.3f} ms/launch over "
                         f"{sus.launches} launches in {sus.window_seconds:.2f} s "
                         f"({len(sus.chunk_seconds)} chunks), min-of-windows "
                         f"{headline.seconds * 1e3:.3f} ms, drift {sus.drift_pct:+.2f}%; "
                         f"launch count {counted} in the window's call "
                         f"({sus.launches} + 2 + {warm} warm-ups) {'PASSED' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"run --sustain {workload} {version} failed")
        torch.cuda.empty_cache()

    # scripts/validate_cuda.py's sections
    val = validate_module()
    rows = (val.run_section(params, obs0, sub0, "cuda")
            + val.run_section(params_w, obs_w, sub_w, "cuda")
            + val.grid_stage_section("cuda") + val.fused_section("cuda"))
    for row in rows:
        phase("validate", row)
    bad = val.failed(rows)
    if bad:
        raise RuntimeError(f"{len(bad)} validation row(s) did not pass")
    phase("validate", f"{len(rows)} rows PASSED")
    torch.cuda.empty_cache()
    phase("ladder", f"phase 14: {time.perf_counter() - t_start:.1f} s")


def same_or_gated(name: str, got, want) -> None:
    """Hold two results of one path bit for bit; where they differ, print
    the max abs difference and hold them to the 1e-5 gate over max |want|
    (check_error's metric as a normalized RMS)."""
    import torch

    from idg_tpu_torch.utils.compare import check_error

    if torch.equal(got, want):
        phase("mesh", f"{name}: equal bit for bit PASSED")
        return
    scale = float(want.abs().max())
    res = check_error(got / scale, want / scale, verbose=False)
    phase("mesh", f"{name}: not bit for bit, max abs difference "
                  f"{float((got - want).abs().max()):.3e}, mean_error {res.mean_error:.3e} "
                  f"over max |want| {scale:.3e} (gate {GATE:g}) "
                  f"{'PASSED' if res.passed else 'FAILED'}")
    if not res.passed:
        raise RuntimeError(f"{name} disagrees past the gate")


def mesh_phase(rows, single):
    """Phase 15: the multi-device layer (idg_tpu_torch/parallel/) on the card.
    (a) at a world of one (NCCL), on the default problem: the staged rungs
    sharded_gridder_staged (cuda_v6) and sharded_degridder_staged (cuda_v7)
    against api.staged_runner unsharded; (b) the grid pipelines: the
    per-rank range recipe (K1's fused form into K4, then all_reduce) against
    `pipeline --direction grid`'s recipe, and the reduce_scatter +
    all_gather pair into K5 and K2 against the replicated path, with
    counted launches (K1, K2 and K4 launch, K6 never); each bit for bit (or
    within the 1e-5 gate, the difference printed); (c) `scaling
    --mesh-sizes 1` for the four workloads beside the single-device times
    of this run (`single`); (d) two gloo ranks on the one card:
    parallel/parity.py's replicated all-reduce pipeline under torchrun
    (parity only, no time)."""
    import subprocess

    import torch
    import torch.distributed as dist

    from idg_tpu_torch import cli
    from idg_tpu_torch.config import IDGParams
    from idg_tpu_torch.data import initialize_subgrids, make_perf_observation
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.api import _resolve, gridded_pipeline_parts, staged_runner
    from idg_tpu_torch.ops.grid import sort_observation_blocks
    from idg_tpu_torch.parallel import init_distributed, make_mesh
    from idg_tpu_torch.parallel import sharded as psh
    from idg_tpu_torch.utils.costs import workload_costs
    from idg_tpu_torch.utils.printing import nvidia_smi_power_line

    t_start = time.perf_counter()
    dev = init_distributed(device="cuda")
    mesh = make_mesh(1)
    phase("mesh", f"world {dist.get_world_size()}, backend {dist.get_backend()}, "
                  f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, device {dev}")
    params = IDGParams.from_env()
    g, n = params.grid_size, params.subgrid_size
    obs = make_perf_observation(params)
    subgrids = initialize_subgrids(params.nr_subgrids, params.nr_correlations, n)

    # (a) the staged rungs against the unsharded staged runner
    for workload, version in (("gridder", "cuda_v6"), ("degridder", "cuda_v7")):
        version, w_rank = _resolve(workload, version, params, obs)
        sub = subgrids if workload == "degridder" else None
        stg, sub_loc = psh.shard_staged_inputs(params, obs, mesh, workload, sub, dev)
        if workload == "gridder":
            got = psh.sharded_gridder_staged(params, mesh, version, w_rank)(stg)
        else:
            got = psh.sharded_degridder_staged(params, mesh, version, w_rank)(stg, sub_loc)
        del stg, sub_loc
        fn, args = staged_runner(workload, version, params, obs, sub, w_rank, dev)
        want = fn(*args)
        del fn, args
        same_or_gated(f"sharded_{workload}_staged ({version}) vs staged_runner", got, want)
        del got, want
        torch.cuda.empty_cache()
    t_a = phase_done("mesh (a)", t_start)

    # (b) the grid pipelines, counted launches
    version, w_rank = _resolve("gridder", "cuda_v6", params, obs)
    dversion, dw_rank = _resolve("degridder", "cuda_v7", params, obs)
    sorted_obs, _ = sort_observation_blocks(obs, g, n)
    pfn, pargs, gfn, _, _ = gridded_pipeline_parts(params, sorted_obs, version, w_rank,
                                                   device=dev)
    want = gfn(pfn(*pargs))
    del pfn, pargs, gfn
    local, _, plan = psh.shard_observation_block_sorted(params, obs, mesh, dev)
    kernels.reset_launch_counts()
    grid = psh.sharded_gridder_to_grid(params, mesh, version, w_rank=w_rank,
                                       grid_method="ranges")(local, plan)
    block = psh.sharded_gridder_to_grid(params, mesh, version, grid_sharded=True,
                                        w_rank=w_rank, grid_method="ranges")(local, plan)
    vis_gather = psh.sharded_grid_to_degridder_gather(params, mesh, dversion,
                                                      w_rank=dw_rank)(local, block)
    torch.cuda.synchronize()
    counts = launch_counts()
    vis_repl = psh.sharded_grid_to_degridder(params, mesh, dversion, w_rank=dw_rank)(local, grid)
    same_or_gated("sharded_gridder_to_grid(ranges) vs pipeline --direction grid", grid, want)
    same_or_gated("reduce_scatter row blocks vs the all-reduced grid", block, grid)
    same_or_gated("all_gather + K5 + K2 vs the replicated path", vis_gather, vis_repl)
    path = ("gridder_cuda_v6_pieces", "grid_add_cuda", "grid_extract_cuda", "degridder_cuda_v7")
    launched = {name: counts[name] for name in path}
    phase("mesh", f"launches of the sharded grid pipelines: {launched}, "
                  f"grid_add_pieces_cuda {counts['grid_add_pieces_cuda']}")
    if not all(launched.values()) or counts["grid_add_pieces_cuda"]:
        raise RuntimeError(f"the sharded grid pipelines took {counts}, not K1, K4, K5 and K2")
    by_name = {row["name"]: row for row in rows}
    for name, count in launched.items():
        by_name[name]["launches"] += count
    for name, fused in K3_FORMS:   # K3 launches with its fused form
        if name in by_name:
            by_name[name]["launches"] += counts[fused]
    del want, local, plan, grid, block, vis_gather, vis_repl, obs, subgrids, sorted_obs
    torch.cuda.empty_cache()
    t_b = phase_done("mesh (b)", t_a)

    # (c) scaling at mesh 1 beside the single-device times of this run
    smi = nvidia_smi_power_line()
    _, _, mvis = workload_costs(params)
    for workload, method in (("gridder", "scatter"), ("degridder", "scatter"),
                             ("pipeline", "ranges"), ("pipeline-degrid", "scatter")):
        ((_, s),) = cli._scaling(workload, mesh_sizes=[1], grid_method=method)
        phase("mesh", f"scaling {workload} (grid method {method}) mesh 1: {s * 1e3:.3f} ms/pass, "
                      f"{mvis / s:.2f} MVis/s; single-device {single[workload] * 1e3:.3f} ms "
                      f"({mvis / single[workload]:.2f} MVis/s), wrapper "
                      f"{(s - single[workload]) * 1e3:+.3f} ms [{smi}]")
        torch.cuda.empty_cache()
    t_c = phase_done("mesh (c)", t_b)

    # (d) two gloo ranks on the one card: the replicated all-reduce pipeline
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "idg_tpu_torch.parallel.parity", "--device", "cuda", "--backend", "gloo",
         "--checks", "replicated"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    for line in out.stdout.splitlines():
        if line.startswith("[parity"):
            phase("mesh", line)
    if out.returncode != 0 or out.stdout.count("all checks PASSED") != 2:
        raise RuntimeError(f"two gloo ranks on the card: exit {out.returncode}\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
    phase("mesh", "two gloo ranks on the card (replicated all-reduce pipeline): PASSED")
    phase_done("mesh (d)", t_c)
    dist.destroy_process_group()


def trace_counts(tools, path: str) -> dict:
    """{(__global__ name, fused or None): events} of a trace's kernels; the
    fused flag is the second template argument of K1's and K2's instances
    (the third, kProbe, is set in a traced window's fused launches)."""
    counts = {}
    for e in tools.load_events(path):
        if e.get("cat") != "kernel":
            continue
        base, targs = tools.kernel_base(e["name"])
        form = None
        if base in ("gridder_kernel", "degridder_kernel"):
            form = targs.split(",")[1].strip() in ("true", "(bool)1", "1")
        counts[(base, form)] = counts.get((base, form), 0) + 1
    return counts


def check_trace(tools, window: dict, label: str, strict: bool = True) -> dict:
    """Print one traced time_kernel call's tables from the reader and hold
    the trace to the launch counters and to the CUDA-event seconds of the
    same windows (`window`: its path, launches and TimingResult). Returns
    the reader's summary."""
    summary = tools.summarize(window["path"], top=8, gaps=3)
    timed = window["timing"].timed_windows
    passes = sum(n for n, _ in timed)
    stream = summary["streams"][0]
    span_ms = stream["span_ms"] / passes
    event_ms = sum(t for _, t in timed) * 1e3 / passes
    off = span_ms / event_ms - 1.0
    phase("trace", f"{label} [{os.path.basename(window['path'])}]: {passes} passes in "
                   f"{len(timed)} windows; device span {span_ms:.3f} ms a pass, CUDA events "
                   f"{event_ms:.3f} ms ({100 * off:+.2f}%); stream ({stream['device']}, "
                   f"{stream['stream']}) busy {stream['busy_ms'] / passes:.3f} ms a pass, "
                   f"idle {100 * stream['idle_share']:.2f}%")
    for r in summary["streams"][1:]:
        phase("trace", f"  stream ({r['device']}, {r['stream']}): busy "
                       f"{r['busy_ms'] / passes:.3f} ms a pass, {r['events']} events")
    for r in summary["ops"]:
        phase("trace", f"  {r['total_ms'] / passes:9.3f} ms a pass ×{r['count']:<6d} "
                       f"{100 * r['share']:5.1f}%  {tools.label(r['name'])[:90]}")
    for g in summary["gaps"]:
        host = f"{g['host_cat']} {g['host']}" if g["host"] else "(no host event)"
        phase("trace", f"  gap {g['ms']:.3f} ms: {host[:90]}")
    for r in summary["idle_by_host"][:5]:
        host = f"{r['host_cat']} {r['host']}" if r["host"] else "(no host event)"
        phase("trace", f"  idle {r['ms'] / passes:.3f} ms a pass in {r['gaps']} gaps: {host[:80]}")
    launched = {name: n for name, n in window["launches"].items() if n}
    if "degridder_cuda_v7" in launched:    # its count holds the fused launches too
        launched["degridder_cuda_v7"] -= launched.get("degridder_cuda_v7_fused", 0)
    seen = trace_counts(tools, window["path"])
    named = {base + {True: " (fused)", False: " (non-fused)"}.get(form, ""): n
             for (base, form), n in seen.items()}
    phase("trace", f"  launches in the windows {launched}; kernels in the trace {named}")
    for name, n in launched.items():
        if n and not seen.get(TRACE_KERNELS[name]):
            raise RuntimeError(f"{label}: {name} launched {n} times in the traced windows "
                               f"and is missing from the trace")
        if name in TRACE_EXACT and seen.get(TRACE_KERNELS[name]) != n:
            raise RuntimeError(f"{label}: {name} launched {n} times in the traced windows, "
                               f"the trace holds {seen.get(TRACE_KERNELS[name])}")
    if strict and abs(off) > TRACE_SPAN_SLACK:
        raise RuntimeError(f"{label}: the trace's device span a pass is {100 * off:+.2f}% from "
                           f"the CUDA-event seconds of the same windows")
    return summary


def trace_phase():
    """Phase 16: the trace hook (utils/timing.py:trace_window through
    IDG_PROFILE_DIR) and its reader (scripts/trace_tools_cuda.py) on the
    card: both default pipelines, the range pipeline at mesh 1 with one
    window, and a launch-bound ladder rung, each call of time_kernel traced
    and checked by `check_trace`. Returns the trace directory."""
    import contextlib
    import importlib.util

    import torch
    import torch.distributed as dist

    from idg_tpu_torch import cli
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.utils import timing as ttiming
    from idg_tpu_torch.utils.printing import nvidia_smi_power_line

    spec = importlib.util.spec_from_file_location(
        "trace_tools_cuda", ROOT / "scripts" / "trace_tools_cuda.py")
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    phase("trace", f"IDG_PROFILE_DIR={trace_dir} [{nvidia_smi_power_line()}]")
    windows = []
    traced, timed = ttiming.trace_window, ttiming.time_kernel

    @contextlib.contextmanager
    def counted_window(profile_dir, label="fn"):
        before = launch_counts()
        with traced(profile_dir, label) as path:
            yield path
        after = launch_counts()
        windows.append({"path": path, "launches": {k: after[k] - before[k] for k in after}})

    def noted_time(*args, **kwargs):
        res = timed(*args, **kwargs)
        windows[-1]["timing"] = res
        return res

    saved = {k: os.environ.get(k) for k in ("IDG_PROFILE_DIR", "NR_WINDOWS", "NR_ITERATIONS",
                                             "NR_WARM_UP_RUNS")}

    def restore(*keys):
        for key in keys:
            if saved[key] is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = saved[key]

    def run(label, call, env=None, strict=True):
        kernels.reset_launch_counts()
        windows.clear()
        os.environ.update(env or {})
        try:
            out = call()
        finally:
            restore(*(env or {}))
        for i, window in enumerate(windows):
            if window["path"] is None:
                raise RuntimeError(f"{label}: time_kernel call {i} wrote no trace")
            check_trace(tools, window, f"{label} call {i}", strict)
        if not windows:
            raise RuntimeError(f"{label}: no time_kernel call was traced")
        torch.cuda.empty_cache()
        return out

    os.environ["IDG_PROFILE_DIR"] = trace_dir
    ttiming.trace_window, ttiming.time_kernel = counted_window, noted_time
    try:
        for direction in ("grid", "degrid"):
            res = run(f"pipeline --direction {direction}",
                      lambda: cli._pipeline_one(direction, suffix="_traced"))
            phase("trace", f"pipeline --direction {direction}: {res.seconds * 1e3:.3f} ms/pass "
                           "traced (the profiler's cost included)")
            del res
        ((_, s),) = run("scaling --workload pipeline --grid-method ranges --mesh-sizes 1",
                        lambda: cli._scaling("pipeline", mesh_sizes=[1], grid_method="ranges"),
                        env={"NR_WINDOWS": "1"})
        phase("trace", f"scaling pipeline (ranges) mesh 1: {s * 1e3:.3f} ms/pass traced")
        if dist.is_initialized():
            dist.destroy_process_group()
        s = run("run --workload gridder --version torch_v1",
                lambda: cli._perf_one("gridder", "torch_v1", name_suffix="_traced"),
                env={"NR_WINDOWS": "1", "NR_ITERATIONS": "1", "NR_WARM_UP_RUNS": "0"},
                strict=False)
        phase("trace", f"gridder torch_v1: {s * 1e3:.3f} ms/pass traced (one pass)")
    finally:
        ttiming.trace_window, ttiming.time_kernel = traced, timed
        restore("IDG_PROFILE_DIR")
    return trace_dir


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "idg_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(idg_tpu_torch/ is not beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("OUTPUT_PATH", tempfile.mkdtemp(prefix="chip_smoke_"))

    from idg_tpu_torch import cli
    from idg_tpu_torch.config import HarnessConfig, IDGParams
    from idg_tpu_torch.data import (initialize_subgrids, make_observation,
                                    make_perf_observation, make_w_observation)
    from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
    from idg_tpu_torch.ops import cuda as kernels
    from idg_tpu_torch.ops.api import _resolve, run_degridder, run_gridder
    from idg_tpu_torch.ops.common import slice_staged, stage
    from idg_tpu_torch.ops.cuda import build
    from idg_tpu_torch.utils.compare import check_error
    from idg_tpu_torch.utils.costs import workload_costs
    from idg_tpu_torch.utils import roofline
    from idg_tpu_torch.utils.printing import nvidia_smi_power_line

    t_run = t_phase = time.perf_counter()
    # 1. device
    count = torch.cuda.device_count()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_power_line()
    phase("device", f"{kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}")
    if count != 1:
        raise RuntimeError(f"chip_smoke needs exactly one visible CUDA device, found {count}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    phase("build", f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(build.NVCC_FLAGS[:2])})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            phase("build", line.strip())
    t_phase = phase_done("phases 1-2", t_phase)

    # 3. check mode against the f64 oracle
    params_c = IDGParams.correctness_defaults()
    obs_c, _ = make_observation(params_c)
    for workload, version in (("gridder", "cuda_v6"), ("degridder", "cuda_v7")):
        rank = _resolve(workload, version, params_c, obs_c)[1] or 2
        res = cli._check_one(workload, version, "cuda")
        phase("check", f"{workload} {version} w=0: rank {rank}, mean_error "
                       f"{res.mean_error:.3e} (gate {GATE:g}) "
                       f"{'PASSED' if res.passed else 'FAILED'}")
        if not res.passed:
            raise RuntimeError(f"{workload} {version} failed the gate at w=0")
    params_w, obs_w, _ = make_w_observation(params_c, w_scale=1000.0)
    sub_w = initialize_subgrids(params_w.nr_subgrids, params_w.nr_correlations,
                                params_w.subgrid_size)
    for workload, version in (("gridder", "cuda_v6"), ("degridder", "cuda_v7")):
        _, rank = _resolve(workload, version, params_w, obs_w)
        if workload == "gridder":
            got = run_gridder(params_w, obs_w, version, device="cuda")
            golden = gridder_reference(params_w, obs_w)
        else:
            got = run_degridder(params_w, obs_w, sub_w, version, device="cuda")
            golden = degridder_reference(params_w, obs_w, sub_w)
        res = check_error(got, golden, verbose=False)
        phase("check", f"{workload} {version} w!=0 (w_scale 1000): rank {rank}, "
                       f"mean_error {res.mean_error:.3e} {'PASSED' if res.passed else 'FAILED'}")
        if not res.passed or rank is None or rank < 3:
            raise RuntimeError(f"{workload} {version} w!=0 check failed (rank {rank})")
    t_phase = phase_done("phase 3", t_phase)

    # 4. kernel against plain version on the card
    params = IDGParams.from_env()
    obs = make_perf_observation(params)
    subgrids = initialize_subgrids(params.nr_subgrids, params.nr_correlations,
                                   params.subgrid_size)
    stg = stage(params, obs, "cuda")
    sub_t = torch.as_tensor(np.ascontiguousarray(subgrids), device="cuda")
    del subgrids
    small = slice_staged(stg, 0, COMPARE_SUBGRIDS)
    timing = HarnessConfig(nr_warm_up_runs=1, nr_iterations=3, nr_windows=3)
    plain_timing = HarnessConfig(nr_warm_up_runs=1, nr_iterations=1, nr_windows=2)
    cases = (
        ("gridder_cuda_v6", kernels.gridder_cuda_v6, kernels.gridder_plain,
         (params, small, 2), (params, stg, 2),
         "idg_tpu_torch/csrc/gridder.cu", "idg_tpu/ops/pallas/gridder.py:794"),
        ("degridder_cuda_v7", kernels.degridder_cuda_v7, kernels.degridder_plain,
         (params, small, sub_t[:COMPARE_SUBGRIDS], 2), (params, stg, sub_t, 2),
         "idg_tpu_torch/csrc/degridder.cu", "idg_tpu/ops/pallas/degridder.py:901"),
    )
    rows = []
    kernels_vs_plain(rows, "compare", cases, timing, plain_timing, model_flops(params),
                     unit=lambda name: roofline.unit(*name.split("_", 1)))
    del stg, small, sub_t
    torch.cuda.empty_cache()
    t_phase = phase_done("phase 4", t_phase)

    # 5. the main path: perf mode through the CLI, counted launches
    _, _, mvis = workload_costs(params)
    kernels.reset_launch_counts()
    seconds = {
        "gridder_cuda_v6": cli._perf_one("gridder", "cuda_v6"),
        "degridder_cuda_v7": cli._perf_one("degridder", "cuda_v7"),
    }
    launches = {
        "gridder_cuda_v6": kernels.gridder_cuda_v6.launches,
        "degridder_cuda_v7": kernels.degridder_cuda_v7.launches,
    }
    for row in rows:
        name = row["name"]
        row["launches"] = launches[name]
        phase("perf", f"{name}: {seconds[name] * 1e3:.3f} ms/pass, "
                      f"{mvis / seconds[name]:.2f} MVis/s, launches {launches[name]}")
        if launches[name] == 0:
            raise RuntimeError(f"{name} was never launched on the main path")
    t_phase = phase_done("phase 5", t_phase)

    # 6. the grid stage, kernel against plain version on the card
    grid_stage_phase(rows, timing, plain_timing)
    t_phase = phase_done("phase 6", t_phase)

    # 7. the pipelines through the CLI, counted launches
    pipeline_seconds = pipeline_phase(rows)
    t_phase = phase_done("phase 7", t_phase)

    # 8. the grid-add kernels, the `grid` command and LOFAR-4096
    grid_add_phase(rows, timing, plain_timing)
    phase_done("phase 8", t_phase)

    # 9. the direct rungs, the w-free rungs, sweep and vadd
    direct_phase(rows, timing)

    # 10. the separable rungs: K8b, K8c, K9b, K9c
    separable_phase(rows, timing)

    # 11. the pol-stacked degridder: K9d
    polstack_phase(rows, timing)

    # 12. the redesigned kernels: K1 on the TF32 tensor cores, K10
    redesign_phase(rows, timing)

    # 13. the redesigned K2 on the TF32 tensor cores
    k2_phase(rows, timing)

    # 14. the compiler ladder, the sustained window of K1 and K2, the validation sweep
    ladder_phase()

    # 15. the multi-device layer at a world of one, and two gloo ranks on the card
    t_phase = time.perf_counter()
    mesh_phase(rows, {"gridder": seconds["gridder_cuda_v6"],
                      "degridder": seconds["degridder_cuda_v7"],
                      "pipeline": pipeline_seconds["grid"],
                      "pipeline-degrid": pipeline_seconds["degrid"]})
    phase_done("phase 15", t_phase)

    # 16. the trace hook and its reader on both pipelines, the mesh and the ladder
    t_phase = time.perf_counter()
    trace_phase()
    phase_done("phase 16", t_phase)
    phase_done("all phases", t_run)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
