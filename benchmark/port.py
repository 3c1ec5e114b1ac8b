"""What the port's own tracing recorded in this process
(idg_tpu_torch/utils/trace.py: span aggregates and the fused K1's and K2's
probe sums), for the readers metrics/port_*.py, metrics/*_k3_pct.py and
metrics/*_tc_wait_pct.py. A program without that module gives None, and
each of those metrics is then left out of the line."""

# the spans of the port's calls in a pass (utils/trace.py), one level each
PASS_SPANS = ("idg.gridder", "idg.grid_add", "idg.grid_extract", "idg.degridder")
# the probe accumulators of the fused K1 and K2, by their wrappers
GRIDDER_PROBE = "gridder_cuda_v6_pieces"
DEGRIDDER_PROBE = "degridder_cuda_v7_fused"


def snapshot():
    """idg_tpu_torch.utils.trace.snapshot(), or None without it."""
    try:
        from idg_tpu_torch.utils import trace
    except ImportError:
        return None
    read = getattr(trace, "snapshot", None)
    return read() if callable(read) else None


def span_sum(prefix: str, field: str):
    """Σ `field` of the aggregates of the span names that start with
    `prefix`, or None when no such span ran."""
    snap = snapshot()
    rows = [agg for name, agg in (snap or {}).get("spans", {}).items()
            if name.startswith(prefix)]
    return sum(agg[field] for agg in rows) if rows else None


def probe_pct(kernel: str, part: str, whole: str):
    """100 × Σ `part` / Σ `whole` of `kernel`'s probe sums, or None when it
    ran no probed launch."""
    snap = snapshot()
    sums = (snap or {}).get("probes", {}).get(kernel)
    if not sums or not sums.get(whole):
        return None
    return 100.0 * sums[part] / sums[whole]
