"""port_enqueue_ms: the host milliseconds of a pass inside the port's own
pass spans (idg.gridder and idg.grid_add, or idg.grid_extract and
idg.degridder): the sum of each span's median duration over the passes
that ran."""

from benchmark import port


def read(ctx):
    snap = port.snapshot()
    spans = (snap or {}).get("spans", {})
    medians = [spans[name]["median_s"] for name in port.PASS_SPANS if name in spans]
    return 1e3 * sum(medians) if medians else None
