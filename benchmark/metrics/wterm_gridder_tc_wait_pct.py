"""wterm_gridder_tc_wait_pct: the share of the fused K1's tile loop that
its tensor-core warps (consumer warp 0) wait at the tile barriers for the
formation, 100 × Σtc_wait / Σloop over the traced window's probed launches
(csrc/gridder.cu, kProbe), in the w-term cell: above rank 3 at N = 32 the
block has one stage, and the formation no longer overlaps the products."""

from benchmark import port


def read(ctx):
    return port.probe_pct(port.GRIDDER_PROBE, "tc_wait", "loop")
