"""wterm_gridder_form_wait_pct: the share of the fused K1's tile loop that
its first producer warp waits at the tile barriers for the products,
100 × Σform_wait / Σloop over the traced window's probed launches
(csrc/gridder.cu, kProbe): the other half of the overlap that one
shared-memory stage loses."""

from benchmark import port


def read(ctx):
    return port.probe_pct(port.GRIDDER_PROBE, "form_wait", "loop")
