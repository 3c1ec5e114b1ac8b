"""gridder_k3_pct: the share of the fused K1's block cycles spent in K3
(from the barrier before its inverse-DFT products to the end of their
stores), 100 × Σk3 / Σtotal over the traced window's probed launches
(csrc/gridder.cu, kProbe)."""

from benchmark import port


def read(ctx):
    return port.probe_pct(port.GRIDDER_PROBE, "k3", "total")
