"""degridder_k3_pct: the share of the fused K2's block cycles spent in K3
(the prologue's copy, un-roll, split and forward DFT of the pieces),
100 × Σk3 / Σtotal over the traced window's probed launches
(csrc/degridder.cu, kProbe)."""

from benchmark import port


def read(ctx):
    return port.probe_pct(port.DEGRIDDER_PROBE, "k3", "total")
