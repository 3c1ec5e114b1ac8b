"""gridder_form_fast_pct: the share of the fused K1's producer-warp tile
formations whose phasors all took the straight-line path, none the exact
sincosf fallback, 100 × Σform_fast / Σform_tiles over the traced window's
probed launches (csrc/gridder.cu, kProbe). A program whose probes lack the
two counts gives None."""

from benchmark import port


def read(ctx):
    return port.probe_pct(port.GRIDDER_PROBE, "form_fast", "form_tiles")
