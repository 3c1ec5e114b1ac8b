"""degridder_roofline: the span bench.degridder (the degridder with its
fused DFT) against its bound: the reference's operation model plus the
DFT, pieces and the observation in, visibilities out, at the fixed
peaks."""

from benchmark import costs


def read(ctx):
    seconds = ctx.span_seconds("bench.degridder")
    if seconds is None:
        return None
    return costs.roofline_pct(costs.degridder_work(ctx.problem), seconds)
