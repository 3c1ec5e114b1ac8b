"""gridder_roofline: the span bench.gridder (the gridder with its fused
iDFT) against its bound: the reference's operation model plus the iDFT,
visibilities and the observation in, pieces out, at the fixed peaks."""

from benchmark import costs


def read(ctx):
    seconds = ctx.span_seconds("bench.gridder")
    if seconds is None:
        return None
    return costs.roofline_pct(costs.gridder_work(ctx.problem), seconds)
