"""pass_mfu: the whole pass's operations (its recipe's `pass_flops`: the
gridder's or degridder's model plus the subgrid (i)DFT) over the device
seconds of all its spans, as a share of the fixed peak rate. It bounds the
kernels' shares when a later change removes or merges a span."""

from benchmark import costs


def read(ctx):
    spans = [ctx.span_seconds(name) for name in ctx.span_names]
    if any(s is None for s in spans):
        return None
    return costs.flops_pct_of_peak(ctx.pass_flops, sum(spans))
