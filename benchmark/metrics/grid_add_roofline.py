"""grid_add_roofline: the span bench.grid_add (the range grid-add, with the
grid's allocation and anything it zeroes) against its bound: pieces in,
the whole grid out, at the fixed bandwidth."""

from benchmark import costs


def read(ctx):
    seconds = ctx.span_seconds("bench.grid_add")
    if seconds is None:
        return None
    return costs.roofline_pct(costs.grid_add_work(ctx.problem), seconds)
