"""grid_extract_roofline: the span bench.grid_extract (the range
extraction) against its bound: the grid pixels inside the union of the
subgrid windows in, pieces out, at the fixed bandwidth."""

from benchmark import costs


def read(ctx):
    seconds = ctx.span_seconds("bench.grid_extract")
    if seconds is None:
        return None
    p = ctx.problem
    union = costs.window_union_pixels(ctx.metadata["coord_x"], ctx.metadata["coord_y"],
                                      p.grid_size, p.subgrid_size)
    return costs.roofline_pct(costs.grid_extract_work(p, union), seconds)
