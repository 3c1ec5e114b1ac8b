"""wterm_gridder_roofline: metrics/gridder_roofline.py's reading in the
w-term cell: the span bench.gridder against costs.gridder_work, which
counts the same work whatever Taylor rank implements it, so each rank
above the default shows as a lower share."""

from benchmark import catalog


def read(ctx):
    return catalog.load_reader("gridder_roofline")(ctx)
