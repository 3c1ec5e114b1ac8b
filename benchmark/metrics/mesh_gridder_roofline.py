"""mesh_gridder_roofline: rank 0's span bench.gridder (its K1 with the
fused iDFT on its own rows) against rank 0's share of the gridder's bound
(benchmark/mesh.py: costs.gridder_work in the share of the subgrids rank 0
holds), at the fixed peaks."""

from benchmark import costs, mesh


def read(ctx):
    seconds = ctx.span_seconds("bench.gridder")
    if seconds is None:
        return None
    return costs.roofline_pct(mesh.rank0_gridder_work(ctx), seconds)
