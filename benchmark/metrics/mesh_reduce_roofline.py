"""mesh_reduce_roofline: the least time an all-reduce of the grid could
take over one card's NVLink, (n − 1)/n of the c64[P, G, G] grid each way at
450 GB/s (benchmark/mesh.py), as a share of the device time of rank 0's
span bench.reduce. No algorithm reads above 100%; a ring, which sends
2 (n − 1)/n of the grid each way, reads at most 50%. The collective's
device time holds its wait for the slowest rank. Where the trace ties no
device operation to the span, the NCCL all-reduce kernels' time is read by
name (ncclDevKernel_AllReduce*) over the span's instances."""

from benchmark import mesh

NCCL_ALL_REDUCE = "ncclDevKernel_AllReduce"


def read(ctx):
    seconds = ctx.span_seconds("bench.reduce")
    if seconds is None and ctx.trace:
        passes = ctx.trace["spans"].get("bench.reduce", (0.0, 0))[1]
        total = sum(r["total_s"] for r in ctx.trace["ops"]
                    if r["name"].startswith(NCCL_ALL_REDUCE))
        seconds = total / passes if passes and total > 0 else None
    n = mesh.ranks(ctx)
    if seconds is None or n < 2:
        return None
    return 100.0 * mesh.all_reduce_bytes(ctx.problem, n) / mesh.NVLINK_BYTES_PER_S / seconds
