"""wterm_gridder_rank_ms: the span bench.gridder's device ms a pass over
the Taylor rank its K1 launches ran, read from the port's tally
idg.w_rank.gridder ({rank: launches}, idg_tpu_torch/utils/trace.py): the
cost of one Taylor term. None without the span or the tally, or where the
launches ran more than one rank."""

from benchmark import port

TALLY = "idg.w_rank.gridder"


def read(ctx):
    seconds = ctx.span_seconds("bench.gridder")
    snap = port.snapshot()
    ranks = ((snap or {}).get("w_term") or {}).get(TALLY) or {}
    if seconds is None or len(ranks) != 1:
        return None
    (rank,) = ranks
    return 1e3 * seconds / int(rank)
