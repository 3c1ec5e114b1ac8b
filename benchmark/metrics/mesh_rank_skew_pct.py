"""mesh_rank_skew_pct: 100 × (the slowest rank's median local pass ÷ the
fastest rank's − 1), from the port's counter idg.mesh.local_pass (each
rank's K1 and K4 of a pass, CUDA events, gathered to rank 0 by its
snapshot, idg_tpu_torch/utils/trace.py): the straggler every card's
all-reduce waits for. None without the counter."""

from benchmark import port

COUNTER = "idg.mesh.local_pass"


def read(ctx):
    snap = port.snapshot()
    ranks = ((snap or {}).get("counters", {}).get(COUNTER) or {}).get("ranks")
    if not ranks or any(m is None or m <= 0 for m in ranks):
        return None
    return 100.0 * (max(ranks) / min(ranks) - 1.0)
