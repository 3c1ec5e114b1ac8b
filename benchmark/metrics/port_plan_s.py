"""port_plan_s: seconds in the port's own `idg.plan.*` spans (ops/grid.py:
sort_observation_blocks, plan_grid_add_ranges, roll_offsets), summed; they
run in set-up only. Host time of the calls, as `plan_s` reads it from
outside."""

from benchmark import port


def read(ctx):
    return port.span_sum("idg.plan.", "total_s")
