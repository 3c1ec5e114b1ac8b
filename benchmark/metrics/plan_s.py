"""plan_s: host seconds of the port's grid plans in set-up (the block sort,
ops/grid.py:sort_observation_blocks, and the range plan or the rolls)."""


def read(ctx):
    return ctx.plan_s
