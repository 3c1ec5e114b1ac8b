"""stage_s: host seconds of the port's guards and staging in set-up
(ops/api.py:_resolve, ops/common.py:stage), ending in a synchronize."""


def read(ctx):
    return ctx.stage_s
