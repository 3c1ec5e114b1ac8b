"""port_stage_s: seconds in the port's own top-level `idg.stage.*` spans
(ops/api.py:_resolve, ops/common.py:stage), summed: host time, with no
closing synchronize, unlike `stage_s`."""

from benchmark import port


def read(ctx):
    return port.span_sum("idg.stage.", "top_s")
