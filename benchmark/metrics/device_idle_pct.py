"""device_idle_pct: 1 − busy/span of the pass stream over the traced
window, in percent (the union of its device intervals against the time
from its first operation's start to its last one's end)."""


def read(ctx):
    if not ctx.trace:
        return None
    return 100.0 * ctx.trace["stream"]["idle_share"]
