"""enqueue_ms: mean host milliseconds a pass spends inside the port's pass
call (the wrappers and the grid dispatch enqueue the launches; any wait
for the card inside the call counts too)."""


def read(ctx):
    if not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
