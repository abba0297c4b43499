"""The device's idle share of a traced slice: 1 - busy / wall, in %."""


def share(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
