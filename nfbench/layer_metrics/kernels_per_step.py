"""kernels_per_step: device kernel events in the traced slice over the
optimization steps run in it (the batch boundary's init and evaluation
kernels included)."""


def read(ctx):
    steps = ctx.counters.get("slice_steps")
    if ctx.trace is None or not steps:
        return None
    return len(ctx.trace.kernels) / steps
