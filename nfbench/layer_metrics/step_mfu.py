"""step_mfu: the whole step's share of the card's f32 peak over the traced
slice: the frozen operations of one step (`field_work.step_flops`) times the
steps run in the slice, over the slice's wall time, in %. The slice holds a
batch boundary (evaluation and init), which counts as time without steps."""
from nfbench.counts import field_work


def read(ctx):
    steps = ctx.counters.get("slice_steps")
    if ctx.trace is None or not ctx.card or not steps:
        return None
    solver = ctx.cell.config["solver"]
    ops = field_work.step_flops(solver, ctx.counters["problems"]) * steps
    peak = field_work.card_peaks(ctx.card)["f32"]
    return 100.0 * ops / (ctx.trace.window_s * peak)
