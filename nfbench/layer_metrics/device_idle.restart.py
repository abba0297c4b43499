"""device_idle.restart: the share (%) of the traced slice's wall in which
no kernel ran and the host was inside the suite runner's restart round (a
`suite.restart` span of the program, placed on the trace's clock by the
offsets `program_spans` finds). The slice ends inside that span, so a span
still open when the slice ended runs to the slice's end. None where the
program records no `suite.restart` span or the clocks do not align."""
from nfbench.harness import program_spans

SPAN = "suite.restart"


def read(ctx):
    records = ctx.counters.get("slice_records") or []
    spans = [r for r in records if r.name == SPAN]
    if ctx.trace is None or not spans:
        return None
    offsets = program_spans.offsets_us(ctx.trace.spans, ctx.spans.records, records)
    if offsets is None:
        return None
    t = ctx.trace
    idle = 0.0
    for r in spans:
        lo = max(t.start_us, r.start_ns / 1e3 + offsets[0])
        hi = t.end_us if r.end_ns is None else min(t.end_us, r.end_ns / 1e3 + offsets[1])
        busy = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in t.intervals())
        idle += max(0.0, hi - lo - busy)
    return 100.0 * idle / (t.end_us - t.start_us)
