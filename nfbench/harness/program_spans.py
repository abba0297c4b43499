"""The program's own spans in a traced slice, on the trace's clock.

The port records a span at each boundary of its run loop while a
torch.profiler profile is active (`nfopp_tpu_torch.utils.profiling.span`:
`run` and its children `sync`, `program`, `capture`, `replay`,
`run.outputs`; `init`, `pretrain`, `evaluate`), each with its parent and its
start and end on `time.perf_counter_ns()`. `profiling.spans()` returns them;
they are the slice's, since nothing records outside a profile.

Alignment. The trace's events are on the profiler's clock, the program's
records on the host's `perf_counter`. The benchmark's own spans (`init`,
`chunk`, `evaluate`, `core.Spans`) are on both: `ctx.spans.records` holds
their `time.perf_counter()` times, the same clock as the program's records,
and `ctx.trace.spans` the profiler ranges of those in the slice. The
slice's spans are matched, in order and by name, to a run of as many
consecutive host records that holds every program record between its first
start and its last end (the program records only inside the slice, so this
picks the slice's batches among batches whose spans look alike). Each
start gives the difference of the two clocks at a range's opening, each end
at its closing: both sides read the host's clock before a range opens and
after it closes, so the two differ by the cost of opening and closing a
profiler range, and each kind of edge gets its own offset, the median of
its differences. The match whose median residual is least is taken; one
whose median residual passes `MAX_RESIDUAL_US` is refused, and no program
span is placed then. A program record then lies at `start_ns / 1e3 +
start offset` to `end_ns / 1e3 + end offset` us on the trace's clock.

Every function returns None where the run was not traced, no program span
was recorded (a program without spans), or the clocks do not align.
"""
from __future__ import annotations

import statistics

MAX_RESIDUAL_US = 50.0
RUN_LOOP = "run"  # the root of the run loop's spans


def program_records() -> list:
    """The program's recorded spans (`SpanRecord`s); [] where the program
    records none or has no span recorder."""
    try:
        from nfopp_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def offsets_us(trace_spans: list, host_records: list, records: list) -> tuple | None:
    """(start offset, end offset), trace us minus host us at a range's
    opening and at its closing: the slice's benchmark spans `trace_spans`
    (name, ts us, dur us) against the benchmark's `host_records` (name, t0
    s, t1 s) around the program's `records`; None where they do not match
    within MAX_RESIDUAL_US."""
    traced = sorted(trace_spans, key=lambda s: s[1])
    host = sorted(host_records, key=lambda r: r[1])
    names = [s[0] for s in traced]
    first = min((r.start_ns for r in records), default=None)
    last = max((r.end_ns for r in records if r.end_ns is not None), default=None)
    best = None
    for k in range(len(host) - len(traced) + 1 if traced and last is not None else 0):
        run = host[k:k + len(traced)]
        if ([r[0] for r in run] != names or run[0][1] * 1e9 > first
                or run[-1][2] * 1e9 < last):
            continue
        starts = [ts - t0 * 1e6 for (_, ts, _), (_, t0, _) in zip(traced, run)]
        ends = [ts + dur - t1 * 1e6 for (_, ts, dur), (_, _, t1) in zip(traced, run)]
        offsets = (statistics.median(starts), statistics.median(ends))
        residual = statistics.median([abs(d - offsets[0]) for d in starts]
                                     + [abs(d - offsets[1]) for d in ends])
        if best is None or residual < best[0]:
            best = (residual, offsets)
    if best is None or best[0] > MAX_RESIDUAL_US:
        return None
    return best[1]


def slice_spans(ctx, records: list | None = None) -> list | None:
    """The program's closed spans that start in the traced slice, as
    (id, name, parent, start us, end us) on the trace's clock, in order of
    start."""
    if ctx.trace is None:
        return None
    records = program_records() if records is None else records
    if not records:
        return None
    offsets = offsets_us(ctx.trace.spans, ctx.spans.records, records)
    if offsets is None:
        return None
    placed = [(r.id, r.name, r.parent, r.start_ns / 1e3 + offsets[0],
               max(r.start_ns / 1e3 + offsets[0], r.end_ns / 1e3 + offsets[1]))
              for r in records if r.end_ns is not None]
    return sorted((p for p in placed if ctx.trace.start_us <= p[3] < ctx.trace.end_us),
                  key=lambda p: p[3])


def per_step(ctx, name: str, records: list | None = None) -> float | None:
    """Spans named `name` in the slice over the optimization steps run in it."""
    steps = ctx.counters.get("slice_steps")
    placed = slice_spans(ctx, records)
    if placed is None or not steps:
        return None
    return sum(p[1] == name for p in placed) / steps


def _idle_gaps(ctx, placed: list) -> list:
    """The slice's idle gaps, each cut where a program span opens or closes:
    [(lo, hi, [(a, b, spans open over [a, b))])] in trace us."""
    t = ctx.trace
    edges = [t.start_us] + [x for iv in t.intervals() for x in iv] + [t.end_us]
    cuts = sorted({t.start_us, t.end_us} | {x for p in placed for x in p[3:5]
                                             if t.start_us < x < t.end_us})
    # the host's state is constant between two cuts
    host = [(a, b, [p for p in placed if p[3] <= a and p[4] >= b])
            for a, b in zip(cuts, cuts[1:])]
    gaps, i = [], 0
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi <= lo:
            continue
        while host[i][1] <= lo:
            i += 1
        pieces, j = [], i
        while j < len(host) and host[j][0] < hi:
            a, b, open_ = host[j]
            pieces.append((max(a, lo), min(b, hi), open_))
            j += 1
        gaps.append((lo, hi, pieces))
    return gaps


def idle_split(ctx, records: list | None = None) -> dict | None:
    """The slice's idle share (% of its wall) by the outermost program span
    open on the host: "run_loop" under `run` and its children, the root
    span's own name elsewhere (`init`, `evaluate`), "off_program" where no
    program span was open. The parts add up to `device_idle.solve`."""
    placed = slice_spans(ctx, records)
    if placed is None:
        return None
    wall = ctx.trace.end_us - ctx.trace.start_us
    split = {"run_loop": 0.0, "off_program": 0.0}
    for _, _, pieces in _idle_gaps(ctx, placed):
        for a, b, open_ in pieces:
            if not open_:
                key = "off_program"
            else:
                root = min(open_, key=lambda p: (p[3], -p[4]))[1]
                key = "run_loop" if root == RUN_LOOP else root
            split[key] = split.get(key, 0.0) + 100.0 * (b - a) / wall
    return split


def idle_gaps(ctx, count: int = 10, records: list | None = None) -> list | None:
    """The slice's longest idle gaps, longest first, as [the innermost
    program span for most of the gap ("outside" where none), seconds, its
    start in us from the slice's start]."""
    placed = slice_spans(ctx, records)
    if placed is None:
        return None
    named = []
    for lo, hi, pieces in _idle_gaps(ctx, placed):
        time_in: dict = {}
        for a, b, open_ in pieces:
            name = max(open_, key=lambda p: (p[3], -p[4]))[1] if open_ else "outside"
            time_in[name] = time_in.get(name, 0.0) + b - a
        named.append([max(time_in, key=time_in.get), (hi - lo) / 1e6, lo - ctx.trace.start_us])
    return sorted(named, key=lambda g: -g[1])[:count]
