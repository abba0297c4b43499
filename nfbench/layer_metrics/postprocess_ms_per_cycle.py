"""postprocess_ms_per_cycle: the service's postprocessing of a cycle's
paths, timed by the benchmark's span around each call into the program's
`PathPostprocessor.process`, summed per window cycle, in ms."""


def read(ctx):
    c = ctx.counters
    if not c.get("cycles"):
        return None
    seconds, calls = ctx.spans.total("postprocess", since=c["window_t0"])
    return 1e3 * seconds / c["cycles"] if calls else None
