"""A kernel's share of its roofline in a traced slice: the least time the
card could take for the function it computes, at the cell's shapes (the
frozen counts of `nfbench/counts/field_work.py`, against the published
peaks of the card), over its mean device time per launch."""
from __future__ import annotations

import json
import pathlib

from nfbench.counts import field_work


def share(ctx, spec_file: pathlib.Path) -> float | None:
    """The roofline share, in %, of the kernels named in `spec_file`
    ({"patterns": [...], "function": ..., "precision": ...}); None where the
    slice holds none of them."""
    if ctx.trace is None:
        return None
    spec = json.loads(spec_file.read_text())
    seconds, launches = ctx.trace.kernel_time(spec["patterns"])
    if not launches:
        return None
    solver = ctx.cell.config["solver"]
    m = field_work.step_points(solver)[spec["function"]]
    peaks = field_work.card_peaks(ctx.card)
    bound = field_work.bound_s(spec["function"], solver["onf"], ctx.counters["problems"], m,
                               peaks, spec["precision"])
    return 100.0 * bound / (seconds / launches)
