"""Profiling helpers: torch.profiler traces, the program's spans, and timing
of whole calls (port of `nfopp_tpu/utils/profiling.py`, which uses
jax.profiler and block_until_ready).

A host-side tick/tock around asynchronous launches measures only their
dispatch. These helpers synchronise the card before every clock read:
`trace` writes a Chrome trace of the enclosed block (open it in
chrome://tracing or Perfetto), `timed_call` gives the median seconds per
call, each call finished on every card its result lives on.

Spans. `span(name, **attrs)` marks a part of the program's run loop (see
the table below). It records only while a torch.profiler profile is active
(any profile: `trace`, `tools/profile_step.py`, a caller's own); otherwise
it costs one check of the profiler's state and allocates nothing. While
recording, a span keeps a `SpanRecord` in memory (name, the enclosing open
span as its parent, start and end on `time.perf_counter_ns()`, its attrs;
at most `SPAN_CAP` records, later spans are not kept) and opens the
profiler range `nfopp_tpu_torch.<name>`, so the exported Chrome trace
carries the span on the device trace's own clock. `spans()` returns a copy
of the records, `clear_spans()` empties them.

    span             where                                what it separates
    run              _FieldSolver.run, run_grouped,       one call (steps, batch, schedule)
                     run_batch
    sync             parallel/mesh.py::                   the host waiting on the card
                     count_over_problems
    program          _FieldSolver._program                key building and store lookup
    capture          utils/aot.py::aot_or_compile         a program's warm-up and capture
    replay           _run_program, each program call      copy-in, generator state, launch
    run.outputs      the end of _run_program              the output state's clone
    init             init_state                           the batch boundary
    pretrain         init_state, around _pretrain_field   the field's pretraining
    evaluate         solver/tracking.py::evaluate_path    the batch boundary
    suite            bench/runner.py::run_grid_suite      one call (batch, aot)
    suite.wavefront  run_grid_suite                       the wavefront initial paths
    suite.init       run_grid_suite                       the base batch's init_state
    suite.solve      run_grid_suite                       the base batch's tracked solve
    suite.shortcut   run_grid_suite                       the base batch's shortcut pass
    suite.restart    run_grid_suite                       a restart round: its selection,
                                                          init, tracked solve and shortcut
                                                          (lanes)
    suite.evaluate   run_grid_suite                       PathStatistics and the results log

A gap in the device's work is read by the program range the host was in:
under `sync` the host waited for earlier work and then had nothing queued;
under `program`, `replay` or `run.outputs` the card waited on that host
step; outside every range, on the caller.
"""
from __future__ import annotations

import contextlib
import itertools
import pathlib
import threading
import time
from typing import Any, Callable, NamedTuple

import torch

from .tree import tree_leaves

__all__ = ["SPAN_CAP", "SpanRecord", "clear_spans", "span", "spans", "steps_per_second",
           "timed_call", "trace"]

SPAN_CAP = 65536  # span records kept in memory; a span past it still opens its range
_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()
_RECORDS: list = []  # the recorded spans (`_Span`), in the order they opened
_IDS = itertools.count()
_OPEN = threading.local()  # each thread's stack of open spans


class SpanRecord(NamedTuple):
    """One recorded span: `parent` is the id of the span open around it in
    its thread (None at the top); times are `time.perf_counter_ns()`, and
    `end_ns` is None while the span is open."""

    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int | None
    attrs: dict


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.end_ns = name, attrs, None

    def __enter__(self) -> "_Span":
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else None
        self.id = next(_IDS)
        if len(_RECORDS) < SPAN_CAP:
            _RECORDS.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        self._range = torch.profiler.record_function(f"nfopp_tpu_torch.{self.name}")
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        self.end_ns = time.perf_counter_ns()
        _OPEN.stack.pop()


def span(name: str, **attrs):
    """A context manager marking a part of the program (see the module):
    recorded while a torch.profiler profile is active, a no-op otherwise.
    Entered, it gives the recording span, whose `attrs` the caller may add
    to, or None when nothing records."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _Span(name, attrs)


def spans() -> list:
    """A copy of the recorded spans (`SpanRecord`), in the order they opened."""
    return [SpanRecord(s.id, s.name, s.parent, s.start_ns, s.end_ns, dict(s.attrs))
            for s in list(_RECORDS)]


def clear_spans() -> None:
    """Forget every recorded span."""
    _RECORDS.clear()


def _cuda_devices(result) -> set:
    return {leaf.device for leaf in tree_leaves(result) if leaf.device.type == "cuda"}


def _synchronize(result) -> None:
    for device in _cuda_devices(result):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str = "nfopp_profile"):
    """Capture a torch.profiler trace (CPU, and CUDA where a card is present)
    of the enclosed block into `log_dir`/trace.json; yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def timed_call(fn: Callable, *args, warmup: int = 1, iters: int = 5) -> tuple[float, Any]:
    """(median seconds per call, last result), every call finished on the
    device before its time is read."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
        _synchronize(result)
    times = []
    for _ in range(iters):
        _synchronize(result)
        t0 = time.perf_counter()
        result = fn(*args)
        _synchronize(result)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], result


def steps_per_second(step_fn: Callable, state, *args, steps: int = 100) -> float:
    """Throughput of a step function that runs `steps` steps per call."""
    seconds, _ = timed_call(lambda: step_fn(state, *args), warmup=1, iters=3)
    return steps / seconds
