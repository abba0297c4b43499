"""Profiling helpers: torch.profiler traces and timing of whole calls
(port of `nfopp_tpu/utils/profiling.py`, which uses jax.profiler and
block_until_ready).

A host-side tick/tock around asynchronous launches measures only their
dispatch. These helpers synchronise the card before every clock read:
`trace` writes a Chrome trace of the enclosed block (open it in
chrome://tracing or Perfetto), `timed_call` gives the median seconds per
call, each call finished on every card its result lives on.
"""
from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Any, Callable

import torch

from .tree import tree_leaves

__all__ = ["trace", "timed_call", "steps_per_second"]


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
