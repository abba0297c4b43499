"""The static step schedule of every run loop (port of
`nfopp_tpu/solver/schedule.py::scan_chunked` as a Python loop).

num_steps // freq chunks of [1 step with reparametrization, freq-1 plain
steps]: reparametrization fires at the end of the first step of each chunk,
i.e. at step counts 0, freq, 2*freq, ... With field_stride s > 1 (s divides
freq) the field trains only at chunk positions 0, s, 2s, ...
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["scan_chunked"]


def scan_chunked(
    step_fn: Callable[[Any, bool, bool], tuple[Any, Any]],
    state: Any,
    num_steps: int,
    freq: int,
    field_stride: int = 1,
) -> tuple[Any, list]:
    """Run `num_steps` steps of step_fn(state, with_reparam, with_field) ->
    (state, aux); returns the final state and the per-step aux in order.
    Requires freq > 1 and num_steps % freq == 0, as the JAX version."""
    stride = max(1, field_stride)
    if freq % stride != 0:
        raise ValueError(f"field_stride {stride} must divide freq {freq}")
    aux = []
    for _ in range(num_steps // freq):
        for position in range(freq):
            state, a = step_fn(state, position == 0, position % stride == 0)
            aux.append(a)
    return state, aux
