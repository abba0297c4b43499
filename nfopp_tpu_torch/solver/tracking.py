"""Benchmark-mode solve loop on a batch of problems: periodic path
evaluation, best-path tracking, early stop (port of
`nfopp_tpu/solver/tracking.py`).

Step the solver up to `max_iterations` in `check_freq`-step chunks; past
`min_iterations` evaluate each path against the oracle after every chunk,
remember the shortest feasible one, and (stop_on_plateau) stop a problem at
its first feasible path that no longer improves; finally return the current
path unless it collides and a feasible best exists.

JAX's `lax.while_loop` over vmapped chunks becomes a Python loop over
`solver.run(state, oracle_params, check_freq, noise)` on the whole batch:
problems already done are frozen (`tree_where`, state and counters alike),
and the loop ends when every problem is done or `end_chunk` is reached, which
costs one host sync per chunk. Frozen problems are still computed, and still
draw noise, as vmap's lanes are. On a problem mesh (the solver's `mesh`, or
the `mesh` given) each rank holds rows of the batch, and the ranks agree on
whether any problem is still active (one small all_reduce per chunk), so all
run the same chunks, as the 1-rank loop does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.math import dense_path
from ..parallel.mesh import any_over_problems
from ..utils import profiling
from ..utils.tree import tree_where

__all__ = [
    "TrackingCarry",
    "TrackingResult",
    "evaluate_path",
    "run_with_tracking",
    "run_grouped_with_tracking",
    "run_tracking_segment",
    "tracking_finalize",
    "tracking_init",
]


class TrackingResult(NamedTuple):
    state: Any  # final solver state
    path: torch.Tensor  # [B, N+2, d] returned paths (best-feasible fallback applied)
    length: torch.Tensor  # [B] xy length of `path`
    feasible: torch.Tensor  # [B] bool: `path` is collision-free
    iterations: torch.Tensor  # [B] int32: solver steps taken


class TrackingCarry(NamedTuple):
    """Mid-solve tracking state of a batch, the checkpointable unit of a
    benchmark solve: `run_with_tracking` = tracking_init ->
    run_tracking_segment(all chunks) -> tracking_finalize."""

    state: Any  # solver state
    best_path: torch.Tensor  # [B, N+2, d]
    best_length: torch.Tensor  # [B]
    done: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32
    chunk: torch.Tensor  # [B] int32: chunks completed so far


def evaluate_path(
    oracle_fn, oracle_params: Any, full_path: torch.Tensor, samples_per_segment: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(collides [B], xy length [B]) of paths [B, M, d]: interpolate
    `samples_per_segment` poses per segment, ask the oracle, measure (an
    `evaluate` span)."""
    with profiling.span("evaluate", batch=full_path.shape[0]):
        dense = dense_path(full_path, samples_per_segment)
        collides = torch.any(oracle_fn(oracle_params, dense), dim=1)
        seg = full_path[:, 1:, :2] - full_path[:, :-1, :2]
        length = torch.sum(torch.sqrt(torch.sum(seg * seg, dim=-1)), dim=1)
        return collides, length


def run_with_tracking(
    solver,
    state: Any,
    oracle_params: Any,
    noise,
    max_iterations: int = 1000,
    min_iterations: int = 200,
    check_freq: int = 50,
    samples_per_segment: int = 5,
    stop_on_plateau: bool = True,
) -> TrackingResult:
    """Benchmark solve loop for a batch of problems; max_iterations is
    rounded up to a whole number of check_freq chunks.

    stop_on_plateau=True reproduces the reference's break at the first
    feasible check that does not improve; False keeps refining to
    max_iterations and returns the best feasible path seen.
    """
    num_chunks = -(-max_iterations // check_freq)
    carry = tracking_init(solver, state)
    carry = run_tracking_segment(
        solver, carry, oracle_params, num_chunks, noise, min_iterations, check_freq,
        samples_per_segment, stop_on_plateau,
    )
    return tracking_finalize(solver, carry, oracle_params, samples_per_segment,
                             stop_on_plateau)


def tracking_init(solver, state: Any) -> TrackingCarry:
    """Fresh carry at chunk 0 (before the solve)."""
    batch = state.start.shape[0]
    device = state.start.device
    return TrackingCarry(
        state=state,
        best_path=solver.full_trajectory(state),
        best_length=torch.full((batch,), torch.inf, device=device),
        done=torch.zeros((batch,), dtype=torch.bool, device=device),
        iterations=torch.zeros((batch,), dtype=torch.int32, device=device),
        chunk=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def run_tracking_segment(
    solver,
    carry: TrackingCarry,
    oracle_params: Any,
    end_chunk: int,
    noise,
    min_iterations: int = 200,
    check_freq: int = 50,
    samples_per_segment: int = 5,
    stop_on_plateau: bool = True,
    mesh=None,
) -> TrackingCarry:
    """Advance the tracked solve until each problem has `end_chunk` chunks
    done or has stopped early. Chaining segments is the same computation as
    one segment over the whole range (with the same noise). On a mesh
    (default: the solver's) the loop runs while a problem of any rank is
    active."""
    mesh = getattr(solver, "mesh", None) if mesh is None else mesh
    while True:
        active = ~carry.done & (carry.chunk < end_chunk)
        if not any_over_problems(active, mesh):
            return carry
        stepped, _ = solver.run(carry.state, oracle_params, check_freq, noise)
        state = tree_where(active, stepped, carry.state)
        iterations = torch.where(active, carry.iterations + check_freq, carry.iterations)
        path = solver.full_trajectory(state)
        collides, length = evaluate_path(solver.oracle_fn, oracle_params, path,
                                         samples_per_segment)
        feasible = active & (iterations > min_iterations) & ~collides
        improves = feasible & (length < carry.best_length)
        done = carry.done | (feasible & ~improves) if stop_on_plateau else carry.done
        carry = TrackingCarry(
            state=state,
            best_path=torch.where(improves[:, None, None], path, carry.best_path),
            best_length=torch.where(improves, length, carry.best_length),
            done=done,
            iterations=iterations,
            chunk=torch.where(active, carry.chunk + 1, carry.chunk),
        )


def tracking_finalize(
    solver,
    carry: TrackingCarry,
    oracle_params: Any,
    samples_per_segment: int = 5,
    stop_on_plateau: bool = True,
) -> TrackingResult:
    """Final-path selection (`tracking.py:171-199`)."""
    final_path = solver.full_trajectory(carry.state)
    final_collides, final_length = evaluate_path(
        solver.oracle_fn, oracle_params, final_path, samples_per_segment
    )
    has_best = torch.isfinite(carry.best_length)
    if stop_on_plateau:
        # the reference's return: the final path unless it collides
        use_best = final_collides & has_best
    else:
        # full budget: the final iterate can oscillate above the tracked best
        use_best = has_best & (final_collides | (carry.best_length < final_length))
    return TrackingResult(
        state=carry.state,
        path=torch.where(use_best[:, None, None], carry.best_path, final_path),
        length=torch.where(use_best, carry.best_length, final_length),
        feasible=~final_collides | has_best,
        iterations=carry.iterations,
    )


def run_grouped_with_tracking(
    solver,
    states: Any,
    oracle_params: Any,
    group_size: int,
    noise,
    max_iterations: int = 1000,
    min_iterations: int = 200,
    check_freq: int = 50,
    samples_per_segment: int = 5,
) -> TrackingResult:
    """Shared-field benchmark solve: check_freq-step chunks of
    `solver.run_grouped` (one field per `group_size` problems) with
    per-problem best-path bookkeeping.

    No per-problem early stop: the shared field keeps stepping for the whole
    group, so the full budget always runs and every chunk's path past
    min_iterations is a best-path candidate, the last chunk's included.
    """
    num_chunks = -(-max_iterations // check_freq)
    batch = states.start.shape[0]
    device = states.start.device
    best_path = solver.full_trajectory(states)
    best_length = torch.full((batch,), torch.inf, device=device)
    best_feasible = torch.zeros((batch,), dtype=torch.bool, device=device)
    iterations = torch.zeros((batch,), dtype=torch.int32, device=device)
    for c in range(num_chunks):
        states, _ = solver.run_grouped(states, oracle_params, check_freq, group_size, noise)
        paths = solver.full_trajectory(states)
        collides, length = evaluate_path(solver.oracle_fn, oracle_params, paths,
                                         samples_per_segment)
        done = (c + 1) * check_freq
        better = (done > min_iterations) & ~collides & (length < best_length)
        best_path = torch.where(better[:, None, None], paths, best_path)
        best_length = torch.where(better, length, best_length)
        best_feasible = best_feasible | better
        iterations = torch.where(better, torch.full_like(iterations, done), iterations)
    # the last chunk's evaluation is the final one; a feasible final iterate
    # counts even without a tracked best
    no_best = ~best_feasible
    return TrackingResult(
        state=states,
        path=torch.where(no_best[:, None, None], paths, best_path),
        length=torch.where(no_best, length, best_length),
        feasible=best_feasible | (no_best & ~collides),
        iterations=torch.where(no_best, torch.full_like(iterations, num_chunks * check_freq),
                               iterations),
    )
