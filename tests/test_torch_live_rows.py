"""Live rows: the tracked loop's stopped problems skip the field kernels.

On the CPU: each of the four field passes' plain twins (ONF logits, field
gradient, collision forward and its backward) gives, under live rows, the
unmasked call's values bit for bit on the live rows and exactly zero on the
others, as its kernel does; the tracked loop, which sets live rows once
problems stop, keeps every result of a loop that sets none, also through a
four-argument wrapper of `solver.run` (as the benchmark's corridor check
wraps it), and counts the skipped lane-steps; the captured programs'
live-rows buffer is all live again after a replay that raised.

On the card (`PYTHONPATH=.:tests python3 -m pytest --noconftest
tests/test_torch_live_rows.py -m card`, without the suite's JAX set-up):
each CUDA kernel at B=256 with 128 live rows against all live, and a
corridor suite round of the benchmark's cell with live rows against one
without. This file imports no JAX.
"""
import contextlib

import pytest
import torch

from nfopp_tpu_torch import kernels
from nfopp_tpu_torch.models.onf import init_onf_params
from nfopp_tpu_torch.solver import (
    ConstrainedSolver,
    TrackingCarry,
    evaluate_path,
    run_planner_config,
    run_with_tracking,
    tracking_finalize,
    tracking_init,
)
from nfopp_tpu_torch.solver import tracking
from nfopp_tpu_torch.solver.constrained import _FieldSolver, _live_buffer, _live_rows_copied
from nfopp_tpu_torch.tools.scene import car_world
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_where
from nfopp_tpu_torch.worlds import rectangle_collision
from torch_threads import one_thread  # noqa: F401

KERNELS = ("onf_forward", "field_grad", "collision_fwd", "collision_bwd")
CHECK, MIN_ITER, MAX_ITER = 50, 100, 400  # the tracked loop's small car solve


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def field_pass(name: str, params, config, batch: int, device, live):
    """The outputs [B, ...] of field pass `name` on seeded inputs of `batch`
    problems (the main path's M per pass), under live rows `live`."""
    g = torch.Generator().manual_seed(1)

    def rand(*shape):
        return torch.rand(shape, generator=g).to(device)

    if name == "onf_forward":
        return [kernels.onf_forward(params, rand(batch, 199, 3) * 3, config, live)]
    if name == "field_grad":
        loss, grads = kernels.field_grad(params, rand(batch, 209, 3) * 3,
                                         rand(batch, 209) > 0.5, config, live)
        return [loss, *tree_leaves(grads)]
    positions = (rand(batch, 99, 3) * 3).requires_grad_(name == "collision_bwd")
    multipliers = rand(batch, 99).requires_grad_(name == "collision_bwd")
    soft, tanh = kernels.collision_terms(params, positions, multipliers, config, 10.0, live)
    if name == "collision_fwd":
        return [soft.detach(), tanh.detach()]
    cotangents = rand(2, batch)
    return list(torch.autograd.grad((soft * cotangents[0] + tanh * cotangents[1]).sum(),
                                    [positions, multipliers]))


def held_by_live_rows(name: str, config, batch: int, device, live) -> None:
    """Under `live`, pass `name` gives the unmasked values on the live rows
    bit for bit and zeros on the others."""
    params = init_onf_params(torch.Generator().manual_seed(0), config, batch, device)
    full = field_pass(name, params, config, batch, device, None)
    masked = field_pass(name, params, config, batch, device, live)
    assert len(full) == len(masked)
    for a, b in zip(full, masked):
        assert torch.equal(b[live], a[live]), name
        assert torch.equal(b[~live], torch.zeros_like(b[~live])), name
        assert (a[~live] != 0).any(), name  # the zeros are the mask's, not the pass's


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", KERNELS)
def test_a_plain_twin_gives_zeros_to_the_rows_that_are_not_live(name, dtype):
    onf = run_planner_config().onf._replace(hidden=16, angle_harmonics=2, compute_dtype=dtype)
    live = torch.tensor([True, False, True, True, False])
    held_by_live_rows(name, onf, 5, torch.device("cpu"), live)


def test_live_rows_are_a_bool_per_problem():
    onf = run_planner_config().onf._replace(hidden=16, angle_harmonics=2)
    params = init_onf_params(torch.Generator().manual_seed(0), onf, 3)
    with pytest.raises(ValueError, match="live rows"):
        kernels.onf_forward(params, torch.zeros(3, 4, 3), onf, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="live rows"):
        kernels.onf_forward(params, torch.zeros(3, 4, 3), onf, torch.ones(2, dtype=torch.bool))


# ---------------------------------------------------------- the tracked loop


def car_solver():
    """A small car-scene solver (N=20, K=20, R=4, hidden 16) and its B=4 problems."""
    cfg = run_planner_config()._replace(trajectory_length=20, collision_point_count=20,
                                        random_field_points=4)
    cfg = cfg._replace(onf=cfg.onf._replace(hidden=16))
    oracle, start, goal, bounds = car_world(4, "cpu")
    solver = ConstrainedSolver(cfg, rectangle_collision, device="cpu")
    state = solver.init_state(torch.Generator().manual_seed(0), start, goal, bounds, oracle)
    return solver, oracle, state


def loop_without_live_rows(solver, state, oracle, noise):
    """`run_with_tracking` as the module writes it, but for live rows: every
    chunk runs every row through the field kernels."""
    carry = tracking_init(solver, state)
    chunks = MAX_ITER // CHECK
    while True:
        active = ~carry.done & (carry.chunk < chunks)
        if not active.any():
            return tracking_finalize(solver, carry, oracle)
        stepped, _ = solver.run(carry.state, oracle, CHECK, noise)
        state = tree_where(active, stepped, carry.state)
        iterations = torch.where(active, carry.iterations + CHECK, carry.iterations)
        path = solver.full_trajectory(state)
        collides, length = evaluate_path(solver.oracle_fn, oracle, path)
        feasible = active & (iterations > MIN_ITER) & ~collides
        improves = feasible & (length < carry.best_length)
        carry = TrackingCarry(
            state=state,
            best_path=torch.where(improves[:, None, None], path, carry.best_path),
            best_length=torch.where(improves, length, carry.best_length),
            done=carry.done | (feasible & ~improves),
            iterations=iterations,
            chunk=torch.where(active, carry.chunk + 1, carry.chunk),
        )


@pytest.fixture(scope="module")
def without_live_rows():
    solver, oracle, state = car_solver()
    return loop_without_live_rows(solver, state, oracle, torch.Generator().manual_seed(1))


def skipped_lane_steps(iterations: torch.Tensor) -> int:
    """(rows - live) x steps over the chunks the loop ran: a problem is live
    in chunk c while it has more than c x CHECK iterations to come."""
    chunks = int(iterations.max()) // CHECK
    return sum(int((iterations <= c * CHECK).sum()) * CHECK for c in range(chunks))


@pytest.mark.parametrize("wrapped", [False, True])
def test_the_tracked_loop_keeps_what_a_loop_without_live_rows_keeps(without_live_rows,
                                                                    wrapped):
    solver, oracle, state = car_solver()
    if wrapped:  # as the benchmark's corridor check wraps `run`
        method = type(solver).run
        solver.run = lambda state, oracle, steps, noise: method(solver, state, oracle, steps,
                                                                 noise)
    before = dict(tracking.LANE_STEPS)
    got = run_with_tracking(solver, state, oracle, torch.Generator().manual_seed(1), MAX_ITER,
                            MIN_ITER, CHECK)
    counted = {k: n - before[k] for k, n in tracking.LANE_STEPS.items()}
    want = without_live_rows
    # problems stop at different chunks, so live rows are set
    assert len(set(want.iterations.tolist())) > 1
    assert counted["skipped"] == skipped_lane_steps(want.iterations) > 0
    assert counted["one_wave"] == 0  # no card
    for name in ("path", "length", "feasible", "iterations"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for a, b in zip(tree_leaves(got.state), tree_leaves(want.state)):
        assert torch.equal(a, b)


def test_a_shared_field_run_takes_no_live_rows():
    solver, oracle, state = car_solver()
    with solver.live_rows(torch.ones(4, dtype=torch.bool)), pytest.raises(ValueError):
        solver.run_grouped(state, oracle, 10, 2, torch.Generator().manual_seed(1))


def test_a_replay_that_raises_leaves_every_row_live():
    """The captured programs' live-rows buffer holds the live rows only for
    the replays: one that raises leaves every row live for the next caller
    of its batch."""
    buffer = _live_buffer(torch.device("cpu"), 4)
    live = torch.tensor([True, False, True, False])
    with pytest.raises(RuntimeError, match="replay"):
        with _live_rows_copied(buffer, live):
            assert torch.equal(buffer, live)
            raise RuntimeError("a replay failed")
    assert _live_buffer(torch.device("cpu"), 4).all()
    with _live_rows_copied(buffer, None):  # no live rows set
        assert buffer.all()


# ------------------------------------------------------------------ the card


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", KERNELS)
def test_a_kernel_skips_the_rows_that_are_not_live(card, name, dtype):
    onf = run_planner_config().onf._replace(compute_dtype=dtype)
    live = torch.zeros(256, dtype=torch.bool)
    live[torch.randperm(256, generator=torch.Generator().manual_seed(2))[:128]] = True
    held_by_live_rows(name, onf, 256, card, live.to(card))
    torch.cuda.synchronize(card)


@pytest.mark.card
def test_a_corridor_round_keeps_its_results_with_live_rows(card, monkeypatch):
    """One round of the benchmark's corridor-suite-256 cell (its worlds, its
    solver, its captured programs), with live rows and with none: its eight
    result arrays equal."""
    import numpy as np

    from nfbench.drivers import grid_suite
    from nfbench.harness import core

    cell = grid_suite.Driver(core.Cell.load("corridor-suite-256"), 3, card, core.Spans(), {})
    cell.setup()
    before = dict(tracking.LANE_STEPS)
    with_live = cell.round(core.batch_seed(3, 0))
    assert tracking.LANE_STEPS["skipped"] > before["skipped"]
    assert tracking.LANE_STEPS["one_wave"] > before["one_wave"]
    monkeypatch.setattr(_FieldSolver, "live_rows",
                        lambda self, live: contextlib.nullcontext())
    without = cell.round(core.batch_seed(3, 0))
    for name in ("paths", "feasible", "lengths", "iterations", "start_invalid", "goal_invalid",
                 "repaired_by_shortcut", "restart_rounds_used"):
        np.testing.assert_array_equal(getattr(with_live, name), getattr(without, name), name)
