"""The port's tracked (anytime) solve loops (nfopp_tpu_torch.solver.tracking)
against the JAX package's.

The bookkeeping (best path, early stop, frozen problems, final selection)
is held against JAX on a stand-in solver whose `run` moves each path by a
fixed velocity per step, so both sides see the same paths bit for bit: the
car scene's rectangle oracle then decides feasibility as the paths bend
through a wall and out again. The port's own solver is then run on a small
car scene (N=20, K=20, R=4, hidden 16, B=4).
"""
import contextlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.solver import tracking as jt
from nfopp_tpu.worlds import RectangleOracle as JaxRectangleOracle
from nfopp_tpu.worlds import rectangle_collision as jax_rectangle_collision
from nfopp_tpu_torch.parallel.mesh import RowLayout
from nfopp_tpu_torch.solver import (
    ConstrainedSolver,
    evaluate_path,
    run_planner_config,
    run_tracking_segment,
    run_with_tracking,
    tracking_finalize,
    tracking_init,
)
from nfopp_tpu_torch.solver import tracking as tt
from nfopp_tpu_torch.tools.scene import car_world
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import (
    RectangleOracle,
    car_environment,
    pad_obstacle_points,
    rectangle_collision,
)
from torch_threads import one_thread  # noqa: F401

CHECK, MIN_ITER, END = 10, 20, 10  # check_freq, min_iterations, chunks


class Moving(NamedTuple):
    trajectory: object  # [(B,) N, 3]
    velocity: object  # [(B,) N, 3] per step
    start: object
    goal: object
    step_count: object


class JaxMovingSolver:
    """Stand-in for the JAX solver (per problem, vmapped by the loops)."""

    oracle_fn = staticmethod(jax_rectangle_collision)

    def run(self, state, oracle_params, num_steps):
        return state._replace(trajectory=state.trajectory + num_steps * state.velocity,
                              step_count=state.step_count + num_steps), None

    def run_grouped(self, states, oracle_params, num_steps, group_size):
        return self.run(states, oracle_params, num_steps)

    def full_trajectory(self, state):
        return jnp.concatenate([state.start[None], state.trajectory, state.goal[None]], axis=0)


class MovingSolver:
    """The same stand-in for the port (batched)."""

    oracle_fn = staticmethod(rectangle_collision)
    layout = RowLayout.alone("cpu")

    def __init__(self):
        self.noise_calls = 0

    def run(self, state, oracle_params, num_steps, noise):
        assert noise == "noise"
        self.noise_calls += 1
        return state._replace(trajectory=state.trajectory + num_steps * state.velocity,
                              step_count=state.step_count + num_steps), None

    def run_grouped(self, states, oracle_params, num_steps, group_size, noise):
        return self.run(states, oracle_params, num_steps, noise)

    def full_trajectory(self, state):
        return torch.cat([state.start[:, None], state.trajectory, state.goal[:, None]], dim=1)

    def live_rows(self, live):
        return contextlib.nullcontext()  # no field kernels to skip


def moving_paths():
    """Four problems in the car scene: a bump that crosses the wall at
    y = 2.3, shrinks through zero and grows on the other side (two rates);
    a path through the wall that never moves; a free path that never moves."""
    n = 8
    x = np.linspace(0.3, 1.4, n + 2)[1:-1]
    bump = np.sin(np.linspace(0, np.pi, n + 2)[1:-1])
    traj = np.zeros((4, n, 3), np.float32)
    vel = np.zeros((4, n, 3), np.float32)
    starts = np.tile(np.array([[0.3, 1.8, 0.0]], np.float32), (4, 1))
    goals = np.tile(np.array([[1.4, 1.8, 0.0]], np.float32), (4, 1))
    for p, (height, rate) in enumerate([(0.7, 0.0095), (0.9, 0.016)]):
        traj[p, :, 0], traj[p, :, 1] = x, 1.8 + height * bump
        vel[p, :, 1] = -rate * bump
    traj[2, :, 0], traj[2, :, 1] = 0.5, np.linspace(1.9, 2.8, n)
    starts[2], goals[2] = [0.5, 1.8, 0.0], [0.5, 2.9, 0.0]
    traj[3, :, 0], traj[3, :, 1] = x, 1.0
    starts[3, 1] = goals[3, 1] = 1.0
    return Moving(traj, vel, starts, goals, np.zeros(4, np.int32))


def oracle_arrays():
    pts, mask = pad_obstacle_points(car_environment().obstacle_points.astype(np.float32), 64)
    return (pts, mask, np.array([-0.3, 0.2, -0.3, 0.2], np.float32),
            np.array([0.0, 3.0, 0.0, 3.0], np.float32))


@pytest.fixture(scope="module")
def moving():
    arrays = oracle_arrays()
    jax_oracle = JaxRectangleOracle(*(jnp.asarray(a) for a in arrays))
    oracle = RectangleOracle(*(torch.tensor(a)[None] for a in arrays))
    state = moving_paths()
    jax_state = Moving(*(jnp.asarray(a) for a in state))
    port_state = Moving(*(torch.tensor(a) for a in state))
    return JaxMovingSolver(), jax_state, jax_oracle, MovingSolver(), port_state, oracle


def jax_segment(solver, carry, oracle, end_chunk, plateau):
    return jax.vmap(lambda c: jt.run_tracking_segment(
        solver, c, oracle, end_chunk, MIN_ITER, CHECK, 5, plateau))(carry)


def port_segment(solver, carry, oracle, end_chunk, plateau):
    return run_tracking_segment(solver, carry, oracle, end_chunk, "noise", MIN_ITER, CHECK, 5,
                                plateau)


def assert_carry_equal(got, ref):
    for name in ("best_path", "best_length"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, err_msg=name)
    for name in ("done", "iterations", "chunk"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.state.trajectory.numpy(), np.asarray(ref.state.trajectory),
                               rtol=1e-5)


@pytest.mark.parametrize("plateau", [True, False])
def test_tracking_segment_matches_jax(moving, plateau):
    """Chunks 0-4, then 4-10 (chained as a resumed solve would), against
    JAX's vmapped while_loop; under plateau stop the two bumps stop at
    different chunks and stay frozen."""
    jax_solver, jax_state, jax_oracle, solver, state, oracle = moving
    jax_carry = jax.vmap(lambda s: jt.tracking_init(jax_solver, s))(jax_state)
    carry = tracking_init(solver, state)
    for end in (4, END):
        jax_carry = jax_segment(jax_solver, jax_carry, jax_oracle, end, plateau)
        carry = port_segment(solver, carry, oracle, end, plateau)
        assert_carry_equal(carry, jax_carry)
    done = carry.done.tolist()
    chunks = carry.chunk.tolist()
    if plateau:
        assert done == [True, True, False, True] and chunks[0] != chunks[1]
        assert max(chunks[:2]) < END and chunks[2] == END  # never feasible: runs to the end
    else:
        assert not any(done) and chunks == [END] * 4
    assert np.isinf(carry.best_length[2].item()) and np.isfinite(carry.best_length[3].item())


@pytest.mark.parametrize("plateau", [True, False])
def test_tracking_finalize_matches_jax(moving, plateau):
    """Final selection on carries with every case of `use_best`: colliding
    and free final paths, with and without a tracked best, a best longer and
    shorter than the final path."""
    jax_solver, jax_state, jax_oracle, solver, state, oracle = moving
    jax_carry = jax_segment(jax_solver, jax.vmap(lambda s: jt.tracking_init(jax_solver, s))(
        jax_state), jax_oracle, 7, False)
    # shorten one best and drop another so that every branch is taken
    jax_carry = jax_carry._replace(
        best_length=jax_carry.best_length.at[3].set(0.5).at[0].set(jnp.inf))
    ref = jax.vmap(lambda c: jt.tracking_finalize(jax_solver, c, jax_oracle, 5, plateau))(
        jax_carry)
    carry = tt.TrackingCarry(*(Moving(*(torch.tensor(np.asarray(x)) for x in leaf))
                               if isinstance(leaf, Moving) else torch.tensor(np.asarray(leaf))
                               for leaf in jax_carry))
    got = tracking_finalize(solver, carry, oracle, 5, plateau)
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path), rtol=1e-5)
    np.testing.assert_allclose(got.length.numpy(), np.asarray(ref.length), rtol=1e-5)
    np.testing.assert_array_equal(got.feasible.numpy(), np.asarray(ref.feasible))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    collides, _ = evaluate_path(rectangle_collision, oracle, carry.best_path)
    assert bool(collides[2]) and not bool(collides[3])


@pytest.mark.parametrize("plateau", [True, False])
def test_run_with_tracking_matches_jax(moving, plateau):
    jax_solver, jax_state, jax_oracle, solver, state, oracle = moving
    ref = jax.vmap(lambda s: jt.run_with_tracking(jax_solver, s, jax_oracle, 95, MIN_ITER, CHECK,
                                                  5, plateau))(jax_state)
    got = run_with_tracking(solver, state, oracle, "noise", 95, MIN_ITER, CHECK, 5, plateau)
    for name in ("path", "length"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, err_msg=name)
    for name in ("feasible", "iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    assert got.iterations.max().item() == END * CHECK  # 95 rounds up to 10 chunks


def test_run_grouped_with_tracking_matches_jax(moving):
    """Full budget, every chunk a best-path candidate past min_iterations."""
    jax_solver, jax_state, jax_oracle, solver, state, oracle = moving
    oracles = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (4,) + (1,) * x.ndim),
                                     jax_oracle)
    ref = jt.run_grouped_with_tracking(jax_solver, jax_state, oracles, 2, 100, MIN_ITER, CHECK)
    got = tt.run_grouped_with_tracking(solver, state, oracle, 2, "noise", 100, MIN_ITER, CHECK)
    assert solver.noise_calls  # the noise source reached every chunk's run
    for name in ("path", "length"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, err_msg=name)
    for name in ("feasible", "iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    assert got.feasible.tolist() == [True, True, False, True]


# ------------------------------------------------ the port's own solver


@pytest.fixture(scope="module")
def car_solve():
    """A small car-scene solve, tracked to chunk 4 and then to chunk 12 with
    plateau stop; the dynamic step must never run (every chunk enters at a
    reparametrization boundary, frozen problems included)."""
    cfg = run_planner_config()._replace(trajectory_length=20, collision_point_count=20,
                                        random_field_points=4)
    cfg = cfg._replace(onf=cfg.onf._replace(hidden=16))
    oracle, start, goal, bounds = car_world(4, "cpu")
    solver = ConstrainedSolver(cfg, rectangle_collision, device="cpu")

    def no_dynamic_step(*args):
        raise AssertionError("a chunk fell back to the dynamic schedule")

    solver.step = no_dynamic_step
    g = torch.Generator().manual_seed(0)
    carry = tracking_init(solver, solver.init_state(g, start, goal, bounds, oracle))
    mid = run_tracking_segment(solver, carry, oracle, 4, g, 100, 50)
    end = run_tracking_segment(solver, mid, oracle, 12, g, 100, 50)
    result = tracking_finalize(solver, end, oracle)
    return solver, oracle, start, goal, mid, end, result


def test_car_scene_solves_and_stops_early(car_solve):
    solver, oracle, start, goal, mid, end, result = car_solve
    assert result.feasible.all()
    assert result.iterations.max().item() < 600  # early stop saved iterations
    path = result.path.numpy()
    np.testing.assert_allclose(path[:, 0], start, atol=1e-6)
    np.testing.assert_allclose(path[:, -1], goal, atol=1e-6)
    collides, length = evaluate_path(rectangle_collision, oracle, result.path)
    assert not collides.any()
    np.testing.assert_allclose(length.numpy(), result.length.numpy(), rtol=1e-6)
    assert (end.state.step_count % 10 == 0).all()


def test_frozen_problem_state_stops_changing(car_solve):
    """A problem done at chunk 4 keeps every state leaf, counter and best
    path bit for bit through the next eight chunks."""
    solver, oracle, start, goal, mid, end, result = car_solve
    done = mid.done.nonzero().flatten().tolist()
    running = (~mid.done).nonzero().flatten().tolist()
    assert done and running
    for i in done:
        for a, b in zip(tree_leaves(mid.state), tree_leaves(end.state)):
            assert torch.equal(a[i], b[i])
        for name in ("best_path", "best_length", "iterations", "chunk"):
            assert torch.equal(getattr(mid, name)[i], getattr(end, name)[i]), name
    assert (end.iterations[running] > mid.iterations[running]).all()
