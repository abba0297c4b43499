"""The port's holonomic solver (nfopp_tpu_torch.solver.holonomic) and the ops
it and later modules use, against the JAX package, with JAX's own random
draws handed to the port.

Scene: the holonomic two-walls scene with a disc robot (circle oracle,
radius 0.3); config: `make_onf_planner`'s demo config cut to N=12 waypoints,
K=12 buffer points, R=4 random points, hidden 16, for B=3 problems.

Run as a script, this file measures the JAX solver's feasible fraction on
the full-size scene instead (see `main`).
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.ops import losses as jl
from nfopp_tpu.ops import math as jm
from nfopp_tpu.ops import reparametrize as jr
from nfopp_tpu.ops import sampling as js
from nfopp_tpu.solver import HolonomicSolver as JaxHolonomicSolver
from nfopp_tpu.solver import SolverConfig as JaxSolverConfig
from nfopp_tpu.worlds import CircleOracle as JaxCircleOracle
from nfopp_tpu.worlds import circle_collision as jax_circle_collision
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.ops import losses as tl
from nfopp_tpu_torch.ops import math as tm
from nfopp_tpu_torch.ops import reparametrize as tr
from nfopp_tpu_torch.ops import sampling as ts
from nfopp_tpu_torch.solver import HolonomicSolver, SolverConfig, holonomic_state_from_jax
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    circle_collision,
    pad_obstacle_points,
    two_walls_environment,
)
from torch_threads import one_thread  # noqa: F401

BATCH = 3
# make_onf_planner's demo config (solver/api.py:223-237), cut to size
JCFG = JaxSolverConfig(
    trajectory_length=12, collision_point_count=12, random_field_points=4,
    onf=JaxONFConfig(mean=1.5, sigma=1.0, use_cos=False, use_normal_init=False,
                     angle_encoding=False, hidden=16),
    collision_lr=1e-3, collision_betas=(0.9, 0.9), trajectory_lr=1e-2,
    trajectory_betas=(0.9, 0.999), trajectory_random_offset=0.02, collision_weight=0.01,
    velocity_hessian_weight=3.0, init_collision_iteration=5,
)
CFG = SolverConfig(**{**JCFG._asdict(), "onf": ONFConfig(**JCFG.onf._asdict())})
N = CFG.trajectory_length


class ReplayNoise:
    """Noise source that hands out pre-drawn arrays in call order."""

    def __init__(self):
        self.queue = []

    def push(self, kind, array):
        self.queue.append((kind, np.asarray(array, np.float32)))

    def _next(self, kind, shape, device):
        want, array = self.queue.pop(0)
        assert want == kind and array.shape == tuple(shape), (want, kind, array.shape, shape)
        return torch.tensor(array, device=device)

    def uniform(self, shape, device):
        return self._next("uniform", shape, device)

    def normal(self, shape, device):
        return self._next("normal", shape, device)


def step_draws(key):
    """One holonomic step's draws (holonomic.py:128, field.py:70-87, :208)."""
    key, k_field, k_traj = jax.random.split(key, 3)
    k_uni, k_norm = jax.random.split(k_field, 2)
    cand = JCFG.collision_point_count + N - 1
    u = jax.random.uniform(k_uni, ((N - 1) + cand + JCFG.random_field_points * 2,), jnp.float32)
    normal = jax.random.normal(k_norm, (2, N - 1, 2), jnp.float32)
    t = jax.random.uniform(k_traj, (N - 1, 1), jnp.float32)
    return key, u, normal, t


def replay(keys, steps):
    noise = ReplayNoise()
    for _ in range(steps):
        keys, u, normal, t = jax.vmap(step_draws)(keys)
        noise.push("uniform", u)
        noise.push("normal", normal)
        noise.push("uniform", t)
    return noise


def oracle_arrays():
    pts, mask = pad_obstacle_points(two_walls_environment().obstacle_points.astype(np.float32), 32)
    return pts, mask, np.float32(0.3), np.array([0.0, 3.0, 0.0, 3.0], np.float32)


@pytest.fixture(scope="module")
def world():
    env = two_walls_environment()
    pts, mask, radius, bounds = oracle_arrays()
    jax_oracle = JaxCircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(radius),
                                 jnp.asarray(bounds))
    oracle = CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None],
                          torch.tensor([radius]), torch.tensor(bounds)[None])
    jax_solver = JaxHolonomicSolver(JCFG, jax_circle_collision)
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    goals = jnp.asarray([env.goal, [2.5, 1.0], [0.5, 2.5]], jnp.float32)
    state0 = jax.jit(jax.vmap(lambda k, g: jax_solver.init_state(
        k, jnp.asarray(env.start), g, jnp.asarray(env.bounds, jnp.float32), jax_oracle)))(
        keys, goals)
    state20, _ = jax.jit(jax.vmap(lambda s: jax_solver.run(s, jax_oracle, 20)))(state0)
    return {"jax_oracle": jax_oracle, "oracle": oracle, "jax_solver": jax_solver,
            "solver": HolonomicSolver(CFG, circle_collision, device="cpu"),
            "state0": state0, "state20": state20}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_state(jax_state):
    return holonomic_state_from_jax(to_np(jax_state), device="cpu")


def test_angle_encoding_raises():
    with pytest.raises(ValueError, match="angle_encoding=False"):
        HolonomicSolver(CFG._replace(onf=CFG.onf._replace(angle_encoding=True)),
                        circle_collision, device="cpu")


def test_state_from_jax_and_initial_trajectory(world):
    state = port_state(world["state0"])
    assert tuple(state.trajectory.shape) == (BATCH, N, 2)
    assert tuple(state.buffer_points.shape) == (BATCH, JCFG.collision_point_count, 2)
    assert "angle_biases" not in state.field_params
    assert tuple(state.field_params["mlp1"]["w"].shape) == (BATCH, 100, 16)
    env = two_walls_environment()
    ref = world["jax_solver"].initial_trajectory(jnp.asarray(env.start), jnp.asarray(env.goal))
    got = world["solver"].initial_trajectory(env.start[None], env.goal[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=1e-6)


def test_init_state_pretrains_on_points(world):
    """The port's own init: 2-wide buffer points inside the bounds, the
    pretraining's Adam count at init_collision_iteration, finite fields."""
    env = two_walls_environment()
    g = torch.Generator().manual_seed(0)
    state = world["solver"].init_state(g, np.tile(env.start, (BATCH, 1)),
                                       np.tile(env.goal, (BATCH, 1)),
                                       np.tile(np.float32(env.bounds), (BATCH, 1)), world["oracle"])
    assert tuple(state.buffer_points.shape) == (BATCH, JCFG.collision_point_count, 2)
    assert (state.buffer_points[..., 0] >= -0.1).all() and (state.buffer_points[..., 0] <= 3.1).all()
    assert state.field_opt_state.count.tolist() == [JCFG.init_collision_iteration] * BATCH
    assert all(torch.isfinite(leaf).all() for leaf in tree_leaves(state.field_params))


def test_step_static_matches_jax(world):
    """One step with reparametrization from a state 20 steps in, every leaf
    within rtol 1e-4 (as the constrained solver's one-step test)."""
    state = world["state20"]
    ref, ref_aux = jax.jit(jax.vmap(lambda s: world["jax_solver"].step_static(
        s, world["jax_oracle"], with_reparam=True)))(state)
    noise = replay(state.key, 1)
    got, aux = world["solver"].step_static(port_state(state), world["oracle"], noise,
                                           with_reparam=True)
    assert not noise.queue
    want = port_state(ref)
    for field, g, w in zip(got._fields, got, want):
        for a, b in zip(tree_leaves(g), tree_leaves(w)):
            assert a.shape == b.shape and a.dtype == b.dtype, field
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5, err_msg=field)
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(ref_aux.field_loss), rtol=1e-5)
    np.testing.assert_allclose(aux.trajectory_loss.numpy(), np.asarray(ref_aux.trajectory_loss),
                               rtol=1e-5)


@pytest.mark.parametrize("steps", [20, 13])
def test_run_matches_jax(world, steps):
    """20 steps (static schedule, two reparametrizations) and 13 (dynamic),
    trajectory atol 2e-3."""
    state0 = world["state0"]
    ref, _ = jax.jit(jax.vmap(lambda s: world["jax_solver"].run(s, world["jax_oracle"], steps)))(
        state0)
    noise = replay(state0.key, steps)
    got, aux = world["solver"].run(port_state(state0), world["oracle"], steps, noise)
    assert not noise.queue and tuple(aux.trajectory_loss.shape) == (BATCH, steps)
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(ref.step_count))


@pytest.mark.parametrize("which", ["goal", "start"])
def test_update_goal_and_start_match_jax(world, which):
    """No +1 offset (holonomic.py:255-273): with the reparametrization taken
    out the same rows move to the same bits; with it, the trajectories agree
    within the reparametrization's rounding."""
    state = world["state20"]
    points = jnp.asarray([[2.0, 2.0], [0.7, 0.4], [1.5, 2.9]], jnp.float32)
    name = f"update_{which}"
    jax_clamp = JaxHolonomicSolver(JCFG, jax_circle_collision)
    clamp = HolonomicSolver(CFG, circle_collision, device="cpu")
    jax_clamp._reparametrize = clamp._reparametrize = lambda s: s
    for jax_solver, solver, exact in ((jax_clamp, clamp, True),
                                      (world["jax_solver"], world["solver"], False)):
        ref = jax.jit(jax.vmap(getattr(jax_solver, name)))(state, points)
        got = getattr(solver, name)(port_state(state), np.asarray(points))
        if exact:
            np.testing.assert_array_equal(got.trajectory.numpy(), np.asarray(ref.trajectory))
            moved = (got.trajectory.numpy() == np.asarray(points)[:, None]).all(axis=-1)
            assert moved.any() and not moved.all()
        else:
            np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory),
                                       atol=1e-6)
        np.testing.assert_array_equal(getattr(got, which).numpy(), np.asarray(points))
        assert got.step_count.tolist() == [0] * BATCH


# ------------------------------------------------------------- ops leftovers


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_distance_loss_matches_jax():
    full = np.random.RandomState(0).randn(3, 9, 2).astype(np.float32)
    np.testing.assert_allclose(tl.distance_loss(t(full)).numpy(),
                               np.asarray(jax.vmap(jl.distance_loss)(jnp.asarray(full))),
                               rtol=1e-6)


@pytest.mark.parametrize("collapsed", [False, True])
def test_reparametrize_xy_matches_jax(collapsed):
    rng = np.random.RandomState(1)
    full = np.cumsum(rng.uniform(0.0, 0.5, (3, 14, 2)), axis=1).astype(np.float32)
    if collapsed:
        full[1] = full[1, :1]  # a path of one repeated point: zero arc length
    got = tr.reparametrize_xy(t(full)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.vmap(jr.reparametrize_xy)(jnp.asarray(full))),
                               rtol=1e-6, atol=1e-6)
    assert got.shape == (3, 12, 2) and np.isfinite(got).all()


def test_unfold_angles_matches_jax():
    rng = np.random.RandomState(2)
    angles = np.cumsum(rng.uniform(-2.5, 2.5, (3, 17)), axis=1).astype(np.float32)
    got = tm.unfold_angles(t(angles)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.vmap(jm.unfold_angles)(jnp.asarray(angles))),
                               rtol=1e-6, atol=1e-6)
    assert (np.abs(np.diff(got, axis=1)) <= np.pi + 1e-5).all()


def test_sinc_matches_jax():
    x = np.array([-3.0, -1e-3, -1e-4, -1e-5, 0.0, 1e-5, 1e-4, 1e-3, 0.5, 7.0], np.float32)
    got = tm.sinc(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.sinc(jnp.asarray(x))), rtol=1e-6)
    assert np.isfinite(got).all()


def test_gumbel_topk_indices_matches_jax():
    """The same uniform draws give the same indices; the draws may also come
    from a noise source."""
    rng = np.random.RandomState(3)
    weights = rng.uniform(0.0, 1.0, (3, 40)).astype(np.float32)
    weights[:, :5] = 0.0  # zero weights come last
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    ref = jax.vmap(lambda k, w: js.gumbel_topk_indices(k, w, 30))(keys, jnp.asarray(weights))
    draws = jax.vmap(lambda k: jax.random.uniform(k, (40,), minval=1e-20, maxval=1.0))(keys)
    got = ts.gumbel_topk_indices(t(draws), t(weights), 30)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    noise = ReplayNoise()
    noise.push("uniform", draws)
    np.testing.assert_array_equal(ts.gumbel_topk_indices(noise, t(weights), 30).numpy(),
                                  np.asarray(ref))
    assert not (got.numpy()[:, :35 - 5] < 5).any()


def test_random_intermediate_positions_matches_jax():
    rng = np.random.RandomState(4)
    traj = rng.randn(3, 10, 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    ref = jax.vmap(js.random_intermediate_positions)(keys, jnp.asarray(traj))
    draws = jax.vmap(lambda k: jax.random.uniform(k, (9, 1), jnp.float32))(keys)
    got = ts.random_intermediate_positions(t(draws), t(traj))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="shape"):
        ts.random_intermediate_positions(t(draws)[:, :5], t(traj))


# ------------------------------------------ feasibility of the JAX solver


def main() -> None:
    """The JAX HolonomicSolver's feasible fraction on the two-walls scene,
    with make_onf_planner's full demo config (N=100, 400 pretraining
    iterations) and the circle oracle above, vmapped over `--problems`
    problems x `--steps` steps on the CPU; prints one JSON line. The port's
    counterpart is chip_smoke.py's holonomic phase."""
    from nfopp_tpu.solver.tracking import evaluate_path as jax_evaluate_path

    parser = argparse.ArgumentParser(description=main.__doc__.split(";")[0])
    parser.add_argument("--problems", type=int, default=16)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")

    cfg = JaxSolverConfig(
        onf=JaxONFConfig(mean=1.5, sigma=1.0, use_cos=False, use_normal_init=False,
                         angle_encoding=False),
        collision_lr=1e-3, collision_betas=(0.9, 0.9), trajectory_lr=1e-2,
        trajectory_betas=(0.9, 0.999), trajectory_random_offset=0.02, collision_weight=0.01,
        velocity_hessian_weight=3.0, random_field_points=10, init_collision_iteration=400,
    )
    env = two_walls_environment()
    pts, mask, radius, bounds = oracle_arrays()
    oracle = JaxCircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(radius),
                             jnp.asarray(bounds))
    solver = JaxHolonomicSolver(cfg, jax_circle_collision)

    @jax.jit
    def solve(keys):
        states = jax.vmap(lambda k: solver.init_state(
            k, jnp.asarray(env.start), jnp.asarray(env.goal),
            jnp.asarray(env.bounds, jnp.float32), oracle))(keys)
        states, _ = jax.vmap(lambda s: solver.run(s, oracle, args.steps))(states)
        paths = jax.vmap(solver.full_trajectory)(states)
        return jax.vmap(lambda p: jax_evaluate_path(jax_circle_collision, oracle, p))(paths)

    t0 = time.perf_counter()
    collides, length = solve(jax.random.split(jax.random.PRNGKey(args.seed), args.problems))
    collides = np.asarray(collides)
    feasible = float((~collides).mean())
    print(json.dumps({
        "jax_holonomic": {
            "problems": args.problems, "steps": args.steps, "seed": args.seed,
            "feasible_fraction": feasible,
            "feasible_count": int((~collides).sum()),
            "mean_length_feasible": float(np.asarray(length)[~collides].mean()) if feasible else None,
            "seconds_cpu": time.perf_counter() - t0,
        }}))


if __name__ == "__main__":
    main()
