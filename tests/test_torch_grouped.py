"""The port's shared-field group mode (ConstrainedSolver.init_state(group_size)
and run_grouped) and set_boundaries, against the JAX package, with JAX's own
random draws handed to the port; and the group mode's own guarantees:
group_size=1 is `run` bit for bit, replicas stay bit-identical within a group
and distinct across groups, and the validations of
tests/test_shared_field.py:54-162 that need no BatchPlanner or mesh.

Scene: the SE(2) two-walls scene with a disc robot (circle oracle, radius
0.3); config of tests/test_shared_field.py:27-50 (N=12, K=12, R=4,
angle-encoded field) at hidden 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.solver import ConstrainedSolver as JaxSolver
from nfopp_tpu.solver import SolverConfig as JaxSolverConfig
from nfopp_tpu.worlds import CircleOracle as JaxCircleOracle
from nfopp_tpu.worlds import circle_collision as jax_circle_collision
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.solver import ConstrainedSolver, SolverConfig, state_from_jax
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    circle_collision,
    pad_obstacle_points,
    two_walls_se2_environment,
)

JCFG = JaxSolverConfig(
    trajectory_length=12, collision_point_count=12, random_field_points=4,
    onf=JaxONFConfig(angle_encoding=True, hidden=16), angle_offset=0.3,
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
    """One step's draws (constrained.py:596, field.py:70-87, :431)."""
    key, k_field, k_traj = jax.random.split(key, 3)
    k_uni, k_norm = jax.random.split(k_field, 2)
    cand = JCFG.collision_point_count + N - 1
    u = jax.random.uniform(k_uni, ((N - 1) + cand + JCFG.random_field_points * 3,), jnp.float32)
    normal = jax.random.normal(k_norm, (2, N - 1, 3), jnp.float32)
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


def setup(batch, radius=None, cfg=CFG):
    """(solver, starts, goals, bounds, oracle) of `batch` copies of the
    scene; `radius` [B] gives each problem its own disc."""
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    radius = torch.full((1,), 0.3) if radius is None else torch.tensor(radius, dtype=torch.float32)
    oracle = CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], radius,
                          torch.tensor([[0.0, 3.0, 0.0, 3.0]]))

    def tile(a):
        return np.tile(np.asarray(a, np.float32)[None], (batch, 1))

    solver = ConstrainedSolver(cfg, circle_collision, device="cpu")
    return solver, tile(env.start), tile(env.goal), tile(env.bounds), oracle


def field_leaves(state):
    return tree_leaves((state.field_params, state.field_opt_state))


def assert_lockstep(state, group_size):
    """Field leaves bit-identical within each group, distinct across."""
    for leaf in field_leaves(state):
        grouped = leaf.reshape((-1, group_size) + tuple(leaf.shape[1:]))
        assert torch.equal(grouped, grouped[:, :1].expand_as(grouped))
    params = tree_leaves(state.field_params)
    assert all(not torch.equal(p[0], p[group_size]) for p in params)


def test_run_grouped_matches_jax():
    """10 steps of 4 problems in groups of 2 from JAX-initialised grouped
    states (one field_key per group), trajectory atol 2e-3."""
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    jax_oracle = JaxCircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.3),
                                 jnp.asarray([0.0, 3.0, 0.0, 3.0], jnp.float32))
    jax_solver = JaxSolver(JCFG, jax_circle_collision)
    k_problems, k_fields = jax.random.split(jax.random.PRNGKey(1))
    keys = jax.random.split(k_problems, 4)
    field_keys = jnp.repeat(jax.random.split(k_fields, 2), 2, axis=0)
    states = jax.jit(jax.vmap(lambda k, f: jax_solver.init_state(
        k, jnp.asarray(env.start), jnp.asarray(env.goal), jnp.asarray(env.bounds, jnp.float32),
        jax_oracle, field_key=f)))(keys, field_keys)
    oracles = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (4,) + (1,) * x.ndim),
                                     jax_oracle)
    ref, ref_aux = jax.jit(lambda s: jax_solver.run_grouped(s, oracles, 10, 2))(states)

    solver, _, _, _, oracle = setup(4)
    noise = replay(states.key, 10)
    start = state_from_jax(jax.tree_util.tree_map(np.asarray, states), device="cpu")
    got, aux = solver.run_grouped(start, oracle, 10, 2, noise)
    assert not noise.queue
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(ref.step_count))
    assert tuple(aux.field_loss.shape) == tuple(ref_aux.field_loss.shape) == (4, 10)
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(ref_aux.field_loss), rtol=1e-3)
    assert_lockstep(got, 2)


@pytest.mark.parametrize("field_freq", [1, 2])
def test_group_size_one_equals_run(field_freq):
    """group_size=1 is `run` bit for bit (the same noise, the same mean of
    one), with the field trained every step or every second step."""
    cfg = CFG._replace(optimize_collision_model_freq=field_freq)
    solver, starts, goals, bounds, oracle = setup(4, cfg=cfg)
    state = solver.init_state(torch.Generator().manual_seed(2), starts, goals, bounds, oracle)
    ref, ref_aux = solver.run(state, oracle, 10, torch.Generator().manual_seed(3))
    got, aux = solver.run_grouped(state, oracle, 10, 1, torch.Generator().manual_seed(3))
    for a, b in zip(tree_leaves((got, aux)), tree_leaves((ref, ref_aux))):
        assert torch.equal(a, b)


def test_init_fields_identical_within_group_distinct_across():
    """init_state(group_size=4): one field init and one pretraining per
    group (3 pretraining iterations), each problem its own replay buffer."""
    solver, starts, goals, bounds, oracle = setup(
        8, cfg=CFG._replace(init_collision_iteration=3))
    state = solver.init_state(torch.Generator().manual_seed(0), starts, goals, bounds, oracle,
                              group_size=4)
    assert_lockstep(state, 4)
    assert state.field_opt_state.count.tolist() == [3] * 8
    assert not torch.equal(state.buffer_points[0], state.buffer_points[1])


def test_grouped_init_with_group_size_one_is_the_plain_init():
    solver, starts, goals, bounds, oracle = setup(4, cfg=CFG._replace(init_collision_iteration=2))
    a = solver.init_state(torch.Generator().manual_seed(5), starts, goals, bounds, oracle)
    b = solver.init_state(torch.Generator().manual_seed(5), starts, goals, bounds, oracle,
                          group_size=1)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_lockstep_and_divergence():
    """20 steps in groups of 4: fields and their Adam states stay bit-identical
    within each group, distinct across; trajectories stay per problem."""
    solver, starts, goals, bounds, oracle = setup(8)
    g = torch.Generator().manual_seed(1)
    state = solver.init_state(g, starts, goals, bounds, oracle, group_size=4)
    state, aux = solver.run_grouped(state, oracle, 20, 4, g)
    assert_lockstep(state, 4)
    assert not torch.allclose(state.trajectory[0], state.trajectory[1])
    assert torch.isfinite(state.trajectory).all()
    assert tuple(aux.trajectory_loss.shape) == (8, 20)


def test_batch_not_divisible_raises():
    solver, starts, goals, bounds, oracle = setup(6)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="divisible"):
        solver.init_state(g, starts, goals, bounds, oracle, group_size=4)
    state = solver.init_state(g, starts, goals, bounds, oracle)
    with pytest.raises(ValueError, match="divisible"):
        solver.run_grouped(state, oracle, 10, 4, g)


@pytest.mark.parametrize("leaf", ["radius", "bounds"])
def test_mixed_worlds_in_group_raises(leaf):
    """Problem 1 gets another world (its own disc, or its own bounds)."""
    radius = [0.3] * 8
    if leaf == "radius":
        radius[1] = 0.5
    solver, starts, goals, bounds, oracle = setup(8, radius=radius)
    if leaf == "bounds":
        bounds[1, 1] = 3.0
    with pytest.raises(ValueError, match="share one map"):
        solver.init_state(torch.Generator().manual_seed(0), starts, goals, bounds, oracle,
                          group_size=4)
    # groups of 1 (no sharing) take any worlds
    solver.init_state(torch.Generator().manual_seed(0), starts, goals, bounds, oracle)


def test_run_grouped_validations():
    solver, starts, goals, bounds, oracle = setup(4)
    with pytest.raises(ValueError, match="reparametrize"):
        solver.run_grouped(None, None, 7, 2, None)
    odd = ConstrainedSolver(CFG._replace(optimize_collision_model_freq=3), circle_collision,
                            device="cpu")
    state = odd.init_state(torch.Generator().manual_seed(0), starts, goals, bounds, oracle)
    with pytest.raises(NotImplementedError, match="shared-field"):
        odd.run_grouped(state, oracle, 10, 2, torch.Generator())


def test_set_boundaries_matches_jax():
    """New bounds, the schedule reset (constrained.py:673-676)."""
    solver, starts, goals, bounds, oracle = setup(2)
    g = torch.Generator().manual_seed(0)
    state, _ = solver.run(solver.init_state(g, starts, goals, bounds, oracle), oracle, 5, g)
    new = np.array([[0.0, 4.0, 0.0, 4.0], [-1.0, 3.0, 0.5, 2.5]], np.float32)
    got = solver.set_boundaries(state, new)
    jax_solver = JaxSolver(JCFG, jax_circle_collision)
    ref = jax.vmap(jax_solver.set_boundaries)(
        jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), state._replace(
            field_params=None, field_opt_state=None, traj_opt_state=None)), jnp.asarray(new))
    np.testing.assert_array_equal(got.bounds.numpy(), np.asarray(ref.bounds))
    np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(ref.step_count))
    assert state.step_count.tolist() == [5, 5] and got.step_count.dtype == torch.int32
    assert torch.equal(got.trajectory, state.trajectory)
