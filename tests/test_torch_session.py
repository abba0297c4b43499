"""The port's scripted replanning sessions (nfopp_tpu_torch.service.session)
against the JAX package's scanned sessions on the CPU.

- `advance_along_path`, batched in the port, against JAX's per row on 2- and
  3-wide paths with zero-length segments, a clamp at the end and dist 0
  (1e-6).
- The sessions' bookkeeping (poses fed, `reached`, path lengths, plans,
  retarget order, the sub-fleet split and merge) on a stand-in solver with
  the same deterministic motion on both sides (1e-6), and every ValueError.
- One real cycle of `replan_session` and of `fleet_replan_session`
  (group_size 2, B=4) on the small car scene (N=20, K=20, R=4, hidden 16)
  with JAX's draws replayed: a trajectory over 10 steps within atol 2e-3.
- Sub-fleets of `fleet_replan_session(subgroups=2)` equal independent
  sessions of their robots bit for bit, and the cases of
  tests/test_session.py and tests/test_dynamic_session.py on the port.
"""
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.service import advance_along_path as jax_advance
from nfopp_tpu.service import dynamic_replan_session as jax_dynamic_session
from nfopp_tpu.service import fleet_dynamic_session as jax_fleet_dynamic_session
from nfopp_tpu.service import fleet_replan_session as jax_fleet_session
from nfopp_tpu.service import replan_session as jax_replan_session
from nfopp_tpu.solver import ConstrainedSolver as JaxSolver
from nfopp_tpu.solver import run_planner_config as jax_run_planner_config
from nfopp_tpu.worlds import RectangleOracle as JaxRectangleOracle
from nfopp_tpu.worlds import rectangle_collision as jax_rectangle_collision
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.service import (
    advance_along_path,
    dynamic_replan_session,
    fleet_dynamic_session,
    fleet_replan_session,
    replan_session,
    subfleet_generators,
)
from nfopp_tpu_torch.solver import ConstrainedSolver, SolverConfig, state_from_jax
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    RectangleOracle,
    circle_collision,
    pad_obstacle_points,
    rectangle_collision,
    two_walls_se2_environment,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Long loops of small tensor ops: one intra-op thread, so that test
    workers sharing the cores do not spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------- advance_along_path

def random_paths(seed: int, batch: int, m: int, d: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    paths = np.cumsum(rng.normal(0.0, 0.3, (batch, m, d)), axis=1).astype(np.float32)
    paths[1, 3] = paths[1, 2]  # a zero-length segment
    paths[2, 4:7] = paths[2, 3]  # three in a row
    paths[3] = paths[3, 0]  # a path of one point
    paths[4, 1] = paths[4, 0]  # a zero-length first segment
    return paths


@pytest.mark.parametrize("d", [2, 3])
def test_advance_along_path_equals_jax_per_row(d):
    paths = random_paths(d, 6, 9, d)
    lengths = np.linalg.norm(np.diff(paths[..., :2], axis=1), axis=-1).sum(axis=1)
    cum = np.cumsum(np.linalg.norm(np.diff(paths[..., :2], axis=1), axis=-1), axis=1)
    for dist in (np.array([0.0, 0.7, 1.3, 0.2, 0.0, 50.0], np.float32),  # 0, mid, past the end
                 lengths.astype(np.float32),  # exactly the end
                 cum[:, 2].astype(np.float32)):  # exactly on a vertex
        got = advance_along_path(torch.tensor(paths), torch.tensor(dist)).numpy()
        assert got.shape == (6, d)
        for i in range(6):
            close(got[i], jax_advance(jnp.asarray(paths[i]), jnp.float32(dist[i])))
    got = advance_along_path(torch.tensor(paths), 0.45).numpy()  # one scalar for every row
    for i in range(6):
        close(got[i], jax_advance(jnp.asarray(paths[i]), jnp.float32(0.45)))


def test_advance_along_path_reference_cases():
    """tests/test_dynamic_session.py::TestAdvanceAlongPath on the port."""
    path = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.5], [1.0, 2.0, 1.0]]])
    got = advance_along_path(path, 1.5)[0].numpy()
    np.testing.assert_allclose(got[:2], [1.0, 0.5], atol=1e-6)
    assert abs(got[2] - 1.0) < 1e-6  # heading of the entered segment end
    got = advance_along_path(torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.3]]]), 5.0)[0]
    np.testing.assert_allclose(got[:2].numpy(), [1.0, 0.0], atol=1e-6)
    got = advance_along_path(torch.tensor([[[2.0, 3.0, 0.1], [4.0, 3.0, 0.2]]]), 0.0)[0]
    np.testing.assert_allclose(got[:2].numpy(), [2.0, 3.0], atol=1e-6)


# ------------------------------------------------ stand-in solvers (bookkeeping)

N = 6  # stand-in interior waypoints
W = np.linspace(1.0, 0.0, N, dtype=np.float32)[:, None]  # update_start's pull
T = np.linspace(0.0, 1.0, N + 2, dtype=np.float32)[1:-1, None]  # retarget's line


class Poses(NamedTuple):
    trajectory: object  # [(B,) N, 3]
    start: object
    goal: object
    step_count: object


class Obstacle(NamedTuple):
    center: object  # [(B,) 2]


class JaxStandIn:
    """Deterministic stand-in for the JAX solver: update_start pulls the
    trajectory's head towards the pose, retarget lays a straight line, and a
    burst of k steps pushes every waypoint away from the obstacle."""

    config = SimpleNamespace(reparametrize_trajectory_freq=10)

    def full_trajectory(self, s):
        return jnp.concatenate([s.start[None], s.trajectory, s.goal[None]], axis=0)

    def update_start(self, s, start):
        pulled = s.trajectory + jnp.asarray(W) * (start - s.trajectory[0])
        return s._replace(trajectory=pulled, start=start, step_count=jnp.int32(0))

    def retarget(self, s, start, goal):
        return s._replace(trajectory=start + (goal - start) * jnp.asarray(T), start=start,
                          goal=goal, step_count=jnp.int32(0))

    @staticmethod
    def _push(traj, center, steps):
        xy = traj[..., :2] + steps * 0.001 * (traj[..., :2] - center)
        theta = traj[..., 2:] + steps * 0.0005 * (traj[..., :1] - center[..., :1])
        return jnp.concatenate([xy, theta], axis=-1)

    def run(self, s, oracle, steps):
        return s._replace(trajectory=self._push(s.trajectory, oracle.center[None], steps),
                          step_count=s.step_count + steps), None

    def run_grouped(self, s, oracle, steps, group_size):
        return s._replace(trajectory=self._push(s.trajectory, oracle.center[:, None], steps),
                          step_count=s.step_count + steps), None


class StandIn:
    """The same stand-in for the port (batched); records every burst."""

    config = JaxStandIn.config

    def __init__(self):
        self.bursts = []  # (kind, batch, noise, first robot's start x)

    def full_trajectory(self, s):
        return torch.cat([s.start[:, None], s.trajectory, s.goal[:, None]], dim=1)

    def update_start(self, s, start):
        pulled = s.trajectory + torch.tensor(W) * (start[:, None] - s.trajectory[:, :1])
        return s._replace(trajectory=pulled, start=start, step_count=torch.zeros_like(s.step_count))

    def retarget(self, s, start, goal):
        return s._replace(trajectory=start[:, None] + (goal - start)[:, None] * torch.tensor(T),
                          start=start, goal=goal, step_count=torch.zeros_like(s.step_count))

    @staticmethod
    def _push(traj, center, steps):
        xy = traj[..., :2] + steps * 0.001 * (traj[..., :2] - center)
        theta = traj[..., 2:] + steps * 0.0005 * (traj[..., :1] - center[..., :1])
        return torch.cat([xy, theta], dim=-1)

    def _burst(self, kind, s, oracle, steps, noise):
        self.bursts.append((kind, s.start.shape[0], noise, float(s.start[0, 0])))
        return s._replace(trajectory=self._push(s.trajectory, oracle.center[:, None], steps),
                          step_count=s.step_count + steps), None

    def run(self, s, oracle, steps, noise):
        return self._burst("run", s, oracle, steps, noise)

    def run_grouped(self, s, oracle, steps, group_size, noise):
        return self._burst(("grouped", group_size), s, oracle, steps, noise)


def stand_in_states(batch: int, seed: int = 0):
    """(numpy Poses [B, ...]) of `batch` robots."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.5, 1.0, (batch, 3)).astype(np.float32)
    goal = rng.uniform(2.0, 2.5, (batch, 3)).astype(np.float32)
    traj = (start[:, None] + (goal - start)[:, None] * T
            + rng.normal(0.0, 0.05, (batch, N, 3))).astype(np.float32)
    return Poses(traj, start, goal, np.zeros(batch, np.int32))


def as_jax(tree, row=None):
    return tree_map_np(lambda x: jnp.asarray(x if row is None else x[row]), tree)


def as_torch(tree):
    return tree_map_np(torch.tensor, tree)


def tree_map_np(fn, tree):
    return type(tree)(*(fn(x) for x in tree))


def assert_states_close(got, want):
    for name, g, w in zip(got._fields, got, want):
        close(g.numpy(), w, tol=1e-6) if name != "step_count" else \
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_replan_session_bookkeeping_equals_jax():
    """Three goals (start and goal rows alternating) x 4 cycles of one robot."""
    states = stand_in_states(1)
    goals = np.stack([states.goal[0], states.start[0], states.goal[0] + 0.3])
    center = np.array([1.5, 1.4], np.float32)
    want, want_aux = jax_replan_session(JaxStandIn(), as_jax(states, 0), Obstacle(
        jnp.asarray(center)), jnp.asarray(goals), 4, 20)
    solver = StandIn()
    got, aux = replan_session(solver, as_torch(states), Obstacle(torch.tensor(center)[None]),
                              goals, 4, 20, "noise")
    assert tuple(aux.path_length.shape) == (3, 4) and tuple(aux.pose.shape) == (3, 4, 3)
    close(aux.path_length, want_aux.path_length)
    close(aux.pose, want_aux.pose)
    assert_states_close(got, tree_map_np(lambda x: np.asarray(x)[None], want))
    assert [b[:3] for b in solver.bursts] == [("run", 1, "noise")] * 12


@pytest.mark.parametrize("subgroups,shared_world", [(1, False), (2, False), (4, False),
                                                    (2, True)])
def test_fleet_replan_session_bookkeeping_equals_jax(subgroups, shared_world):
    """Eight robots, two goal rounds of distinct rows, 3 cycles each, group
    size 2; each robot its own obstacle (so a wrong split shows), or one
    shared world (leading axis 1) in the port."""
    r = 8
    states = stand_in_states(r, seed=1)
    rng = np.random.default_rng(2)
    goals = rng.uniform(0.0, 3.0, (2, r, 3)).astype(np.float32)
    centers = rng.uniform(1.0, 2.0, (r, 2)).astype(np.float32)
    if shared_world:
        centers[:] = centers[0]
    want, want_aux = jax_fleet_session(
        JaxStandIn(), as_jax(states), Obstacle(jnp.asarray(centers)), jnp.asarray(goals), 3, 10,
        group_size=2, subgroups=subgroups)
    solver = StandIn()
    oracle = Obstacle(torch.tensor(centers[:1] if shared_world else centers))
    noise = "noise" if subgroups == 1 else [f"noise{s}" for s in range(subgroups)]
    got, aux = fleet_replan_session(solver, as_torch(states), oracle, goals, 3, 10, 2, noise,
                                    subgroups=subgroups)
    assert tuple(aux.path_length.shape) == (2, 3, r) and tuple(aux.pose.shape) == (2, 3, r, 3)
    close(aux.path_length, want_aux.path_length)
    close(aux.pose, want_aux.pose)
    assert_states_close(got, want)
    np.testing.assert_array_equal(got.goal.numpy(), goals[-1])
    # each cycle steps the sub-fleets in order, each with its own source
    sub = r // subgroups
    sources = [noise] if subgroups == 1 else noise
    assert [b[:3] for b in solver.bursts] == [
        (("grouped", 2), sub, sources[s]) for _ in range(6) for s in range(subgroups)]


def line_states(starts, goals):
    """Stand-in robots on straight routes from `starts` to `goals`."""
    start, goal = np.asarray(starts, np.float32), np.asarray(goals, np.float32)
    traj = (start[:, None] + (goal - start)[:, None] * T).astype(np.float32)
    return Poses(traj, start, goal, np.zeros(len(start), np.int32))


def moving_centers(cycles: int) -> np.ndarray:
    c = np.arange(cycles, dtype=np.float32)
    return np.stack([np.full(cycles, 1.6, np.float32),
                     (0.5 + 1.2 * np.abs(np.sin(c * 0.3))).astype(np.float32)], axis=1)


def test_dynamic_session_bookkeeping_equals_jax():
    """One robot crossing a moving obstacle: reaches its goal, then freezes."""
    states = line_states([[0.5, 1.0, 0.0]], [[2.3, 1.1, 0.2]])
    goal = states.goal[0]
    xs = moving_centers(12)
    want, want_aux = jax_dynamic_session(
        JaxStandIn(), as_jax(states, 0), lambda c: Obstacle(c), jnp.asarray(xs),
        jnp.asarray(goal), 20, 0.3)
    got, aux = dynamic_replan_session(
        StandIn(), as_torch(states), lambda c: Obstacle(c[None]), torch.tensor(xs), goal, 20,
        0.3, "noise")
    reached = aux.reached.numpy()
    assert reached.shape == (12,) and reached[-1] and not reached[0]
    np.testing.assert_array_equal(reached, np.asarray(want_aux.reached))
    for name in ("pose", "path_length", "plan"):
        close(getattr(aux, name), getattr(want_aux, name))
    assert tuple(aux.plan.shape) == (12, N + 2, 3)
    assert_states_close(got, tree_map_np(lambda x: np.asarray(x)[None], want))


def test_fleet_dynamic_session_bookkeeping_equals_jax():
    """Four robots of different route lengths against one moving world: the
    short routes freeze first."""
    states = line_states([[0.5, 0.6, 0.0], [0.5, 1.4, 0.0], [2.6, 0.8, 3.1], [2.6, 1.6, 3.1]],
                         [[1.2, 0.7, 0.0], [1.3, 1.4, 0.0], [0.4, 0.9, 3.1], [0.4, 1.5, 3.1]])
    goals = states.goal
    xs = moving_centers(10)
    want, want_aux = jax_fleet_dynamic_session(
        JaxStandIn(), as_jax(states), lambda c: Obstacle(c), jnp.asarray(xs),
        jnp.asarray(goals), 10, 0.25, group_size=2)
    solver = StandIn()
    got, aux = fleet_dynamic_session(
        solver, as_torch(states), lambda c: Obstacle(c[None]), torch.tensor(xs), goals, 10, 0.25,
        2, "noise")
    reached = aux.reached.numpy()
    assert reached.shape == (10, 4) and reached[-1].all() and not reached[0].any()
    assert reached[:, :2].sum() > reached[:, 2:].sum()  # the short routes arrive first
    np.testing.assert_array_equal(reached, np.asarray(want_aux.reached))
    for name in ("pose", "path_length", "plan"):
        close(getattr(aux, name), getattr(want_aux, name))
    assert_states_close(got, want)
    assert {b[:3] for b in solver.bursts} == {(("grouped", 2), 4, "noise")}


def test_session_validations():
    """JAX's ValueErrors (tests/test_session.py), and the port's own two:
    one noise source per sub-fleet, and one robot in replan_session."""
    states = as_torch(stand_in_states(8))
    oracle = Obstacle(torch.zeros(1, 2))
    solver = StandIn()
    with pytest.raises(ValueError, match="multiple"):
        replan_session(solver, as_torch(stand_in_states(1)), oracle, np.zeros((1, 3)), 1, 7,
                       "noise")
    for session in (dynamic_replan_session, fleet_dynamic_session):
        with pytest.raises(ValueError, match="multiple"):
            session(solver, states, Obstacle, [], np.zeros(3), 15, 0.1, "noise", 0.2)
    goals = np.zeros((1, 8, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by subgroups"):
        fleet_replan_session(solver, states, oracle, goals, 1, 10, 1, ["a"] * 3, subgroups=3)
    with pytest.raises(ValueError, match="span sequential sub-batches"):
        fleet_replan_session(solver, states, oracle, goals, 1, 10, 4, ["a"] * 4, subgroups=4)
    with pytest.raises(ValueError, match="one noise source per sub-fleet"):
        fleet_replan_session(solver, states, oracle, goals, 1, 10, 2, "noise", subgroups=2)
    with pytest.raises(ValueError, match="one robot"):
        replan_session(solver, states, oracle, np.zeros((1, 3)), 1, 10, "noise")
    assert not solver.bursts


def test_subfleet_generators():
    gens = subfleet_generators(3, 2, "cpu")
    draws = [torch.rand(4, generator=g) for g in gens]
    assert torch.equal(draws[0], torch.rand(4, generator=torch.Generator().manual_seed(6)))
    assert torch.equal(draws[1], torch.rand(4, generator=torch.Generator().manual_seed(7)))


# ---------------------------------------------- one real cycle, JAX's draws

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


JCFG = jax_run_planner_config()._replace(trajectory_length=20, collision_point_count=20,
                                         random_field_points=4)
JCFG = JCFG._replace(onf=JCFG.onf._replace(hidden=16))
CFG = SolverConfig(**{**JCFG._asdict(), "onf": ONFConfig(**JCFG.onf._asdict())})
NR = CFG.trajectory_length


def step_draws(key):
    """One step's draws (constrained.py:316, field.py:70-87, :431)."""
    key, k_field, k_traj = jax.random.split(key, 3)
    k_uni, k_norm = jax.random.split(k_field, 2)
    cand = JCFG.collision_point_count + NR - 1
    u = jax.random.uniform(k_uni, ((NR - 1) + cand + JCFG.random_field_points * 3,),
                           jnp.float32)
    normal = jax.random.normal(k_norm, (2, NR - 1, 3), jnp.float32)
    t = jax.random.uniform(k_traj, (NR - 1, JCFG.collision_samples_per_segment), jnp.float32)
    return key, u, normal, t


def replay(keys, steps):
    noise = ReplayNoise()
    for _ in range(steps):
        keys, u, normal, t = jax.vmap(step_draws)(keys)
        noise.push("uniform", u)
        noise.push("normal", normal)
        noise.push("uniform", t)
    return noise


@pytest.fixture(scope="module")
def car():
    from nfopp_tpu.worlds import car_environment

    env = car_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 64)
    box = np.array([-0.3, 0.2, -0.3, 0.2], np.float32)
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    jax_oracle = JaxRectangleOracle(*(jnp.asarray(a) for a in (pts, mask, box, bounds)))
    oracle = RectangleOracle(*(torch.tensor(a)[None] for a in (pts, mask, box, bounds)))
    return SimpleNamespace(env=env, jax_oracle=jax_oracle, oracle=oracle,
                           jax_solver=JaxSolver(JCFG, jax_rectangle_collision),
                           solver=ConstrainedSolver(CFG, rectangle_collision, device="cpu"))


def jax_states(car, batch: int, group_size: int = 1):
    env = car.env
    k_problems, k_fields = jax.random.split(jax.random.PRNGKey(5))
    keys = jax.random.split(k_problems, batch)
    field_keys = jnp.repeat(jax.random.split(k_fields, batch // group_size), group_size, axis=0)
    return jax.jit(jax.vmap(lambda k, f: car.jax_solver.init_state(
        k, jnp.asarray(env.start), jnp.asarray(env.goal), jnp.asarray(env.bounds, jnp.float32),
        car.jax_oracle, field_key=f)))(keys, field_keys)


def to_port(states):
    return state_from_jax(jax.tree_util.tree_map(np.asarray, states), device="cpu")


def test_one_real_replan_cycle_matches_jax(car):
    """retarget to the goal from path[3], update_start, 10 steps."""
    states = jax_states(car, 1)
    goals = np.asarray(car.env.goal, np.float32)[None]
    want, want_aux = jax.jit(lambda s: jax_replan_session(
        car.jax_solver, s, car.jax_oracle, jnp.asarray(goals), 1, 10))(
        jax.tree_util.tree_map(lambda x: x[0], states))
    noise = replay(states.key, 10)
    got, aux = replan_session(car.solver, to_port(states), car.oracle, goals, 1, 10, noise)
    assert not noise.queue
    close(aux.pose, want_aux.pose)
    np.testing.assert_allclose(got.trajectory[0].numpy(), np.asarray(want.trajectory), atol=2e-3)
    np.testing.assert_allclose(aux.path_length.numpy(), np.asarray(want_aux.path_length),
                               atol=2e-3)
    np.testing.assert_array_equal(got.goal[0].numpy(), np.asarray(want.goal))
    close(got.start[0], want.start)
    assert int(got.step_count[0]) == int(want.step_count) == 10


def test_one_real_fleet_cycle_matches_jax(car):
    """Four robots in two shared-field groups, alternating goal rows."""
    states = jax_states(car, 4, group_size=2)
    env = car.env
    goals = np.stack([np.stack([env.goal, env.start, env.goal, env.start])]).astype(np.float32)
    oracles = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (4,) + (1,) * x.ndim),
                                     car.jax_oracle)
    want, want_aux = jax.jit(lambda s: jax_fleet_session(
        car.jax_solver, s, oracles, jnp.asarray(goals), 1, 10, group_size=2))(states)
    noise = replay(states.key, 10)
    got, aux = fleet_replan_session(car.solver, to_port(states), car.oracle, goals, 1, 10, 2,
                                    noise)
    assert not noise.queue
    close(aux.pose, want_aux.pose)
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(want.trajectory), atol=2e-3)
    np.testing.assert_allclose(aux.path_length.numpy(), np.asarray(want_aux.path_length),
                               atol=2e-3)
    np.testing.assert_array_equal(got.goal.numpy(), np.asarray(want.goal))
    for leaf in tree_leaves(got.field_params):  # the groups' replicas in lockstep
        assert torch.equal(leaf[0], leaf[1]) and torch.equal(leaf[2], leaf[3])


# ------------------------------------------ the port's sessions on the CPU

SCFG = SolverConfig(trajectory_length=12, collision_point_count=12, random_field_points=4,
                    onf=ONFConfig(angle_encoding=True, hidden=16), angle_offset=0.3)


def two_walls(batch: int, group_size: int = 1, seed: int = 0):
    """tests/test_session.py's scene and config (hidden 16): (solver, states,
    oracle, env)."""
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    oracle = CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], torch.tensor([0.3]),
                          torch.tensor([[0.0, 3.0, 0.0, 3.0]]))
    solver = ConstrainedSolver(SCFG, circle_collision, device="cpu")

    def tile(a):
        return np.tile(np.asarray(a, np.float32)[None], (batch, 1))

    states = solver.init_state(torch.Generator().manual_seed(seed), tile(env.start),
                               tile(env.goal), tile(env.bounds), oracle, group_size=group_size)
    return solver, states, oracle, env


def test_one_cycle_matches_manual_sequence():
    solver, state, oracle, env = two_walls(1)
    goals = np.asarray(env.goal, np.float32)[None]
    out, aux = replan_session(solver, state, oracle, goals, 1, 10, torch.Generator().manual_seed(1))
    path = solver.full_trajectory(state)
    st = solver.retarget(state, path[:, 3], goals)
    pose = solver.full_trajectory(st)[:, 3]
    st = solver.update_start(st, pose)
    st, _ = solver.run(st, oracle, 10, torch.Generator().manual_seed(1))
    assert torch.equal(out.trajectory, st.trajectory)
    assert tuple(aux.path_length.shape) == (1, 1)
    assert torch.equal(aux.pose[0, 0], pose[0])


def test_session_tracks_pose_and_pins_goal():
    solver, state, oracle, env = two_walls(1)
    goals = np.stack([env.goal, env.start]).astype(np.float32)
    out, aux = replan_session(solver, state, oracle, goals, 5, 10, torch.Generator().manual_seed(2))
    assert tuple(aux.path_length.shape) == (2, 5)
    assert torch.isfinite(aux.path_length).all()
    final = solver.full_trajectory(out)[0].numpy()
    np.testing.assert_allclose(final[-1], env.start, atol=1e-6)
    poses = aux.pose.reshape(-1, 3).numpy()
    assert np.linalg.norm(poses[1:, :2] - poses[:-1, :2], axis=1).max() > 1e-4


def test_fleet_session_lockstep_and_shapes():
    solver, states, oracle, env = two_walls(4, group_size=4)
    goal, start = (np.asarray(a, np.float32) for a in (env.goal, env.start))
    goals = np.stack([np.stack([goal, goal, start, start])])
    out, aux = fleet_replan_session(solver, states, oracle, goals, 3, 10, 4,
                                    torch.Generator().manual_seed(3))
    assert tuple(aux.path_length.shape) == (1, 3, 4)
    paths = solver.full_trajectory(out).numpy()
    np.testing.assert_allclose(paths[0, -1], goal, atol=1e-6)
    np.testing.assert_allclose(paths[2, -1], start, atol=1e-6)
    assert np.isfinite(paths).all()
    for leaf in tree_leaves(out.field_params):
        assert torch.equal(leaf[0], leaf[3])


def test_subgroups_equal_independent_subfleet_sessions_bit_for_bit():
    """subgroups=2 is a schedule: each sub-fleet equals an independent
    session of its robots with its own noise source, bit for bit."""
    solver, states, oracle, env = two_walls(8, group_size=2, seed=4)
    goal, start = (np.asarray(a, np.float32) for a in (env.goal, env.start))
    row = np.stack([goal if i % 2 == 0 else start for i in range(8)])
    goals = np.stack([row, row[::-1]])
    out, aux = fleet_replan_session(solver, states, oracle, goals, 2, 10, 2,
                                    subfleet_generators(9, 2, "cpu"), subgroups=2)
    assert tuple(aux.path_length.shape) == (2, 2, 8)
    for s, rows in enumerate((slice(0, 4), slice(4, 8))):
        ref, ref_aux = fleet_replan_session(
            solver, tree_map(lambda x: x[rows], states), oracle, goals[:, rows], 2, 10, 2,
            torch.Generator().manual_seed(9 * 2 + s))
        for a, b in zip(tree_leaves(ref), tree_leaves(tree_map(lambda x: x[rows], out))):
            assert torch.equal(a, b)
        assert torch.equal(aux.path_length[:, :, rows], ref_aux.path_length)
        assert torch.equal(aux.pose[:, :, rows], ref_aux.pose)


def disc_script(cycles: int):
    """tests/test_dynamic_session.py's bobbing disc: (builder, xs, bounds)."""
    bounds = torch.tensor([[0.0, 4.0, 0.0, 2.0]])
    capacity = 8
    mask = torch.zeros((1, capacity), dtype=torch.bool)
    mask[0, :4] = True
    xs = np.full((cycles, capacity, 2), 1e9, np.float32)
    for c in range(cycles):
        y = 0.4 + 1.2 * abs(np.sin(c * 0.2))
        xs[c, :4] = [[2.0, y], [2.1, y], [2.0, y + 0.1], [1.9, y]]

    def builder(points_t):
        return CircleOracle(points_t[None], mask, torch.tensor([0.2]), bounds)

    return builder, torch.tensor(xs), bounds


def test_moving_obstacle_session_runs_and_freezes_at_goal():
    solver = ConstrainedSolver(SCFG._replace(trajectory_length=16, collision_point_count=16),
                               circle_collision, device="cpu")
    builder, xs, bounds = disc_script(40)
    start = np.array([[0.3, 1.0, 0.0]], np.float32)
    goal = np.array([3.7, 1.0, 0.0], np.float32)
    state = solver.init_state(torch.Generator().manual_seed(0), start, goal[None],
                              bounds.numpy(), builder(xs[0]))
    _, aux = dynamic_replan_session(solver, state, builder, xs, goal, 10, 0.15,
                                    torch.Generator().manual_seed(1))
    poses = aux.pose.numpy()
    assert poses.shape == (40, 3) and np.isfinite(poses).all()
    assert tuple(aux.plan.shape) == (40, 18, 3)
    reached = aux.reached.numpy()
    assert reached[-1]  # 40 cycles x 0.15 = 6.0 > 3.4 route: must reach, then freeze
    k = int(np.argmax(reached))
    frozen = poses[k + 1:]
    if len(frozen):
        np.testing.assert_allclose(frozen, np.tile(frozen[0], (len(frozen), 1)), atol=1e-5)
    assert np.linalg.norm(poses[k, :2] - goal[:2]) < 0.2 + 0.16


def test_session_is_deterministic_and_fleet_of_one_matches():
    """The same state, script and seed give bit-identical traces; a fleet of
    one with group_size=1 reproduces the single-robot session bit for bit
    (run_grouped with groups of one is `run`, drawing the same noise)."""
    solver, _, _, _ = two_walls(1)
    builder, xs, bounds = disc_script(10)
    start = np.array([[0.3, 1.0, 0.0]], np.float32)
    goal = np.array([3.7, 1.0, 0.0], np.float32)
    state = solver.init_state(torch.Generator().manual_seed(3), start, goal[None],
                              bounds.numpy(), builder(xs[0]))
    runs = [dynamic_replan_session(solver, state, builder, xs, goal, 10, 0.15,
                                   torch.Generator().manual_seed(4))[1] for _ in range(2)]
    _, fleet = fleet_dynamic_session(solver, state, builder, xs, goal[None], 10, 0.15, 1,
                                     torch.Generator().manual_seed(4))
    for name in runs[0]._fields:
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
        assert torch.equal(getattr(fleet, name)[:, 0], getattr(runs[0], name))


def test_fleet_dynamic_runs_and_freezes():
    """4 robots, crossing routes, shared moving world, one shared field."""
    solver, _, _, _ = two_walls(1)
    builder, xs, bounds = disc_script(12)
    starts = np.array([[0.3, 0.6, 0.0], [0.3, 1.4, 0.0], [3.7, 0.6, 3.14], [3.7, 1.4, 3.14]],
                      np.float32)
    goals = np.array([[3.7, 0.6, 0.0], [3.7, 1.4, 0.0], [0.3, 0.6, 3.14], [0.3, 1.4, 3.14]],
                     np.float32)
    states = solver.init_state(torch.Generator().manual_seed(1), starts, goals,
                               np.tile(bounds.numpy(), (4, 1)), builder(xs[0]), group_size=4)
    out, aux = fleet_dynamic_session(solver, states, builder, xs, goals, 10, 0.4, 4,
                                     torch.Generator().manual_seed(2))
    assert tuple(aux.pose.shape) == (12, 4, 3)
    assert torch.isfinite(aux.pose).all() and torch.isfinite(aux.path_length).all()
    assert aux.reached[-1].all()  # 12 cycles x 0.4 = 4.8 > 3.4 route
    for leaf in tree_leaves(out.field_params):
        assert torch.equal(leaf[0], leaf[-1])  # shared-field lockstep
