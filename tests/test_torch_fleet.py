"""The port's fleet replanning service (nfopp_tpu_torch.service.fleet) and
`retarget` on the CPU, against the JAX package's service.

- The service's bookkeeping against JAX's `FleetReplanningService`, both on a
  stand-in solver with the same deterministic motion: starts, goals, active
  lanes, world rows and returned paths after each set_goal,
  update_robot_pose, replan_cycle, update_world(group) and stop (1e-6), in
  shared-field and independent-field mode.
- One real grouped cycle of both services (B=4, group_size 2, small car
  scene: N=20, K=20, R=4, hidden 16) with JAX's draws replayed: the
  retargets at 1e-6, the cycle's trajectories within atol 2e-3.
- tests/test_fleet.py's cases mirrored on the port, with every ValueError,
  and the service's own invariants — the first goal initializes every lane
  at its pose (grouped init, start = goal = pose), a retarget writes only its
  lane (fields untouched, so group replicas stay bit-identical),
  update_start reaches only the active lanes, per-group worlds land on their
  rows, and one seed gives the same cycles bit for bit.

Scene of the mirrored cases: the car scene with a disc robot (circle oracle,
radius 0.1), N=16, K=16, R=4, angle-encoded field at hidden 16
(tests/test_fleet.py's config, narrowed).
"""
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.service import FleetReplanningService as JaxFleetReplanningService
from nfopp_tpu.service import PathPostprocessor as JaxPathPostprocessor
from nfopp_tpu.solver import ConstrainedSolver as JaxSolver
from nfopp_tpu.solver import run_planner_config as jax_run_planner_config
from nfopp_tpu.worlds import RectangleOracle as JaxRectangleOracle
from nfopp_tpu.worlds import rectangle_collision as jax_rectangle_collision
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.service import FleetReplanningService, PathPostprocessor
from nfopp_tpu_torch.solver import ConstrainedSolver, SolverConfig, state_from_jax
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    RectangleOracle,
    car_environment,
    circle_collision,
    pad_obstacle_points,
    rectangle_collision,
)
from torch_threads import one_thread  # noqa: F401


def car_oracle_solver(trajectory_length=16, init_collision_iteration=0):
    env = car_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 64)
    oracle = CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], torch.tensor([0.1]),
                          torch.tensor(np.asarray(env.bounds, np.float32))[None])
    cfg = SolverConfig(
        trajectory_length=trajectory_length, collision_point_count=16,
        random_field_points=4, onf=ONFConfig(angle_encoding=True, hidden=16),
        angle_offset=0.3, init_collision_iteration=init_collision_iteration,
    )
    return env, oracle, ConstrainedSolver(cfg, circle_collision, device="cpu")


def field(svc):
    return tree_leaves((svc._states.field_params, svc._states.field_opt_state))


# ------------------------------------ against JAX's service (stand-in solver)

N = 6  # stand-in interior waypoints
W = np.linspace(1.0, 0.0, N, dtype=np.float32)[:, None]  # update_start's pull
T = np.linspace(0.0, 1.0, N + 2, dtype=np.float32)[1:-1, None]  # retarget's line


class Lane(NamedTuple):
    trajectory: object  # [(B,) N, 3]
    start: object
    goal: object
    step_count: object
    field: object  # [(B,) 2]: shared within a field group


class Obstacle(NamedTuple):
    center: object  # [(B,) 2]


class Aux(NamedTuple):
    trajectory_loss: object  # [(B,) steps]


class JaxStandIn:
    """Deterministic stand-in for the JAX solver (per problem, as
    BatchPlanner vmaps it): init lays a straight line and puts the field at
    the world's obstacle, update_start pulls the trajectory's head to the
    pose, retarget lays a new line and keeps the field, and a burst pushes
    the waypoints away from the obstacle and the field while the field
    drifts to the mean waypoint (of its group, in run_grouped)."""

    config = SimpleNamespace(reparametrize_trajectory_freq=5)

    def init_state(self, key, start, goal, bounds, oracle, trajectory=None, field_key=None):
        return Lane(start + (goal - start) * jnp.asarray(T), start, goal, jnp.int32(0),
                    oracle.center + 0.1 * bounds[:2])

    def full_trajectory(self, s):
        return jnp.concatenate([s.start[None], s.trajectory, s.goal[None]], axis=0)

    def update_start(self, s, start):
        pulled = s.trajectory + jnp.asarray(W) * (start - s.trajectory[0])
        return s._replace(trajectory=pulled, start=start, step_count=jnp.int32(0))

    def retarget(self, s, start, goal):
        return s._replace(trajectory=start + (goal - start) * jnp.asarray(T), start=start,
                          goal=goal, step_count=jnp.int32(0))

    @staticmethod
    def _push(traj, center, field, steps):
        away = 0.5 * (center + field)
        xy = traj[..., :2] + steps * 0.001 * (traj[..., :2] - away)
        theta = traj[..., 2:] + steps * 0.0005 * (traj[..., :1] - away[..., :1])
        return jnp.concatenate([xy, theta], axis=-1)

    def run(self, s, oracle, steps):
        traj = self._push(s.trajectory, oracle.center, s.field, steps)
        field = s.field + steps * 0.002 * (jnp.mean(traj[:, :2], axis=0) - s.field)
        return (s._replace(trajectory=traj, field=field, step_count=s.step_count + steps),
                Aux(jnp.full((steps,), 1.0)))

    def run_grouped(self, s, oracle, steps, group_size):
        traj = self._push(s.trajectory, oracle.center[:, None], s.field[:, None], steps)
        mean = jnp.mean(traj[..., :2], axis=1).reshape(-1, group_size, 2).mean(axis=1)
        field = s.field + steps * 0.002 * (jnp.repeat(mean, group_size, axis=0) - s.field)
        return (s._replace(trajectory=traj, field=field, step_count=s.step_count + steps),
                Aux(jnp.full((s.start.shape[0], steps), 1.0)))


class StandIn:
    """The same stand-in for the port (batched); records every init and
    burst."""

    config = JaxStandIn.config
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def init_state(self, generator, start, goal, bounds, oracle, trajectory=None,
                   group_size=None):
        self.calls.append(("init", group_size))
        return Lane(start[:, None] + (goal - start)[:, None] * torch.tensor(T), start, goal,
                    torch.zeros(start.shape[0], dtype=torch.int32),
                    oracle.center + 0.1 * bounds[:, :2])

    def full_trajectory(self, s):
        return torch.cat([s.start[:, None], s.trajectory, s.goal[:, None]], dim=1)

    def update_start(self, s, start):
        pulled = s.trajectory + torch.tensor(W) * (start[:, None] - s.trajectory[:, :1])
        return s._replace(trajectory=pulled, start=start,
                          step_count=torch.zeros_like(s.step_count))

    def retarget(self, s, start, goal):
        start, goal = (torch.as_tensor(np.asarray(a, np.float32)) for a in (start, goal))
        return s._replace(trajectory=start[:, None] + (goal - start)[:, None] * torch.tensor(T),
                          start=start, goal=goal, step_count=torch.zeros_like(s.step_count))

    @staticmethod
    def _push(traj, center, field, steps):
        away = 0.5 * (center + field)
        xy = traj[..., :2] + steps * 0.001 * (traj[..., :2] - away)
        theta = traj[..., 2:] + steps * 0.0005 * (traj[..., :1] - away[..., :1])
        return torch.cat([xy, theta], dim=-1)

    def _burst(self, kind, s, oracle, steps, noise, group_size):
        self.calls.append((kind, steps, noise))
        traj = self._push(s.trajectory, oracle.center[:, None], s.field[:, None], steps)
        mean = torch.mean(traj[..., :2], dim=1)
        mean = mean.reshape(-1, group_size, 2).mean(dim=1).repeat_interleave(group_size, dim=0)
        field = s.field + steps * 0.002 * (mean - s.field)
        return (s._replace(trajectory=traj, field=field, step_count=s.step_count + steps),
                Aux(torch.ones(s.start.shape[0], steps)))

    def run(self, s, oracle, steps, noise):
        return self._burst("run", s, oracle, steps, noise, 1)

    def run_grouped(self, s, oracle, steps, group_size, noise):
        return self._burst(("grouped", group_size), s, oracle, steps, noise, group_size)


BOUNDS = np.array([0.0, 3.0, 0.0, 3.0], np.float32)


def assert_services_agree(got, want, result, want_result):
    """The port's service `got` against JAX's `want` after one operation:
    its result, the lanes' flags and poses, the world rows and every state
    leaf (1e-6)."""
    if isinstance(want_result, dict):
        assert sorted(result) == sorted(want_result)
        for robot in want_result:
            np.testing.assert_allclose(result[robot], want_result[robot], rtol=1e-6, atol=1e-6)
    else:
        assert result == want_result
    np.testing.assert_array_equal(got._active, want._active)
    np.testing.assert_array_equal(got._has_pose, want._has_pose)
    np.testing.assert_array_equal(got._poses, want._poses)
    np.testing.assert_array_equal(got._oracles.center.numpy(), np.asarray(want._oracles.center))
    assert (got._states is None) == (want._states is None)
    if want._states is not None:
        for name, g, w in zip(Lane._fields, got._states, want._states):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("shared_field", [True, False])
def test_service_bookkeeping_equals_jax(shared_field):
    """Four robots through one script of poses, goals, cycles, world
    updates and a stop, on both services; planning_timeout 0 runs one chunk
    per cycle on both."""
    kwargs = (dict(group_size=2) if shared_field else dict(shared_field=False, steps_per_chunk=3))
    world = np.array([1.5, 1.4], np.float32)
    want = JaxFleetReplanningService(JaxStandIn(), 4, BOUNDS, Obstacle(jnp.asarray(world)),
                                     planning_timeout=0.0,
                                     postprocessor=JaxPathPostprocessor(), **kwargs)
    solver = StandIn()
    got = FleetReplanningService(solver, 4, BOUNDS, Obstacle(torch.tensor(world)[None]),
                                 planning_timeout=0.0, postprocessor=PathPostprocessor(), **kwargs)
    rng = np.random.default_rng(7)

    def pose():
        return rng.uniform(0.2, 2.8, 3).astype(np.float32)

    goal = pose
    script = [  # without shared fields the fleet is one group: update the whole world
        ("update_world", np.array([1.2, 1.9], np.float32), 1 if shared_field else None),
        ("update_robot_pose", 0, pose()), ("update_robot_pose", 1, pose()),
        ("update_robot_pose", 2, pose()),
        ("set_goal", 3, goal()),  # no pose yet: refused
        ("replan_cycle",),  # no goal yet: idle
        ("set_goal", 0, goal()),  # first goal: the batch init, then lane 0
        ("set_goal", 2, goal()),
        ("replan_cycle",), ("replan_cycle",),
        ("update_robot_pose", 0, pose()), ("update_robot_pose", 1, pose()),  # 1 inactive
        ("replan_cycle",),
        ("set_goal", 1, goal()), ("set_goal", 0, goal()),  # retarget midway
        ("update_world", np.array([1.7, 1.1], np.float32), 0 if shared_field else None),
        ("replan_cycle",),
        ("stop", 2),
        ("replan_cycle",),
        ("update_robot_pose", 3, pose()), ("set_goal", 3, goal()),
        ("update_robot_pose", 2, pose()),  # stopped: its start stays
        ("replan_cycle",),
        ("stop", 0), ("stop", 1), ("stop", 3),
        ("replan_cycle",),
    ]
    for op, *args in script:
        if op == "update_world":
            center, group = args
            want_result = want.update_world(Obstacle(jnp.asarray(center)), group=group)
            result = got.update_world(Obstacle(torch.tensor(center)[None]), group=group)
        else:
            want_result = getattr(want, op)(*args)
            result = getattr(got, op)(*args)
        assert_services_agree(got, want, result, want_result)
    bursts = [c for c in solver.calls if c[0] != "init"]
    kind = ("grouped", 2) if shared_field else "run"
    assert solver.calls[0] == ("init", 2 if shared_field else None)
    assert bursts == [(kind, got.steps_per_chunk, got._noise)] * 6
    assert int(got._states.step_count[2]) > int(got._states.step_count[3])  # 2 stopped


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


def to_port(states):
    return state_from_jax(jax.tree_util.tree_map(np.asarray, states), device="cpu")


def test_one_real_grouped_cycle_matches_jax():
    """Four robots in two shared-field groups on the small car scene: JAX's
    batch init is handed to the port, both services retarget every lane
    (1e-6), move two robots, and run one grouped cycle of
    reparametrize_trajectory_freq steps with JAX's draws replayed (atol
    2e-3); the port's group replicas stay bit-identical."""
    env = car_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 64)
    box = np.array([-0.3, 0.2, -0.3, 0.2], np.float32)
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    want = JaxFleetReplanningService(
        JaxSolver(JCFG, jax_rectangle_collision), 4, env.bounds,
        JaxRectangleOracle(*(jnp.asarray(a) for a in (pts, mask, box, bounds))),
        planning_timeout=0.0, group_size=2)
    got = FleetReplanningService(
        ConstrainedSolver(CFG, rectangle_collision, device="cpu"), 4, env.bounds,
        RectangleOracle(*(torch.tensor(a)[None] for a in (pts, mask, box, bounds))),
        planning_timeout=0.0, group_size=2)
    routes = [(env.start, env.goal), (env.goal, env.start)] * 2
    for r, (s, _) in enumerate(routes):
        want.update_robot_pose(r, s)
        got.update_robot_pose(r, s)
    want._init_states()
    got._states = to_port(want._states)
    for r, (_, g) in enumerate(routes):
        assert want.set_goal(r, g) and got.set_goal(r, g)
    for a, b in zip(tree_leaves(got._states), tree_leaves(to_port(want._states))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    for r, pose in ((0, [0.6, 0.55, 0.05]), (3, [2.4, 2.3, 0.1])):
        want.update_robot_pose(r, pose)
        got.update_robot_pose(r, pose)
    got._noise = replay(want._states.key, got.steps_per_chunk)
    want_paths, paths = want.replan_cycle(), got.replan_cycle()
    assert not got._noise.queue
    assert sorted(paths) == sorted(want_paths) == [0, 1, 2, 3]
    for r in paths:
        np.testing.assert_allclose(paths[r], want_paths[r], atol=2e-3)
    st, ref = got._states, want._states
    np.testing.assert_allclose(st.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_allclose(st.start.numpy(), np.asarray(ref.start), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st.goal.numpy(), np.asarray(ref.goal))
    np.testing.assert_array_equal(st.step_count.numpy(), np.asarray(ref.step_count))
    for leaf in tree_leaves(st.field_params):
        assert torch.equal(leaf[0], leaf[1]) and torch.equal(leaf[2], leaf[3])


# ------------------------------------------ tests/test_fleet.py on the port

class TestRetarget:
    def test_keeps_field_resets_query(self):
        env, oracle, solver = car_oracle_solver()
        g = torch.Generator().manual_seed(0)
        state = solver.init_state(g, np.asarray(env.start, np.float32)[None],
                                  np.asarray(env.goal, np.float32)[None],
                                  np.asarray(env.bounds, np.float32)[None], oracle)
        state, _ = solver.run(state, oracle, 20, g)
        new_start = np.array([[2.5, 2.5, 0.0]], np.float32)
        new_goal = np.array([[0.5, 0.5, 0.0]], np.float32)
        re = solver.retarget(state, new_start, new_goal)
        # field + buffer untouched
        for a, b in zip(tree_leaves(state.field_params), tree_leaves(re.field_params)):
            assert torch.equal(a, b)
        assert torch.equal(state.buffer_points, re.buffer_points)
        # query state rebuilt
        np.testing.assert_allclose(re.start.numpy(), new_start)
        np.testing.assert_allclose(re.goal.numpy(), new_goal)
        assert int(re.step_count[0]) == 0
        assert float(re.constraint_multipliers.abs().max()) == 0.0
        full = solver.full_trajectory(re)[0].numpy()
        np.testing.assert_allclose(full[0], new_start[0], atol=1e-6)
        np.testing.assert_allclose(full[-1], new_goal[0], atol=1e-6)
        re, _ = solver.run(re, oracle, 20, g)
        assert torch.isfinite(re.trajectory).all()


class TestFleetService:
    def make_service(self, n_robots=4, shared_field=True, planning_timeout=0.05, **kwargs):
        env, oracle, solver = car_oracle_solver()
        svc = FleetReplanningService(
            solver, n_robots, env.bounds, oracle,
            planning_timeout=planning_timeout, shared_field=shared_field, **kwargs,
        )
        return env, svc

    def test_device_is_the_solver_s(self):
        env, svc = self.make_service()
        assert svc.device == torch.device("cpu")
        assert all(leaf.shape[0] == 4 for leaf in tree_leaves(svc._oracles))

    def test_cycle_empty_until_goal(self):
        env, svc = self.make_service()
        assert svc.replan_cycle() == {}
        assert not svc.set_goal(0, env.goal)  # no pose yet
        svc.update_robot_pose(0, env.start)
        assert svc.set_goal(0, env.goal)

    def test_two_robots_shared_field(self):
        env, svc = self.make_service()
        svc.update_robot_pose(0, env.start)
        svc.update_robot_pose(1, env.goal)
        assert svc.set_goal(0, env.goal)
        assert svc.set_goal(1, env.start)
        paths = svc.replan_cycle()
        assert set(paths) == {0, 1}
        for robot, (s, g) in {0: (env.start, env.goal), 1: (env.goal, env.start)}.items():
            p = paths[robot]
            assert np.isfinite(p).all()
            np.testing.assert_allclose(p[0], np.asarray(s, np.float32), atol=1e-4)
            np.testing.assert_allclose(p[-1], np.asarray(g, np.float32), atol=1e-4)
        # shared field: replicas bit-identical across all lanes after cycles
        for leaf in field(svc):
            assert torch.equal(leaf[0], leaf[-1])

    def test_first_goal_inits_every_lane_at_its_pose(self):
        """The first set_goal runs the grouped init with start = goal = each
        robot's pose, then retargets only that robot."""
        env, svc = self.make_service()
        poses = np.array([[0.5, 0.5, 0.0], [1.0, 0.5, 0.3], [2.5, 2.5, 1.0], [0.5, 2.0, 0.0]],
                         np.float32)
        for r in range(4):
            svc.update_robot_pose(r, poses[r])
        assert svc.set_goal(2, env.goal)
        st = svc._states
        np.testing.assert_array_equal(st.start.numpy(), poses)
        np.testing.assert_array_equal(st.goal[[0, 1, 3]].numpy(), poses[[0, 1, 3]])
        np.testing.assert_array_equal(st.goal[2].numpy(), np.asarray(env.goal, np.float32))
        for leaf in field(svc):
            assert torch.equal(leaf[0], leaf[3])

    def test_retarget_writes_only_its_lane_and_starts_only_active_lanes(self):
        env, svc = self.make_service(postprocessor=PathPostprocessor())
        for r in range(4):
            svc.update_robot_pose(r, env.start)
        svc.set_goal(0, env.goal)
        svc.set_goal(1, env.goal)
        svc.replan_cycle()
        before = svc._states
        svc.set_goal(1, [0.5, 2.5, 0.0])
        after = svc._states
        for name, a, b in zip(before._fields, before, after):
            for la, lb in zip(tree_leaves(a), tree_leaves(b)):
                rows = [0, 2, 3] if name not in ("field_params", "field_opt_state",
                                                 "buffer_points", "buffer_ages") else range(4)
                for i in rows:
                    assert torch.equal(la[i], lb[i]), name
        # a new pose reaches only the active robots' starts
        svc.update_robot_pose(0, [0.6, 0.55, 0.05])
        svc.update_robot_pose(3, [1.0, 1.0, 0.0])
        paths = svc.replan_cycle()
        assert set(paths) == {0, 1}
        st = svc._states
        np.testing.assert_allclose(st.start[0].numpy(), [0.6, 0.55, 0.05], atol=1e-7)
        np.testing.assert_array_equal(st.start[3].numpy(), np.asarray(env.start, np.float32))
        assert all(np.isfinite(p).all() and p.shape[1] == 3 for p in paths.values())

    def test_retarget_midway_and_stop(self):
        env, svc = self.make_service(n_robots=2)
        svc.update_robot_pose(0, env.start)
        svc.set_goal(0, env.goal)
        svc.replan_cycle()
        field_before = field(svc)[0]
        svc.update_robot_pose(0, [1.5, 1.5, 0.0])
        svc.set_goal(0, [0.5, 2.5, 0.0])
        assert torch.equal(field_before, field(svc)[0])
        paths = svc.replan_cycle()
        np.testing.assert_allclose(paths[0][-1], np.asarray([0.5, 2.5, 0.0], np.float32),
                                   atol=1e-4)
        svc.stop(0)
        assert svc.replan_cycle() == {}

    def test_independent_fields_mode(self):
        env, svc = self.make_service(n_robots=2, shared_field=False, steps_per_chunk=7)
        svc.update_robot_pose(0, env.start)
        svc.set_goal(0, env.goal)
        paths = svc.replan_cycle()
        assert 0 in paths and np.isfinite(paths[0]).all()
        assert int(svc._states.step_count[0]) % 7 == 0

    def test_same_seed_same_cycles(self):
        runs = []
        for _ in range(2):
            env, svc = self.make_service(seed=3, planning_timeout=0.0)
            svc.update_robot_pose(0, env.start)
            svc.update_robot_pose(1, env.goal)
            svc.set_goal(0, env.goal)
            svc.set_goal(1, env.start)
            runs.append([svc.replan_cycle() for _ in range(2)])
        for a, b in zip(*runs):
            for r in a:
                np.testing.assert_array_equal(a[r], b[r])

    def test_chunk_must_fit_reparam_freq(self):
        env, oracle, solver = car_oracle_solver()
        with pytest.raises(ValueError, match="multiple"):
            FleetReplanningService(solver, 2, env.bounds, oracle, steps_per_chunk=7,
                                   shared_field=True)


class TestFleetGroupSize:
    def test_sub_fleet_field_groups(self):
        """group_size < n_robots: one field per sub-fleet, in lockstep within
        each group, independent across groups (a pretrained init)."""
        env, oracle, solver = car_oracle_solver(init_collision_iteration=2)
        svc = FleetReplanningService(solver, 4, env.bounds, oracle, planning_timeout=0.05,
                                     group_size=2)
        for r, (s, g) in enumerate([(env.start, env.goal), (env.goal, env.start)] * 2):
            svc.update_robot_pose(r, s)
            assert svc.set_goal(r, g)
        paths = svc.replan_cycle()
        assert set(paths) == {0, 1, 2, 3}
        for p in paths.values():
            assert np.isfinite(p).all()
        for leaf in tree_leaves(svc._states.field_params):
            assert torch.equal(leaf[0], leaf[1]) and torch.equal(leaf[2], leaf[3])
            assert not torch.equal(leaf[0], leaf[2])  # groups independent

    def test_group_size_must_divide(self):
        env, oracle, solver = car_oracle_solver()
        with pytest.raises(ValueError, match="divisible"):
            FleetReplanningService(solver, 4, env.bounds, oracle, group_size=3)


class TestMultiMapFleet:
    def test_groups_on_different_maps(self):
        """Two field groups on DIFFERENT maps: each group's rows hold its
        own world, and the shared fields stay per group."""
        env, oracle, solver = car_oracle_solver()
        svc = FleetReplanningService(solver, 4, env.bounds, oracle, planning_timeout=0.05,
                                     group_size=2)
        shifted = oracle._replace(points=oracle.points + torch.tensor([0.4, 0.4]))
        svc.update_world(shifted, group=1)
        arr = svc._oracles.points
        assert torch.equal(arr[0], arr[1]) and torch.equal(arr[2], arr[3])
        assert torch.equal(arr[0], oracle.points[0]) and torch.equal(arr[2], shifted.points[0])
        for r, (s, g) in enumerate([(env.start, env.goal), (env.goal, env.start)] * 2):
            svc.update_robot_pose(r, s)
            assert svc.set_goal(r, g)
        paths = svc.replan_cycle()
        assert set(paths) == {0, 1, 2, 3}
        for p in paths.values():
            assert np.isfinite(p).all()
        for leaf in tree_leaves(svc._states.field_params):
            assert torch.equal(leaf[0], leaf[1]) and torch.equal(leaf[2], leaf[3])

    def test_group_update_errors(self):
        """Both ValueErrors of update_world(group=k)."""
        env, oracle, solver = car_oracle_solver()
        svc = FleetReplanningService(solver, 4, env.bounds, oracle, group_size=2)
        with pytest.raises(ValueError, match="out of range"):
            svc.update_world(oracle, group=5)
        with pytest.raises(ValueError, match="out of range"):
            svc.update_world(oracle, group=-1)
        svc._oracles = None  # as before the fleet-wide world
        with pytest.raises(ValueError, match="fleet-wide world"):
            svc.update_world(oracle, group=0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_solver_without_a_card_raises():
    env = car_environment()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConstrainedSolver(SolverConfig(), circle_collision)
    _, oracle, solver = car_oracle_solver()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetReplanningService(solver, 2, env.bounds, oracle, device="cuda")
