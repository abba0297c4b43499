"""The port's replanning service layer (nfopp_tpu_torch.service) on the CPU,
held against the JAX package's on the same inputs:

- `PathPostprocessor` (host numpy/scipy) gives JAX's output exactly on
  seeded random paths, a 2-point path, a collapsed path and a direction
  flip, and passes tests/test_api_service.py's postprocessor cases;
- `WorldState` gives JAX's merged points, padded `CircleOracle` leaves and
  rasterized + dilated `GridOracle` leaves bit for bit (with the port's
  leading robot axis), and passes tests/test_world_state.py's cases;
- `ReplanningService` runs tests/test_api_service.py::test_full_replanning_flow
  in lockstep with JAX's service (JAX's state handed over after the goal,
  its draws replayed, paths within atol 2e-3), and keeps JAX's deadline loop (a positive budget runs at least one chunk,
  and no chunk starts after the deadline).
"""
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.service import PathPostprocessor as JaxPathPostprocessor
from nfopp_tpu.service import ReplanningService as JaxReplanningService
from nfopp_tpu.service import WorldState as JaxWorldState
from nfopp_tpu.solver import PlannerFactory as JaxPlannerFactory
from nfopp_tpu.worlds import CircleOracle as JaxCircleOracle
from nfopp_tpu.worlds import GridScenario as JaxGridScenario
from nfopp_tpu.worlds import circle_collision as jax_circle_collision
from nfopp_tpu_torch.service import PathPostprocessor, ReplanningService, WorldState
from nfopp_tpu_torch.solver import PlannerFactory, state_from_jax
from nfopp_tpu_torch.utils.config import AttributeDict
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    GridScenario,
    circle_collision,
    grid_collision,
    pad_obstacle_points,
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


# ------------------------------------------------------------ postprocessor

def random_path(seed: int, n: int) -> np.ndarray:
    """A random walk in SE(2) with a few repeated (near-duplicate) points."""
    rng = np.random.default_rng(seed)
    step = rng.normal(0.0, 0.05, (n, 2)) + np.array([0.04, 0.01])
    xy = np.cumsum(step, axis=0)
    xy[rng.integers(1, n - 1, 3)] = xy[rng.integers(1, n - 1, 3)]
    theta = np.cumsum(rng.normal(0.0, 0.4, n))  # unwrapped: crosses +-pi
    return np.concatenate([xy, theta[:, None]], axis=1)


def postprocessed(path, **kwargs):
    return (PathPostprocessor(**kwargs).process(path),
            JaxPathPostprocessor(**kwargs).process(path))


@pytest.mark.parametrize("seed,n,step", [(0, 102, 0.05), (1, 40, 0.02), (2, 102, 0.2),
                                         (3, 7, 0.05)])
def test_postprocessor_equals_jax_on_random_paths(seed, n, step):
    got, want = postprocessed(random_path(seed, n), distance_step=step)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", [
    np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]),  # 2 points: passed through
    np.array([[0.5, 0.5, 0.1]] * 6 + [[0.5004, 0.5, 0.2]]),  # collapses to its endpoints
    np.stack([np.concatenate([[0.2, 0.1], np.linspace(0.0, 2.0, 30)]), np.zeros(32),
              np.zeros(32)], axis=1),  # an initial direction flip
    np.stack([np.linspace(0.0, 1.0, 20), np.zeros(20), np.full(20, np.pi)], axis=1),  # backwards
])
def test_postprocessor_equals_jax_on_edge_cases(path):
    got, want = postprocessed(path)
    np.testing.assert_array_equal(got, want)


def test_postprocessor_reference_cases():
    """tests/test_api_service.py::TestPathPostprocessor on the port."""
    traj = np.stack([np.linspace(0, 1, 50), np.zeros(50), np.zeros(50)], axis=1)
    out = PathPostprocessor(distance_step=0.05).process(traj)
    seg = np.linalg.norm(np.diff(out[:, :2], axis=0), axis=1)
    np.testing.assert_allclose(seg, 0.05, atol=0.02)
    traj = np.array([[0, 0, 0]] * 5 + [[1, 0, 0]] * 5 + [[2, 0, 0]], np.float64)
    assert np.isfinite(PathPostprocessor(distance_step=0.5).process(traj)).all()
    x = np.concatenate([[0.2, 0.1], np.linspace(0.0, 2.0, 30)])
    out = PathPostprocessor(distance_step=0.05).process(
        np.stack([x, np.zeros_like(x), np.zeros_like(x)], axis=1))
    assert (np.diff(out[:, 0])[5:] > 0).all()
    traj = np.array([[0, 0, 0], [1, 1, 1]], np.float64)
    np.testing.assert_array_equal(PathPostprocessor().process(traj), traj)


# -------------------------------------------------------------- world state

def random_map(seed: int):
    rng = np.random.default_rng(seed)
    blocked = rng.random((20, 30)) < 0.08
    origin = (-0.55, 0.3)
    sensor = rng.uniform([-1.0, 0.0], [3.0, 2.8], (25, 2)).astype(np.float32)  # some outside
    return blocked, 0.1, origin, sensor


def both_worlds(seed: int, capacity: int = 256):
    blocked, res, origin, sensor = random_map(seed)
    port, ref = WorldState(capacity, device="cpu"), JaxWorldState(capacity)
    port.update_map(GridScenario(blocked, res, origin))
    ref.update_map(JaxGridScenario(blocked, res, origin))
    port.update_sensor_points(sensor)
    ref.update_sensor_points(sensor)
    return port, ref


def assert_leaves_equal(got, want, batch: int):
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.shape == (batch,) + w.shape, name
        assert g.numpy().dtype == w.dtype, name
        for row in g.numpy():
            np.testing.assert_array_equal(row, w, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_world_points_equal_jax(seed):
    port, ref = both_worlds(seed)
    assert port.boundaries == ref.boundaries
    got, want = port.merged_points(), ref.merged_points()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 3])
def test_circle_oracle_leaves_equal_jax(batch):
    port, ref = both_worlds(0)
    assert_leaves_equal(port.circle_oracle(0.3, batch=batch), ref.circle_oracle(0.3), batch)


@pytest.mark.parametrize("footprint,batch", [(0.0, 1), (0.25, 2), (0.31, 1)])
def test_grid_oracle_leaves_equal_jax(footprint, batch):
    """Rasterization (int() truncation, bounds mask) and dilation bit for bit."""
    port, ref = both_worlds(1)
    assert_leaves_equal(port.grid_oracle(footprint, batch=batch), ref.grid_oracle(footprint),
                        batch)


def test_world_without_sensor_points_or_map_equals_jax():
    port, ref = WorldState(16, device="cpu"), JaxWorldState(16)
    assert_leaves_equal(port.circle_oracle(0.2), ref.circle_oracle(0.2), 1)
    points = np.array([[0.5, 0.5], [1.0, 2.0]], np.float32)
    port.update_sensor_points(points)
    ref.update_sensor_points(points)
    assert_leaves_equal(port.circle_oracle(0.2), ref.circle_oracle(0.2), 1)
    with pytest.raises(ValueError, match="exceed capacity"):
        port.update_sensor_points(np.zeros((17, 2), np.float32))
        port.circle_oracle(0.2)


@pytest.fixture()
def world():
    blocked = np.zeros((10, 10), bool)
    blocked[5, 5] = True
    ws = WorldState(point_capacity=64, device="cpu")
    ws.update_map(GridScenario(blocked=blocked, resolution=1.0))
    return ws


def test_map_to_points_and_boundaries(world):
    assert world.boundaries == (0.0, 10.0, 0.0, 10.0)
    np.testing.assert_allclose(world.merged_points(), [[5.5, 5.5]])


def test_circle_oracle_merges_sensor_points(world):
    world.update_sensor_points(np.array([[2.0, 2.0]], np.float32))
    oracle = world.circle_oracle(radius=0.4)
    q = torch.tensor([[[2.2, 2.0, 0.0], [5.5, 5.4, 0.0], [8.0, 8.0, 0.0]]])
    assert circle_collision(oracle, q)[0].tolist() == [True, True, False]


def test_grid_oracle_rasterizes_sensor_points(world):
    world.update_sensor_points(np.array([[2.3, 7.8]], np.float32))
    oracle = world.grid_oracle()
    q = torch.tensor([[[2.5, 7.5], [2.5, 6.5], [5.5, 5.5]]])
    assert grid_collision(oracle, q)[0].tolist() == [True, False, True]


def test_grid_oracle_requires_map():
    with pytest.raises(ValueError, match="no map"):
        WorldState(device="cpu").grid_oracle()


def test_sensor_update_replaces(world):
    world.update_sensor_points(np.array([[1.0, 1.0]], np.float32))
    world.update_sensor_points(np.zeros((0, 2), np.float32))
    assert len(world.merged_points()) == 1  # only the map point remains


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_world_state_on_cuda_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorldState()


# ---------------------------------------------------------------- service

RUN_PLANNER_PARAMS = AttributeDict(
    trajectory_length=100,
    collision_model=AttributeDict(
        mean=0, sigma=1, use_cos=True, bias=True, use_normal_init=True,
        angle_encoding=True, name="ONF",
    ),
    collision_optimizer=AttributeDict(lr=5e-2, betas=(0.9, 0.9)),
    trajectory_optimizer=AttributeDict(lr=1e-2, betas=(0.9, 0.9)),
    planner=AttributeDict(
        name="ConstrainedNFOPPlanner", trajectory_random_offset=0.02,
        collision_weight=1, velocity_hessian_weight=0.5, random_field_points=10,
        init_collision_iteration=0, constraint_deltas_weight=20, multipliers_lr=0.1,
        init_collision_points=100, reparametrize_trajectory_freq=10,
        optimize_collision_model_freq=1, angle_weight=0.5, angle_offset=0.3,
        boundary_weight=1, collision_multipliers_lr=1e-3,
    ),
)


def make_oracle(env):
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    return CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], torch.tensor([0.3]),
                        torch.tensor([[0.0, 3.0, 0.0, 3.0]]))


def jax_make_oracle(env):
    """tests/test_api_service.py's oracle."""
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    return JaxCircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.3),
                           jnp.asarray([0.0, 3.0, 0.0, 3.0], jnp.float32))


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


def replay(key, cfg, steps):
    """JAX's draws of `steps` steps of one problem from its state's `key`
    (constrained.py:316, field.py:70-87, :431), for the port's [1, ...]
    blocks."""
    n = cfg.trajectory_length
    cand = cfg.collision_point_count + n - 1

    def step_draws(key):
        key, k_field, k_traj = jax.random.split(key, 3)
        k_uni, k_norm = jax.random.split(k_field, 2)
        u = jax.random.uniform(k_uni, ((n - 1) + cand + cfg.random_field_points * 3,))
        normal = jax.random.normal(k_norm, (2, n - 1, 3))
        t = jax.random.uniform(k_traj, (n - 1, cfg.collision_samples_per_segment))
        return key, u, normal, t

    noise, keys = ReplayNoise(), key[None]
    for _ in range(steps):
        keys, u, normal, t = jax.vmap(step_draws)(keys)
        noise.push("uniform", u)
        noise.push("normal", normal)
        noise.push("uniform", t)
    return noise


class Clock:
    """A host clock that advances 0.02 s at every reading: a 0.05 s budget
    then runs two chunks in both services, whatever the host's speed."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.02
        return self.now


def test_full_replanning_flow(monkeypatch):
    """tests/test_api_service.py::test_full_replanning_flow on the port,
    driven in lockstep with JAX's service: JAX's planner state is handed to
    the port after the goal, each cycle replays JAX's draws, and the paths
    agree within ROADMAP's trajectory tolerance (atol 2e-3 over <= 20
    steps)."""
    for module in (ReplanningService.__module__, JaxReplanningService.__module__):
        monkeypatch.setattr(f"{module}.time", Clock())
    env = two_walls_se2_environment()
    oracle = make_oracle(env)
    planner = PlannerFactory.make_constrained_onf_planner(
        circle_collision, oracle, RUN_PLANNER_PARAMS, device="cpu"
    )
    jax_planner = JaxPlannerFactory.make_constrained_onf_planner(
        jax_circle_collision, jax_make_oracle(env), RUN_PLANNER_PARAMS
    )
    published, jax_published = [], []
    service = ReplanningService(
        planner,
        planning_timeout=0.05,
        steps_per_chunk=5,
        postprocessor=PathPostprocessor(),
        path_callback=published.append,
    )
    jax_service = JaxReplanningService(
        jax_planner, planning_timeout=0.05, steps_per_chunk=5,
        postprocessor=JaxPathPostprocessor(), path_callback=jax_published.append,
    )
    both = (service, jax_service)
    # no goal yet -> idle
    assert [s.replan_cycle() for s in both] == [None, None]
    # missing pose/bounds -> set_goal refused
    assert [s.set_goal(env.goal) for s in both] == [False, False]

    for s in both:
        s.update_robot_pose(env.start)
        s.update_boundaries(env.bounds)
        assert s.set_goal(env.goal)
    planner._state = state_from_jax(jax.tree_util.tree_map(np.asarray, jax_planner.state),
                                    device="cpu")

    def cycle():
        planner._noise = replay(jax_planner.state.key, jax_planner.solver.config, 10)
        want = jax_service.replan_cycle()
        path = service.replan_cycle()
        assert not planner._noise.queue  # two chunks of 5 steps ran
        np.testing.assert_allclose(planner.get_path(), jax_planner.get_path(), atol=2e-3)
        assert path.shape == want.shape
        np.testing.assert_allclose(path, want, atol=2e-3)
        return path

    path = cycle()
    assert path is not None and len(published) == len(jax_published) == 1
    assert path.shape[1] == 3
    assert np.isfinite(path).all()

    # robot moved: next cycle starts from the new pose
    new_pose = np.array([0.6, 0.55, 0.05], np.float32)
    for s in both:
        s.update_robot_pose(new_pose)
    cycle()
    np.testing.assert_allclose(planner.get_path()[0], new_pose, atol=1e-5)
    np.testing.assert_allclose(planner.get_path()[-1], env.goal, atol=1e-6)
    # a new obstacle world is swapped in under the lock
    service.update_world(oracle)
    assert planner._oracle_params is oracle
    for s in both:
        s.stop()
    assert [s.replan_cycle() for s in both] == [None, None]


class ChunkPlanner:
    """Stand-in planner whose chunks take `seconds` each; records the calls."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.calls = []
        self.synced = 0

    def update_start_point(self, pose):
        self.calls.append(("start", np.asarray(pose).tolist()))

    def step(self, steps):
        self.calls.append(("step", steps))
        time.sleep(self.seconds)
        planner = self

        class Loss(torch.Tensor):
            def item(self):
                planner.synced += 1
                return super().item()

        return SimpleNamespace(trajectory_loss=torch.zeros((1, steps)).as_subclass(Loss))

    def get_path(self):
        return np.zeros((4, 3), np.float32)

    def init(self, start, goal, bounds):
        self.calls.append(("init", np.asarray(goal).tolist()))


@pytest.mark.parametrize("budget,chunk_s", [(0.03, 0.05), (0.05, 0.012)])
def test_deadline_loop_runs_whole_chunks_within_the_budget(budget, chunk_s):
    """At least one chunk; a chunk starts only before the deadline, and each
    is synchronised (`.item()` on its last loss) before the clock is read."""
    planner = ChunkPlanner(chunk_s)
    service = ReplanningService(planner, planning_timeout=budget, steps_per_chunk=7)
    service.update_robot_pose([0.1, 0.2, 0.3])
    service.update_boundaries((0.0, 1.0, 0.0, 1.0))
    assert service.set_goal([0.9, 0.9, 0.0])
    path = service.replan_cycle()
    steps = [c for c in planner.calls if c[0] == "step"]
    assert planner.calls[1] == ("start", [pytest.approx(0.1), pytest.approx(0.2),
                                          pytest.approx(0.3)])
    assert len(steps) >= 1 and all(s == ("step", 7) for s in steps)
    assert planner.synced == len(steps)
    assert len(steps) <= int(budget / chunk_s) + 1
    assert path.shape == (4, 3)
