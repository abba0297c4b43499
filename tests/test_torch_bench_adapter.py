"""The port's BenchmarkAdapter and BenchmarkCollisionChecker
(nfopp_tpu_torch.bench.adapter) against the JAX package's on the worlds of
tests/test_benchmark_adapter.py, on the CPU: the same start, goal and bounds,
collision answers, path evaluation (length rtol 1e-6) and saved JSON (every
field but the planning time, which is a clock reading), and that test file's
holds on the port."""
import numpy as np
import pytest
import torch

from nfopp_tpu.bench import BenchmarkAdapter as JaxAdapter
from nfopp_tpu.bench import BenchmarkCollisionChecker as JaxChecker
from nfopp_tpu.utils import Position2 as JaxPosition2
from nfopp_tpu.worlds import GridScenario as JaxGridScenario
from nfopp_tpu_torch.bench import BenchmarkAdapter, BenchmarkCollisionChecker, ResultsLog
from nfopp_tpu_torch.utils import Position2
from nfopp_tpu_torch.worlds import GridScenario
from torch_threads import one_thread  # noqa: F401


def block_world(cls):
    """tests/test_benchmark_adapter.py's world: a central block, world [8,12)^2."""
    blocked = np.zeros((20, 20), bool)
    blocked[8:12, 8:12] = True
    return cls(blocked=blocked, resolution=1.0,
               start=np.array([2.5, 2.5, 0.0], np.float32),
               goal=np.array([17.5, 17.5, 0.0], np.float32))


def offset_world(cls):
    """A random grid with a half-cell resolution and an offset origin."""
    blocked = np.random.RandomState(5).rand(24, 16) < 0.15
    blocked[0, 0] = blocked[-1, -1] = False
    return cls(blocked=blocked, resolution=0.5, origin=(-2.0, 1.0),
               start=np.array([-1.75, 1.25, 0.3], np.float32),
               goal=np.array([5.75, 12.75, -1.0], np.float32))


WORLDS = {"block": block_world, "offset": offset_world}


@pytest.fixture(params=[("block", 0.0), ("offset", 0.0), ("offset", 0.5)],
                ids=lambda p: f"{p[0]}-r{p[1]}")
def pair(request, tmp_path):
    name, radius = request.param
    world = WORLDS[name]
    return (JaxAdapter(world(JaxGridScenario), footprint_radius=radius,
                       log_file=tmp_path / "jax.json"),
            BenchmarkAdapter(world(GridScenario), footprint_radius=radius,
                             log_file=tmp_path / "torch.json", device="cpu"))


def probe_poses(adapter):
    """Every cell centre and cell corner of the world, and points outside it."""
    x0, x1, y0, y1 = adapter.bounds()
    res = adapter.scenario.resolution
    xs = np.arange(x0 - res, x1 + res, res / 2)
    ys = np.arange(y0 - res, y1 + res, res / 2)
    gx, gy = np.meshgrid(xs, ys)
    angles = np.random.RandomState(0).uniform(-np.pi, np.pi, gx.size)
    return np.stack([gx.ravel(), gy.ravel(), angles], axis=1).astype(np.float32)


def test_endpoints_and_bounds_equal_jax(pair):
    jax_adapter, adapter = pair
    assert adapter.bounds() == jax_adapter.bounds()
    np.testing.assert_array_equal(adapter.start().as_vec(), jax_adapter.start().as_vec())
    np.testing.assert_array_equal(adapter.goal().as_vec(), jax_adapter.goal().as_vec())
    np.testing.assert_array_equal(adapter._obstacle_points, jax_adapter._obstacle_points)


def test_collision_answers_equal_jax(pair):
    jax_adapter, adapter = pair
    poses = probe_poses(adapter)
    want = jax_adapter.collides_positions(poses)
    got = adapter.collides_positions(poses)
    assert got.dtype == bool and got.shape == (len(poses),)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    for pose in poses[::37]:
        assert adapter.is_collision(Position2.from_vec(pose)) == jax_adapter.is_collision(
            JaxPosition2.from_vec(pose))
    np.testing.assert_array_equal(BenchmarkCollisionChecker(adapter).check_collision(poses),
                                  JaxChecker(jax_adapter).check_collision(poses))
    assert BenchmarkCollisionChecker(adapter).get_boundaries() == JaxChecker(
        jax_adapter).get_boundaries()


def paths_of(adapter, count=4, points=30):
    """A straight path from start to goal, and random walks inside the world."""
    rng = np.random.RandomState(1)
    x0, x1, y0, y1 = adapter.bounds()
    start, goal = adapter.scenario.start, adapter.scenario.goal
    t = np.linspace(0, 1, points)[:, None]
    paths = [start[None] * (1 - t) + goal[None] * t]
    for _ in range(count - 1):
        walk = rng.uniform([x0, y0, -np.pi], [x1, y1, np.pi], (points, 3))
        paths.append(walk)
    return [p.astype(np.float32) for p in paths]


def test_evaluate_path_equals_jax(pair):
    jax_adapter, adapter = pair
    outcomes = set()
    for path in paths_of(adapter):
        collides, length = adapter.evaluate_path(path)
        want_collides, want_length = jax_adapter.evaluate_path(path)
        assert collides == want_collides
        assert length == pytest.approx(want_length, rel=1e-6)
        outcomes.add(collides)
    assert True in outcomes


def test_saved_results_equal_jax(pair):
    jax_adapter, adapter = pair
    for i, path in enumerate(paths_of(adapter, count=2)):
        got_file = adapter.evaluate_and_save_results(path, f"planner_{i}")
        want_file = jax_adapter.evaluate_and_save_results(path, f"planner_{i}")
    got, want = ResultsLog.load(got_file), ResultsLog.load(want_file)
    assert len(got["runs"]) == len(want["runs"]) == 2
    for got_run, want_run in zip(got["runs"], want["runs"]):
        for plan in (*got_run["plans"].values(), *want_run["plans"].values()):
            assert plan["stats"].pop("planning_time") >= 0
        assert got_run.keys() == want_run.keys()
        assert got_run["environment"] == want_run["environment"]
        assert got_run["settings"] == want_run["settings"]
        (name, got_plan), = got_run["plans"].items()
        want_plan = want_run["plans"][name]
        assert got_plan["trajectory"] == want_plan["trajectory"]
        assert got_plan["path"] == want_plan["path"]
        assert got_plan["stats"].keys() == want_plan["stats"].keys()
        for key, value in got_plan["stats"].items():
            if isinstance(value, float):
                assert value == pytest.approx(want_plan["stats"][key], rel=1e-9, abs=1e-12), key
            else:
                assert value == want_plan["stats"][key], key


@pytest.fixture(scope="module")
def adapter(tmp_path_factory):
    log = tmp_path_factory.mktemp("results") / "res.json"
    return BenchmarkAdapter(block_world(GridScenario), footprint_radius=0.0, log_file=log,
                            device="cpu")


def test_concrete_collision_answers(adapter):
    """tests/test_benchmark_adapter.py's answers on the port."""
    assert adapter.bounds() == (0.0, 20.0, 0.0, 20.0)
    assert adapter.is_collision(Position2(10.0, 10.0, 0.3))
    assert not adapter.is_collision(Position2(2.0, 2.0, 0.0))
    assert adapter.is_collision(Position2(-1.0, 5.0, 0.0))  # out of bounds
    got = adapter.collides_positions(
        np.array([[10, 10, 0], [1, 1, 0], [11.5, 8.5, 1.0]], np.float32))
    np.testing.assert_array_equal(got, [True, False, True])
    checker = BenchmarkCollisionChecker(adapter)
    np.testing.assert_array_equal(checker.check_collision(Position2(10.0, 10.0, 0.0)), [True])


def test_evaluate_and_save_results(adapter):
    """tests/test_benchmark_adapter.py's straight path below the block."""
    path = np.stack([np.linspace(2.5, 17.5, 30), np.full(30, 2.0), np.zeros(30)], axis=1)
    collides, length = adapter.evaluate_path(path)
    assert not collides
    np.testing.assert_allclose(length, 15.0, atol=1e-5)
    out = adapter.evaluate_and_save_results(path, "constrained_onf_planner")
    plan = ResultsLog.load(out)["runs"][-1]["plans"]["constrained_onf_planner"]
    assert plan["stats"]["path_found"] is True
    assert plan["stats"]["path_collides"] is False
    assert plan["stats"]["path_length"] == pytest.approx(15.0, abs=1e-4)
    assert len(plan["trajectory"]) == 30


def test_the_adapter_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BenchmarkAdapter(block_world(GridScenario))
