"""The slice as a whole: the port's benchmark suite runner
(nfopp_tpu_torch.bench.runner.run_grid_suite) against the JAX package's on
tests/test_runner.py's wall and boxed worlds, on the CPU.

The worlds, the endpoint prechecks and the wavefront initial trajectories
are the JAX version's (rtol 1e-6); the solves draw other random streams
(ROADMAP: the port cannot replay threefry), so they are judged by outcome:
both feasible on the wall world, both infeasible on the sealed box, with
the same result shapes, flags and results-log schema. The path statistics
of the same paths equal JAX's (numpy and native evaluators, rtol 1e-9) and
the results log writes the same document. Then tests/test_runner.py's
control-flow tests, mirrored on the port alone."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.astar.initializer import (
    batched_wavefront_trajectories as jax_batched_wavefront_trajectories,
)
from nfopp_tpu.bench import metrics as jax_metrics
from nfopp_tpu.bench import results as jax_results
from nfopp_tpu.bench.runner import run_grid_suite as jax_run_grid_suite
from nfopp_tpu.parallel import problem_mesh
from nfopp_tpu_torch.bench import metrics, native_binding, results, runner
from nfopp_tpu_torch.bench.runner import run_grid_suite
from nfopp_tpu_torch.utils.config import AttributeDict
from nfopp_tpu_torch.worlds.scenarios import GridScenario
from torch_threads import one_thread  # noqa: F401


FAST = dict(max_iterations=100, min_iterations=50, check_freq=25)
PLANNER = "constrained_onf_planner"


def small_parameters():
    """tests/test_runner.py::small_parameters, as the port's AttributeDict."""
    return AttributeDict(
        trajectory_length=24,
        collision_model=AttributeDict(
            mean=0.0, sigma=2.0, use_cos=True, bias=True, use_normal_init=True,
            angle_encoding=True, name="ONF",
        ),
        collision_optimizer=AttributeDict(lr=2e-2, betas=(0.9, 0.9)),
        trajectory_optimizer=AttributeDict(lr=5e-2, betas=(0.9, 0.9)),
        planner=AttributeDict(
            name="ConstrainedNFOPPlanner",
            trajectory_random_offset=0.02, collision_weight=100.0,
            velocity_hessian_weight=0.5, random_field_points=10,
            init_collision_iteration=20, constraint_deltas_weight=100.0,
            multipliers_lr=0.1, init_collision_points=64,
            reparametrize_trajectory_freq=10, optimize_collision_model_freq=1,
            angle_weight=5.0, angle_offset=0.3, boundary_weight=1.0,
            direction_delta_weight=100.0, collision_multipliers_lr=1e-3,
            collision_beta=10.0, course_random_offset=1.5,
        ),
    )


def wall_scenario(cls=GridScenario):
    """16x16 world, one wall with a gap; solvable at a small budget."""
    blocked = np.zeros((16, 16), bool)
    blocked[3:13, 8] = True
    blocked[7:9, 8] = False
    return cls(blocked, resolution=1.0, start=np.array([3.5, 8.5, 0.0], np.float32),
               goal=np.array([13.5, 8.5, 0.0], np.float32))


def boxed_scenario(cls=GridScenario):
    """Start sealed inside a box: infeasible by construction."""
    blocked = np.zeros((16, 16), bool)
    blocked[2:7, 2:7] = True
    blocked[3:6, 3:6] = False
    return cls(blocked, resolution=1.0, start=np.array([4.5, 4.5, 0.0], np.float32),
               goal=np.array([13.5, 13.5, 0.0], np.float32))


def suite(scenarios, **kw):
    return run_grid_suite(scenarios, small_parameters(), device="cpu", **{**FAST, **kw})


def pair():
    return [wall_scenario(), boxed_scenario()]


@pytest.fixture(scope="module")
def jax_pair():
    from nfopp_tpu.utils import Config
    from nfopp_tpu.worlds.scenarios import GridScenario as JaxGridScenario

    parameters = Config.from_dict(dict(small_parameters())).as_attribute_dict()
    scenarios = [wall_scenario(JaxGridScenario), boxed_scenario(JaxGridScenario)]
    return jax_run_grid_suite(scenarios, parameters, restart_failed=2, shortcut_trials=8,
                              mesh=problem_mesh(jax.devices()[:1]), **FAST)


@pytest.fixture(scope="module")
def port_pair():
    """The port's suite on the same worlds, with its wavefront init recorded."""
    seen = {}
    real = runner.batched_wavefront_trajectories

    def record(*args):
        seen["inputs"], seen["output"] = args, real(*args)
        return seen["output"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "batched_wavefront_trajectories", record)
        result = suite(pair(), restart_failed=2, shortcut_trials=8)
    return result, seen


@pytest.fixture(scope="module")
def plateau():
    return suite([wall_scenario(), wall_scenario()])


def test_endpoint_prechecks_and_init_trajectories_match_jax(jax_pair, port_pair):
    result, seen = port_pair
    np.testing.assert_array_equal(result.start_invalid, jax_pair.start_invalid)
    np.testing.assert_array_equal(result.goal_invalid, jax_pair.goal_invalid)
    grids, starts, goals, origins, res, length = seen["inputs"]
    assert grids.shape == (2, 16, 16) and length == 24
    want = jax_batched_wavefront_trajectories(*(jnp.asarray(x.numpy()) for x in
                                                (grids, starts, goals, origins, res)), length)
    np.testing.assert_allclose(seen["output"].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the grids are the footprint-free scenarios' own, the endpoints theirs
    np.testing.assert_array_equal(grids.numpy(), np.stack([s.blocked for s in pair()]))
    np.testing.assert_array_equal(starts.numpy(), np.stack([s.start for s in pair()]))


def test_outcomes_match_jax(jax_pair, port_pair):
    result, _ = port_pair
    for r in (jax_pair, result):
        assert bool(r.feasible[0]) and not bool(r.feasible[1])
        assert r.restart_rounds_used == 1
    np.testing.assert_allclose(result.paths[:, 0], jax_pair.paths[:, 0], atol=1e-6)
    np.testing.assert_allclose(result.paths[:, -1], jax_pair.paths[:, -1], atol=1e-6)


def test_result_shapes_flags_and_log_schema_match_jax(jax_pair, port_pair):
    result, _ = port_pair
    for name in ("paths", "feasible", "lengths", "iterations", "start_invalid", "goal_invalid"):
        got, want = getattr(result, name), np.asarray(getattr(jax_pair, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
    assert type(result.repaired_by_shortcut) is type(jax_pair.repaired_by_shortcut) is int
    assert [type(s).__name__ for s in result.stats] == ["PathStatistics"] * 2
    assert result.stats[0].as_dict().keys() == jax_pair.stats[0].as_dict().keys()
    got, want = result.log.settings, jax_pair.log.settings
    assert got.keys() == want.keys() and got["evaluator"] == want["evaluator"] == "native"
    assert json.loads(json.dumps(got["nfomp"])) == json.loads(json.dumps(want["nfomp"]))
    for key in ("shortcut_trials", "restart_failed", "restart_rounds", "restart_rounds_used",
                "stop_on_plateau"):
        assert got["suite"][key] == want["suite"][key], key
    assert got["suite"].keys() == want["suite"].keys()
    for run, ref in zip(result.log.runs, jax_pair.log.runs):
        assert run.keys() == ref.keys() and run["seed_index"] == ref["seed_index"]
        assert run["environment"] == ref["environment"]
        plan, ref_plan = run["plans"][PLANNER], ref["plans"][PLANNER]
        assert plan.keys() == ref_plan.keys()
        assert plan["stats"].keys() == ref_plan["stats"].keys()
        assert plan["stats"]["path_collides"] == ref_plan["stats"]["path_collides"]


@pytest.mark.parametrize("native", [False, True])
def test_path_statistics_equal_jax(jax_pair, native):
    """The same paths (JAX's suite paths and a jagged one) through both
    evaluators: numpy vs numpy and native vs native, rtol 1e-9."""
    rng = np.random.RandomState(0)
    jagged = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    jagged[5] = jagged[4]  # a repeated point
    obstacles = rng.uniform(0.0, 16.0, (50, 2))
    segments = metrics.polygons_to_segments([np.array([[2.0, 2.0], [6.0, 2.0], [6.0, 5.0]])])
    np.testing.assert_array_equal(
        segments, jax_metrics.polygons_to_segments([np.array([[2.0, 2.0], [6.0, 2.0],
                                                              [6.0, 5.0]])]))
    for path in (*jax_pair.paths, jagged):
        for kw in (dict(obstacles=obstacles), dict(obstacle_segments=segments), {}):
            got = metrics.path_statistics(path, goal=path[-1], use_native=native, **kw)
            want = jax_metrics.path_statistics(path, goal=path[-1], use_native=native, **kw)
            for key, value in want.as_dict().items():
                if isinstance(value, float):
                    np.testing.assert_allclose(got.as_dict()[key], value, rtol=1e-9, err_msg=key)
                else:
                    assert got.as_dict()[key] == value, key
    np.testing.assert_allclose(metrics.path_stats_numpy(jagged, obstacles),
                               jax_metrics.path_stats_numpy(jagged, obstacles), rtol=1e-9)


def test_native_library_is_the_ports_own():
    assert native_binding.available() and metrics.active_evaluator() == "native"
    path = native_binding.library_path()
    assert "nfopp_tpu_torch" in path.parts and path.exists()
    rng = np.random.RandomState(1)
    paths, obstacles = np.cumsum(rng.normal(size=(3, 20, 3)), axis=1), rng.uniform(size=(10, 2))
    batch = native_binding.path_stats_batch_native(paths, obstacles)
    assert batch.shape == (3, 12)
    for b in range(3):
        np.testing.assert_array_equal(batch[b],
                                      native_binding.path_stats_native(paths[b], obstacles))


def test_results_log_writes_jax_documents(jax_pair, tmp_path):
    path = jax_pair.paths[0]
    stats = jax_metrics.path_statistics(path)
    scenario = wall_scenario()
    env = results.grid_environment_info(scenario.blocked, 1.0, (0.0, 0.0), scenario.start,
                                        scenario.goal)
    assert env == jax_results.grid_environment_info(scenario.blocked, 1.0, (0.0, 0.0),
                                                    scenario.start, scenario.goal)
    np.testing.assert_array_equal(results.decode_grid_rle(env["occupancy"]), scenario.blocked)
    docs = []
    for module in (results, jax_results):
        log = module.ResultsLog(settings={"a": 1})
        log.log_run(PLANNER, path, stats, extra={"iterations": 3}, environment=env)
        docs.append(module.ResultsLog.load(log.save(tmp_path / f"{module.__name__}.json")))
    assert docs[0]["runs"] == docs[1]["runs"]
    assert docs[0].keys() == docs[1].keys() == {"timestamp", "runs"}


def test_suite_refuses_to_start_without_the_native_evaluator(monkeypatch):
    monkeypatch.setattr(runner, "active_evaluator", lambda: "numpy")
    monkeypatch.setattr(runner, "ConstrainedSolver", None)  # never reached
    with pytest.raises(RuntimeError, match="refusing to start"):
        suite(pair(), require_native_evaluator=True)


def test_suite_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is taken, not refused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_grid_suite(pair(), small_parameters())


# tests/test_runner.py's control flow, on the port alone


def test_multi_round_restarts_stop_at_budget():
    result = suite(pair(), restart_failed=2, restart_rounds=2)
    assert bool(result.feasible[0]) and not bool(result.feasible[1])
    assert result.restart_rounds_used == 2
    assert result.log.settings["suite"]["restart_rounds_used"] == 2


def test_restart_noop_when_all_feasible():
    base = suite([wall_scenario()])
    with_restart = suite([wall_scenario()], restart_failed=4, restart_rounds=3)
    assert bool(base.feasible[0]) and bool(with_restart.feasible[0])
    assert with_restart.restart_rounds_used == 0
    np.testing.assert_array_equal(base.paths, with_restart.paths)
    np.testing.assert_array_equal(base.iterations, with_restart.iterations)


def test_shapes_pinned_endpoints_and_schema(plateau):
    assert plateau.paths.shape == (2, 26, 3)
    assert plateau.feasible.all() and (plateau.iterations > 0).all()
    scenario = wall_scenario()
    np.testing.assert_allclose(plateau.paths[0, 0], scenario.start, atol=1e-5)
    np.testing.assert_allclose(plateau.paths[0, -1], scenario.goal, atol=1e-5)
    assert plateau.log.runs[0]["plans"][PLANNER]["stats"]["path_found"] is True


def test_full_budget_no_worse(plateau):
    full = suite([wall_scenario(), wall_scenario()], stop_on_plateau=False)
    assert full.feasible.all() and (full.iterations == FAST["max_iterations"]).all()
    assert (full.lengths <= plateau.lengths + 1e-5).all()


def test_shortcut_shortens_without_breaking(plateau):
    short = suite([wall_scenario(), wall_scenario()], shortcut_trials=32)
    assert short.feasible.all()
    assert (short.lengths <= plateau.lengths + 1e-5).all()
    np.testing.assert_allclose(short.paths[:, 0], plateau.paths[:, 0], atol=1e-5)
    np.testing.assert_allclose(short.paths[:, -1], plateau.paths[:, -1], atol=1e-5)
    stats = short.log.runs[0]["plans"][PLANNER]["stats"]
    assert abs(stats["path_length"] - float(short.lengths[0])) < 1e-3
    suite_log = short.log.settings["suite"]
    assert suite_log["shortcut_trials"] == 32
    assert suite_log["repaired_by_shortcut"] == short.repaired_by_shortcut == 0


def test_shortcut_noop_on_infeasible(port_pair):
    shortcut_and_restarts, _ = port_pair
    base = suite(pair())
    assert not bool(shortcut_and_restarts.feasible[1])
    np.testing.assert_array_equal(shortcut_and_restarts.paths[1], base.paths[1])


def test_suite_checkpoint_and_resume(plateau, tmp_path):
    """A checkpointed suite equals the plain one bit for bit, and resuming
    from its completed checkpoint gives it again."""
    kw = dict(checkpoint_path=tmp_path / "suite.npz", checkpoint_every_chunks=2)
    first = suite([wall_scenario(), wall_scenario()], **kw)
    assert (tmp_path / "suite.npz").exists()
    np.testing.assert_array_equal(first.paths, plateau.paths)
    again = suite([wall_scenario(), wall_scenario()], resume=True, **kw)
    np.testing.assert_array_equal(again.paths, first.paths)
    np.testing.assert_array_equal(again.iterations, first.iterations)
