"""The port's BatchPlanner (nfopp_tpu_torch.parallel) on the CPU: the
trajectory override of init_batch, the shared-field init, solves equal to
the tracked loops they wrap, checkpointed solves that resume bit for bit
(tests/test_checkpoint_resume.py's cases), and the best-restart choice of
solve_multi_query / solve_portfolio held against JAX's `_best_per_query`
on hand-made results. Small solver (N=12, K=12, R=4, hidden 16, B=8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.parallel.batch import _best_per_query as jax_best_per_query
from nfopp_tpu.solver.tracking import TrackingResult as JaxTrackingResult
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.parallel import BatchPlanner
from nfopp_tpu_torch.parallel import batch as batch_module
from nfopp_tpu_torch.parallel.batch import _best_per_query
from nfopp_tpu_torch.solver import (
    ConstrainedSolver,
    HolonomicSolver,
    SolverConfig,
    TrackingResult,
    run_with_tracking,
)
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    circle_collision,
    pad_obstacle_points,
    two_walls_se2_environment,
)
from torch_threads import one_thread  # noqa: F401


BATCH = 8
SOLVE_KW = dict(max_iterations=80, min_iterations=20, check_freq=10)
CONFIG = SolverConfig(trajectory_length=12, collision_point_count=12, random_field_points=4,
                      onf=ONFConfig(angle_encoding=True, hidden=16), angle_offset=0.3)


def setup(batch=BATCH, seed=0):
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    oracle = CircleOracle(torch.tensor(pts)[None].repeat(batch, 1, 1),
                          torch.tensor(mask)[None].repeat(batch, 1), torch.full((batch,), 0.3),
                          torch.tensor([[0.0, 3.0, 0.0, 3.0]]).repeat(batch, 1))
    planner = BatchPlanner(ConstrainedSolver(CONFIG, circle_collision, device="cpu"))
    tile = lambda a: np.tile(np.asarray(a, np.float32)[None], (batch, 1))  # noqa: E731
    ends = tile(env.start), tile(env.goal), tile(env.bounds)
    states = planner.init_batch(torch.Generator().manual_seed(seed), *ends, oracle)
    return planner, states, oracle, ends, env


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def result_tuple(r):
    return (r.path, r.length, r.feasible, r.iterations)


def test_init_batch_takes_the_trajectory_override():
    planner, states, oracle, (starts, goals, bounds), _ = setup()
    custom = torch.rand((BATCH, CONFIG.trajectory_length, 3), generator=torch.Generator())
    overridden = planner.init_batch(torch.Generator().manual_seed(0), starts, goals, bounds,
                                    oracle, custom)
    assert torch.equal(overridden.trajectory, custom)
    assert torch.equal(overridden.prev_trajectory, custom)
    # everything else is drawn as without the override
    assert same(overridden.field_params, states.field_params)
    straight = planner.solver.initial_trajectory(torch.tensor(starts), torch.tensor(goals))
    assert torch.equal(states.trajectory, straight)


def test_init_batch_grouped_shares_each_groups_field():
    planner, _, oracle, ends, _ = setup()
    states = planner.init_batch_grouped(torch.Generator().manual_seed(1), *ends, oracle, 4)
    for leaf in tree_leaves(states.field_params):
        assert torch.equal(leaf[0], leaf[3]) and not torch.equal(leaf[0], leaf[4])
    with pytest.raises(ValueError, match="not divisible"):
        planner.init_batch_grouped(torch.Generator(), *ends, oracle, 3)
    holonomic = BatchPlanner(HolonomicSolver(CONFIG._replace(onf=ONFConfig(angle_encoding=False)),
                                             circle_collision, device="cpu"))
    with pytest.raises(NotImplementedError, match="shared-field"):
        holonomic.init_batch_grouped(torch.Generator(), *ends, oracle, 4)


def test_solve_and_run_are_the_solvers_loops():
    planner, states, oracle, _, _ = setup()
    got = planner.solve(states, oracle, torch.Generator().manual_seed(2), **SOLVE_KW)
    want = run_with_tracking(planner.solver, states, oracle, torch.Generator().manual_seed(2),
                             **SOLVE_KW)
    assert same(result_tuple(got), result_tuple(want))
    stepped, aux = planner.run(states, oracle, 10, torch.Generator().manual_seed(3))
    assert aux.field_loss.shape == (BATCH, 10)
    assert planner.paths(stepped).shape == (BATCH, CONFIG.trajectory_length + 2, 3)


def test_checkpointed_solve_equals_the_plain_solve(tmp_path):
    """One segment or many: the same computation on the same noise."""
    planner, states, oracle, _, _ = setup()
    plain = planner.solve(states, oracle, torch.Generator().manual_seed(4),
                          stop_on_plateau=False, **SOLVE_KW)
    ckpt = planner.solve_checkpointed(states, oracle, torch.Generator().manual_seed(4),
                                      tmp_path / "run", stop_on_plateau=False,
                                      checkpoint_every_chunks=3, **SOLVE_KW)
    assert same(result_tuple(ckpt), result_tuple(plain))
    assert (tmp_path / "run.npz").exists()


def test_kill_and_resume_bit_identical(tmp_path, monkeypatch):
    planner, states, oracle, _, _ = setup()
    kw = dict(stop_on_plateau=False, checkpoint_every_chunks=2, **SOLVE_KW)
    full = planner.solve_checkpointed(states, oracle, torch.Generator().manual_seed(5),
                                      tmp_path / "uninterrupted.npz", **kw)

    real_save, calls = batch_module.save_state, {"n": 0}

    def dying_save(*args, **kwargs):
        out = real_save(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] >= 2:
            raise KeyboardInterrupt("simulated preemption")
        return out

    monkeypatch.setattr(batch_module, "save_state", dying_save)
    with pytest.raises(KeyboardInterrupt):
        planner.solve_checkpointed(states, oracle, torch.Generator().manual_seed(5),
                                   tmp_path / "killed.npz", **kw)
    monkeypatch.setattr(batch_module, "save_state", real_save)
    # a fresh process: the same init, a generator seeded anew (the
    # checkpoint sets it back to where the killed solve was)
    resumed = planner.solve_checkpointed(states, oracle, torch.Generator().manual_seed(5),
                                         tmp_path / "killed.npz", resume=True, **kw)
    assert same(result_tuple(resumed), result_tuple(full))
    again = planner.solve_checkpointed(states, oracle, torch.Generator().manual_seed(99),
                                       tmp_path / "killed.npz", resume=True, **kw)
    assert same(result_tuple(again), result_tuple(full))  # completed: finalize only


def test_plateau_stop_skips_the_remaining_segments(tmp_path, monkeypatch):
    """An empty world (every obstacle masked out): every problem finds a
    path that stops improving, and no checkpoint is written after that."""
    planner, _, oracle, ends, _ = setup()
    oracle = oracle._replace(mask=torch.zeros_like(oracle.mask))
    states = planner.init_batch(torch.Generator().manual_seed(0), *ends, oracle)
    saves = []
    real_save = batch_module.save_state
    monkeypatch.setattr(batch_module, "save_state",
                        lambda *a, **k: saves.append(1) or real_save(*a, **k))
    result = planner.solve_checkpointed(states, oracle, torch.Generator().manual_seed(6),
                                        tmp_path / "p.npz", checkpoint_every_chunks=1,
                                        max_iterations=200, min_iterations=20, check_freq=10)
    want = planner.solve(states, oracle, torch.Generator().manual_seed(6), max_iterations=200,
                         min_iterations=20, check_freq=10)
    assert same(result_tuple(result), result_tuple(want))
    assert len(saves) == int(want.iterations.max()) // 10 < 20


def hand_made(feasible, length):
    """JAX's and the port's TrackingResult for the same query-major lanes."""
    n = len(feasible)
    path = np.arange(n * 4 * 3, dtype=np.float32).reshape(n, 4, 3)
    iterations = np.arange(n, dtype=np.int32) * 50
    jax_result = JaxTrackingResult(None, jnp.asarray(path), jnp.asarray(length, jnp.float32),
                                   jnp.asarray(feasible), jnp.asarray(iterations))
    port = TrackingResult({"x": torch.arange(n)}, torch.tensor(path),
                          torch.tensor(length, dtype=torch.float32), torch.tensor(feasible),
                          torch.tensor(iterations))
    return jax_result, port


@pytest.mark.parametrize("feasible,length", [
    # best feasible per query; an infeasible shorter lane loses
    ([True, False, True, True, True, False], [3.0, 1.0, 2.0, 5.0, 4.0, 0.5]),
    # ties: the first of equal lengths; no feasible lane: the first lane
    ([True, True, False, False, False, False], [2.0, 2.0, 1.0, 1.0, 9.0, 3.0]),
])
def test_best_per_query_picks_as_jax(feasible, length):
    jax_result, port = hand_made(feasible, length)
    want = jax_best_per_query(jax_result, 2, 3)
    got = _best_per_query(port, 2, 3)
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(want.path))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_array_equal(got.feasible.numpy(), np.asarray(want.feasible))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.state["x"].numpy(), np.asarray(want.iterations) // 50)


@pytest.mark.parametrize("shared_field", [True, False])
def test_multi_query_and_portfolio_pick_the_best_restart(shared_field, monkeypatch):
    planner, _, oracle, _, env = setup(batch=1)
    one_map = CircleOracle(*(leaf[:1] for leaf in oracle))
    starts = np.stack([env.start, env.start]).astype(np.float32)
    goals = np.stack([env.goal, [2.5, 0.5, 0.0]]).astype(np.float32)
    seen = {}
    real = batch_module._best_per_query

    def spy(result, k, restarts):
        seen["lanes"] = result
        return real(result, k, restarts)

    monkeypatch.setattr(batch_module, "_best_per_query", spy)
    result = planner.solve_multi_query(torch.Generator().manual_seed(7), starts, goals,
                                       env.bounds, one_map, restarts=2, max_iterations=40,
                                       min_iterations=10, check_freq=10,
                                       shared_field=shared_field)
    assert result.path.shape == (2, CONFIG.trajectory_length + 2, 3)
    lanes = seen["lanes"]
    score = torch.where(lanes.feasible, lanes.length, torch.inf).reshape(2, 2)
    for q in range(2):
        best = 2 * q + int(torch.argmin(score[q]))
        assert torch.equal(result.path[q], lanes.path[best])
        np.testing.assert_allclose(result.path[q, -1].numpy(), goals[q], atol=1e-5)
    single = planner.solve_portfolio(torch.Generator().manual_seed(8), env.start, env.goal,
                                     env.bounds, one_map, restarts=2, max_iterations=40,
                                     min_iterations=10, check_freq=10, shared_field=shared_field)
    assert single.path.shape == (CONFIG.trajectory_length + 2, 3) and single.feasible.ndim == 0


def test_planner_device_rule():
    solver = ConstrainedSolver(CONFIG, circle_collision, device="cpu")
    assert BatchPlanner(solver).device == torch.device("cpu")
    assert BatchPlanner(solver, device="cpu").device_count == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchPlanner(solver, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ConstrainedSolver(CONFIG, circle_collision)
