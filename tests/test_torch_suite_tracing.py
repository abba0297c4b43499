"""The suite runner's spans and the counters of the tracked loop and of the
program store, on the CPU: `run_grid_suite` records `suite` and its parts
(`suite.wavefront`, `suite.init`, `suite.solve`, `suite.shortcut`,
`suite.restart` with its lanes, `suite.evaluate`) only under a profile;
the tracked loop counts the lane-steps it computes and those of problems
still active with its one host read per chunk; `aot_or_compile` counts its
captures and not the programs it takes from the store."""
import contextlib
from typing import NamedTuple

import numpy as np
import pytest
import torch

from nfopp_tpu_torch.bench.runner import run_grid_suite
from nfopp_tpu_torch.parallel.mesh import RowLayout, count_over_problems
from nfopp_tpu_torch.solver import run_with_tracking
from nfopp_tpu_torch.solver import tracking
from nfopp_tpu_torch.utils import aot, profiling
from nfopp_tpu_torch.utils.config import AttributeDict
from nfopp_tpu_torch.worlds import GridOracle, GridScenario, grid_collision
from torch_threads import one_thread  # noqa: F401

CPU = [torch.profiler.ProfilerActivity.CPU]
PARTS = ["suite.wavefront", "suite.init", "suite.solve", "suite.shortcut", "suite.restart",
         "suite.evaluate"]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def tiny_suite():
    """Two 16 x 16 worlds whose goal cell is rock, so that every problem
    fails and the restart round runs: 20 iterations, N=8, 2 restarts."""
    blocked = np.zeros((16, 16), bool)
    blocked[12:, 12:] = True
    scenarios = [GridScenario(blocked, 1.0, (0.0, 0.0), np.array([2.5, 2.5, 0.0], np.float32),
                              np.array([13.5, 13.5, 0.0], np.float32)) for _ in range(2)]
    parameters = AttributeDict(
        trajectory_length=8,
        collision_model=AttributeDict(sigma=5.0, use_normal_init=True, angle_encoding=True),
        collision_optimizer=AttributeDict(lr=2e-2), trajectory_optimizer=AttributeDict(lr=5e-2),
        planner=AttributeDict(init_collision_iteration=2, init_collision_points=16,
                              collision_point_count=8, random_field_points=2))
    return dict(scenarios=scenarios, parameters=parameters, max_iterations=20,
                min_iterations=10, check_freq=10, shortcut_trials=4, restart_failed=2,
                device="cpu", aot=True)


def test_the_suite_records_its_parts_only_under_a_profile():
    result = run_grid_suite(**tiny_suite())
    assert profiling.spans() == [] and not result.feasible.any()
    with torch.profiler.profile(activities=CPU):
        run_grid_suite(**tiny_suite())
    records = profiling.spans()
    suite = records[0]
    assert suite.name == "suite" and suite.parent is None
    assert suite.attrs == {"batch": 2, "aot": True}
    parts = [r for r in records if r.parent == suite.id]
    assert [r.name for r in parts] == PARTS
    assert parts[4].attrs == {"lanes": 4}
    assert all(suite.start_ns <= r.start_ns <= r.end_ns <= suite.end_ns for r in parts)
    # the restart round's init, tracked solve and shortcut lie inside its span
    assert {r.name for r in records if r.parent == parts[4].id} == {"init", "run", "sync",
                                                                    "evaluate"}
    assert [r.name for r in records if r.parent is None] == ["suite"]


class Moving(NamedTuple):
    trajectory: torch.Tensor
    velocity: torch.Tensor
    start: torch.Tensor
    goal: torch.Tensor
    step_count: torch.Tensor


class MovingSolver:
    """A stand-in solver: `run` moves each path by a fixed velocity a step."""

    oracle_fn = staticmethod(grid_collision)
    layout = RowLayout.alone("cpu")

    def run(self, state, oracle_params, num_steps, noise):
        return state._replace(trajectory=state.trajectory + num_steps * state.velocity,
                              step_count=state.step_count + num_steps), None

    def full_trajectory(self, state):
        return torch.cat([state.start[:, None], state.trajectory, state.goal[:, None]], dim=1)

    def live_rows(self, live):
        return contextlib.nullcontext()  # no field kernels to skip


def test_the_tracked_loop_counts_its_lane_steps_with_one_read_a_chunk():
    """In an empty world, a path that stays put stops at the first check
    past min_iterations that does not improve (4 chunks), one that
    straightens improves at every check and runs all 10: the loop computes
    10 chunks of both, and the active lanes' steps are 4 + 10 chunks; the
    6 chunks after the first stop run it under live rows, skipping its row
    (no card, so no chunk counts as one wave). Each pass of the loop reads
    the card once (a `sync` span): 11 reads."""
    n = 6
    bump = torch.sin(torch.linspace(0, np.pi, n + 2)[1:-1])
    traj = torch.zeros((2, n, 3))
    traj[:, :, 0] = torch.linspace(2.0, 14.0, n + 2)[1:-1]
    traj[:, :, 1] = 8.0 + 3.0 * bump
    velocity = torch.zeros((2, n, 3))
    velocity[1, :, 1] = -0.002 * bump
    ends = torch.tensor([[2.0, 8.0, 0.0]] * 2)
    goals = ends.clone()
    goals[:, 0] = 14.0
    state = Moving(traj, velocity, ends, goals, torch.zeros(2, dtype=torch.int32))
    oracle = GridOracle(torch.zeros((1, 16, 16), dtype=torch.bool), torch.zeros((1, 2)),
                        torch.ones(1), torch.tensor([[0.0, 16.0, 0.0, 16.0]]))
    before = dict(tracking.LANE_STEPS)
    with torch.profiler.profile(activities=CPU):
        result = run_with_tracking(MovingSolver(), state, oracle, "noise", 500, 100, 50)
    assert result.iterations.tolist() == [200, 500]
    assert {k: n - before[k] for k, n in tracking.LANE_STEPS.items()} == {
        "computed": 10 * 2 * 50, "active": (4 + 10) * 50, "skipped": 6 * 1 * 50,
        "one_wave": 0}
    assert [r.name for r in profiling.spans()].count("sync") == 11


def test_count_over_problems_is_one_sync():
    with torch.profiler.profile(activities=CPU):
        assert count_over_problems(torch.tensor([True, False, True]), None) == (2, 2)
        assert count_over_problems(torch.tensor([False]), None) == (0, 0)
    assert [r.name for r in profiling.spans()] == ["sync", "sync"]


def test_captures_are_counted_and_store_hits_are_not(monkeypatch):
    """With the capture itself stood in for (the CPU has no graphs): a new
    key counts one capture, the same key again none, a bypassed store one
    each time."""
    monkeypatch.setattr(aot, "_device", lambda args: torch.device("cuda"))
    monkeypatch.setattr(aot, "_capture", lambda fn, args, device: fn)
    monkeypatch.setattr(aot, "_PROGRAMS", {})
    before = aot.CAPTURES["programs"]
    args = (torch.zeros(3),)
    first = aot.aot_or_compile("counted", torch.neg, args, 1)
    again = aot.aot_or_compile("counted", torch.neg, args, 1)
    assert not first.loaded and again.loaded
    assert aot.CAPTURES["programs"] == before + 1
    aot.aot_or_compile("counted", torch.neg, args, 2)
    aot.aot_or_compile("counted", torch.neg, args, 2, enabled=False)
    assert aot.CAPTURES["programs"] == before + 3
