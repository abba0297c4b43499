"""The port's suite path on grid worlds against the benchmark's plain
reference (`nfbench/reference/grid_suite.py`), on the CPU at a small size:
the benchmark's own corridor worlds equal the port's generator's; grid
labels and the wavefront init on four corridor worlds; `init_state` with
five pretraining iterations; one 10-step chunk; the tracked loop's
decision at every check and its final selection; the shortcut pass on
fixed pairs; and the restart selection of `run_grid_suite` on constructed
lane results. The solver is the corridor configuration's
(`nfbench/configs/corridor-benchmr.json`) at N=24, hidden 32."""
import contextlib
import importlib.util
import json
import pathlib
from typing import NamedTuple

import numpy as np
import pytest
import torch

from nfopp_tpu_torch.astar.initializer import batched_wavefront_trajectories
from nfopp_tpu_torch.bench import runner
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.ops.shortcut import shortcut_batch
from nfopp_tpu_torch.parallel.mesh import RowLayout
from nfopp_tpu_torch.solver import (
    ConstrainedSolver,
    SolverConfig,
    TrackingResult,
    run_tracking_segment,
    tracking_finalize,
    tracking_init,
)
from nfopp_tpu_torch.worlds import GridScenario, corridor, distant_endpoints, grid_collision
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, HIDDEN = 24, 32


def load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = load(ROOT / "nfbench" / "reference" / "grid_suite.py", "grid_suite_reference")
worlds_module = load(ROOT / "nfbench" / "drivers" / "corridor_worlds.py", "corridor_worlds")
CONFIG = json.loads((ROOT / "nfbench" / "configs" / "corridor-benchmr.json").read_text())


def reference_config(pretraining: int) -> dict:
    cfg = json.loads(json.dumps(CONFIG["solver"]))
    cfg.update(trajectory_length=N, collision_point_count=24, random_field_points=4,
               init_collision_points=64, init_collision_iteration=pretraining)
    cfg["onf"]["hidden"] = HIDDEN
    return cfg


def program_solver(cfg: dict) -> ConstrainedSolver:
    onf = cfg["onf"]
    fields = {k: v for k, v in cfg.items() if k != "onf"}
    for key in ("collision_betas", "trajectory_betas"):
        fields[key] = tuple(fields[key])
    config = SolverConfig(
        onf=ONFConfig(mean=onf["mean"], sigma=onf["sigma"], use_cos=onf["use_cos"],
                      use_normal_init=onf["use_normal_init"], bias=onf["bias"],
                      angle_encoding=onf["angle_encoding"], hidden=onf["hidden"]),
        **fields)
    return ConstrainedSolver(config, grid_collision, device="cpu")


@pytest.fixture(scope="module")
def suite():
    """Four corridor worlds from the benchmark's generator: the program's
    oracles and the reference's world, both dilated by the footprint."""
    sc = CONFIG["scene"]
    built = worlds_module.build([11, 12, 13, 14], [21, 22, 23, 24], sc["grid_cells"],
                                sc["branches"], sc["radius_cells"], sc["min_geodesic"])
    scenarios = [GridScenario(grid, 1.0, (0.0, 0.0), start, goal) for grid, start, goal in built]
    oracles = runner._stack_oracles([s.oracle(sc["footprint_radius"], "cpu") for s in scenarios])
    world = ref.grid_world([grid for grid, _, _ in built], 1.0, sc["footprint_radius"], "cpu")
    starts = torch.tensor(np.stack([s.start for s in scenarios]))
    goals = torch.tensor(np.stack([s.goal for s in scenarios]))
    bounds = torch.tensor(np.stack([np.asarray(s.bounds, np.float32) for s in scenarios]))
    return scenarios, oracles, world, starts, goals, bounds


def test_the_benchmark_worlds_are_the_port_generator_worlds():
    """Given the port's seeds, the benchmark's corridor grids and resampled
    endpoints equal `worlds.corridor` and `distant_endpoints` bit for bit."""
    for seed in (0, 7, 2 ** 31 + 5):
        (grid, start, goal), = worlds_module.build([seed], [1000 + seed], 100, 100, 3, 120.0)
        scenario = corridor(seed=seed, size=100, branches=100, radius=3)
        assert np.array_equal(grid, scenario.blocked)
        want = distant_endpoints(np.random.RandomState(1000 + seed), scenario, 120.0,
                                 device="cpu")
        assert np.array_equal(start, want[0]) and np.array_equal(goal, want[1])


def test_grid_labels_and_the_wavefront_init(suite):
    """Labels bit for bit, at random poses, poses on cell borders and poses
    outside the bounds; the wavefront paths within 1e-4 m and rad (the
    program resamples in float32, the reference in float64: a walk that
    took another cell would be off by half a metre)."""
    scenarios, oracles, world, starts, goals, bounds = suite
    assert torch.equal(oracles.occupancy, world["occupancy"])
    g = torch.Generator().manual_seed(0)
    poses = torch.cat([torch.rand((4, 500, 3), generator=g) * 120 - 10,
                       torch.randint(0, 101, (4, 200, 3), generator=g).float()], dim=1)
    assert torch.equal(grid_collision(oracles, poses), ref.grid_labels(world, poses))
    got = batched_wavefront_trajectories(oracles.occupancy, starts, goals, torch.zeros(4, 2),
                                         torch.ones(4), N)
    occupancy = world["occupancy"].numpy()
    want = np.stack([ref.wavefront(occupancy[b], scenarios[b].start, scenarios[b].goal, 1.0, N)
                     for b in range(4)])
    assert np.abs(got.double().numpy() - want).max() < 1e-4


def test_init_state_with_five_pretraining_iterations(suite):
    """The same draws give the same buffer, trajectory and first moments of
    the field's optimizer up to f32 rounding, and fields whose occupancy
    probability agrees within 1e-4 at 256 poses a problem (measured: ~1e-6;
    the reference in TF32 is off by ~0.05 after two iterations)."""
    scenarios, oracles, world, starts, goals, bounds = suite
    cfg = reference_config(5)
    solver, planner = program_solver(cfg), ref.GridPlanner(cfg, "cpu")
    traj = batched_wavefront_trajectories(oracles.occupancy, starts, goals, torch.zeros(4, 2),
                                          torch.ones(4), N)
    state = solver.init_state(torch.Generator().manual_seed(5), starts, goals, bounds, oracles,
                              trajectory=traj)
    want = planner.init_state(torch.Generator().manual_seed(5), starts, goals, bounds, world,
                              trajectory=traj)
    assert torch.equal(state.buffer_points, want["buf"])
    assert torch.equal(state.trajectory, want["trajectory"])
    assert torch.equal(state.field_opt_state.count, want["fopt"]["count"])
    poses = ref.se2.uniform_box(torch.rand((4, 256, 3), generator=torch.Generator().manual_seed(6)),
                                bounds)
    gap = (planner.probability(dict(state.field_params), poses)
           - planner.probability(want["params"], poses)).abs().max()
    assert gap < 1e-4


def test_one_ten_step_chunk(suite):
    """From the program's state after 30 steps, 10 more steps with the same
    generator state: paths within 1e-3 m (the 90th percentile of the
    benchmark's limit; measured ~1e-5, the reference in TF32 ~0.1 m)."""
    scenarios, oracles, world, starts, goals, bounds = suite
    cfg = reference_config(5)
    solver, planner = program_solver(cfg), ref.GridPlanner(cfg, "cpu")
    traj = batched_wavefront_trajectories(oracles.occupancy, starts, goals, torch.zeros(4, 2),
                                          torch.ones(4), N)
    g = torch.Generator().manual_seed(7)
    state = solver.init_state(g, starts, goals, bounds, oracles, trajectory=traj)
    state, _ = solver.run(state, oracles, 30, g)
    g_state = g.get_state()
    after, _ = solver.run(state, oracles, 10, g)
    g2 = torch.Generator()
    g2.set_state(g_state)
    from_state = {"trajectory": state.trajectory, "params": dict(state.field_params),
                  "fopt": {"count": state.field_opt_state.count,
                           "mu": state.field_opt_state.mu, "nu": state.field_opt_state.nu},
                  "topt": {"count": state.traj_opt_state.count,
                           "mu": state.traj_opt_state.mu, "nu": state.traj_opt_state.nu},
                  "cmult": state.constraint_multipliers, "kmult": state.collision_multipliers,
                  "buf": state.buffer_points, "ages": state.buffer_ages,
                  "prev": state.prev_trajectory, "start": state.start, "goal": state.goal,
                  "bounds": state.bounds, "count": state.step_count}
    want = ref.se2.Planner.full_path(planner.run(from_state, g2, world, 10))
    assert (solver.full_trajectory(after) - want).abs().max() < 1e-3


# ------------------------------------------------------- the tracked loop

class Moving(NamedTuple):
    trajectory: torch.Tensor  # [B, N, 3]
    velocity: torch.Tensor  # [B, N, 3] per step
    start: torch.Tensor
    goal: torch.Tensor
    step_count: torch.Tensor


class MovingSolver:
    """A stand-in solver whose `run` moves each path by a fixed velocity per
    step, so that the loop's bookkeeping is seen on known paths."""

    oracle_fn = staticmethod(grid_collision)
    layout = RowLayout.alone("cpu")

    def run(self, state, oracle_params, num_steps, noise):
        return state._replace(trajectory=state.trajectory + num_steps * state.velocity,
                              step_count=state.step_count + num_steps), None

    def full_trajectory(self, state):
        return torch.cat([state.start[:, None], state.trajectory, state.goal[:, None]], dim=1)

    def live_rows(self, live):
        return contextlib.nullcontext()  # no field kernels to skip


def wall_world():
    """A 20 x 20 grid with a wall at rows 9-10 from x = 4 to x = 16, and
    four problems from (2, 6) to (18, 6): bumps that cross the wall and
    come down out of it at two rates, one across it that never moves, and
    one below it that grows, which is feasible at once and stops early on
    the plateau."""
    blocked = np.zeros((20, 20), bool)
    blocked[9:11, 4:16] = True
    n = 12
    x = np.linspace(2.0, 18.0, n + 2)[1:-1]
    bump = np.sin(np.linspace(0, np.pi, n + 2)[1:-1])
    traj = np.zeros((4, n, 3), np.float32)
    vel = np.zeros((4, n, 3), np.float32)
    for p, (height, rate) in enumerate([(6.0, -0.004), (7.0, -0.007), (5.0, 0.0), (1.0, 0.004)]):
        traj[p, :, 0], traj[p, :, 1] = x, 6.0 + height * bump
        vel[p, :, 1] = rate * bump
    ends = np.tile(np.array([[2.0, 6.0, 0.0]], np.float32), (4, 1))
    goals = ends.copy()
    goals[:, 0] = 18.0
    state = Moving(*(torch.tensor(a) for a in (traj, vel, ends, goals)),
                   torch.zeros(4, dtype=torch.int32))
    oracle = runner._stack_oracles([GridScenario(blocked, 1.0).oracle(0.0, "cpu")] * 4)
    return state, oracle, ref.grid_world([blocked] * 4, 1.0, 0.0, "cpu")


@pytest.mark.parametrize("plateau", [True, False])
def test_the_tracked_loop_decides_as_the_reference(plateau):
    """At every check, the program's collisions, lengths, improvements,
    stops and carry equal the reference's recomputation from the program's
    paths and carry before the check; frozen problems keep their paths; and
    the final selection is the reference's."""
    state, oracle, world = wall_world()
    solver, check, min_iterations, chunks = MovingSolver(), 50, 200, 20
    carry = tracking_init(solver, state)
    stopped = False
    for end in range(1, chunks + 1):
        before = {k: getattr(carry, k) for k in ("best_length", "done", "iterations", "chunk")}
        new = run_tracking_segment(solver, carry, oracle, end, "noise", min_iterations, check, 5,
                                   plateau)
        path = solver.full_trajectory(new.state)
        want = ref.check(before, path, world, chunks, check, min_iterations, 5, plateau)
        for key in ("done", "iterations", "chunk", "best_length"):
            assert torch.equal(getattr(new, key), want[key]), (end, key)
        assert torch.equal(new.best_path, torch.where(want["improves"][:, None, None], path,
                                                      carry.best_path))
        frozen = ~want["active"]
        assert torch.equal(path[frozen], solver.full_trajectory(carry.state)[frozen])
        stopped |= bool(frozen.any())
        carry = new
    assert stopped == plateau
    result = tracking_finalize(solver, carry, oracle, 5, plateau)
    path, length, feasible = ref.final_selection(carry.best_path, carry.best_length,
                                                 solver.full_trajectory(carry.state), world, 5,
                                                 plateau)
    assert torch.equal(result.path, path) and torch.equal(result.length, length)
    assert torch.equal(result.feasible, feasible)
    assert feasible[0] and feasible[3] and not feasible[2]


# --------------------------------------------------- shortcut and restarts

def test_the_shortcut_pass_on_fixed_pairs(suite):
    """The program's shortcut trials and its pass (`runner._shortcut_pass`)
    give the reference's paths, lengths and feasibility bit for bit on the
    wavefront paths (N=100), two of them with one waypoint moved onto the
    nearest rock cell, which the pass may repair."""
    scenarios, oracles, world, starts, goals, bounds = suite
    traj = batched_wavefront_trajectories(oracles.occupancy, starts, goals, torch.zeros(4, 2),
                                          torch.ones(4), 100)
    for b in (2, 3):  # waypoint 50 onto the nearest rock cell
        rock = torch.nonzero(oracles.occupancy[b]).float().flip(1) + 0.5
        traj[b, 50, :2] = rock[torch.argmin(((rock - traj[b, 50, :2]) ** 2).sum(1))]
    paths = torch.cat([starts[:, None], traj, goals[:, None]], dim=1)
    g = torch.Generator().manual_seed(9)
    m, trials = paths.shape[1], 64
    i = torch.randint(0, m - 2, (trials, 4), generator=g)
    j = i + 2 + (torch.rand((trials, 4), generator=g) * (m - i - 2)).long()
    pairs = torch.stack([i, torch.clamp(j, max=m - 1)], dim=-1)
    assert torch.equal(shortcut_batch(grid_collision, oracles, paths, pairs, trials),
                       ref.shortcut(world, paths, pairs))
    collides, lengths = ref.collides_and_length(world, paths)
    numpy_paths, feasible = paths.numpy(), ~collides.numpy()
    solver = program_solver(reference_config(0))

    class Pairs:
        def __call__(self, noise, num_trials, batch, m, device):
            return pairs

    original = runner.shortcut_pairs
    runner.shortcut_pairs = Pairs()
    try:
        got = runner._shortcut_pass(solver, oracles, numpy_paths, lengths.numpy(), feasible,
                                    None, trials)
    finally:
        runner.shortcut_pairs = original
    want = ref.shortcut_pass(world, numpy_paths, lengths.numpy(), feasible, pairs)
    for a, b in zip(got[:3], want):
        assert np.array_equal(a, b)
    assert feasible[:2].all() and not feasible[2:].any() and got[3][2:].any()


def test_the_restart_selection_on_constructed_lanes(monkeypatch):
    """`run_grid_suite` keeps, for each problem the base solve left
    infeasible, the shortest feasible of its lanes (the first of equals),
    or its own path where none is: the reference's choice, on a planner
    whose solves return constructed results."""
    blocked = np.zeros((16, 16), bool)
    scenarios = [GridScenario(blocked, 1.0, (0.0, 0.0), np.array([2.0, 2.0, 0.0], np.float32),
                              np.array([14.0, 14.0, 0.0], np.float32)) for _ in range(4)]
    r = 3
    base_feasible = np.array([True, False, False, False])
    lane_feasible = np.array([[True, False, True], [False, False, False], [True, True, False]])
    lane_lengths = np.array([[5.0, 1.0, 4.0], [1.0, 1.0, 1.0], [3.0, 3.0, 2.0]], np.float32)
    m = 26

    class Planner:
        def __init__(self, solver, mesh=None, aot_prefix=None):
            self.solver, self.device_count, self.aot_events, self.calls = solver, 1, [], 0
            self.mesh = runner.problem_mesh(device=solver.device)

        def init_batch(self, generator, starts, goals, *args):
            return len(starts)

        def solve(self, batch, *args, **kwargs):
            self.calls += 1
            lanes = torch.arange(batch, dtype=torch.float32)
            paths = (lanes + 100 * self.calls)[:, None, None].expand(batch, m, 3).contiguous()
            if self.calls == 1:
                feasible, length = torch.tensor(base_feasible), torch.full((batch,), 9.0)
            else:
                feasible = torch.tensor(lane_feasible.reshape(-1))
                length = torch.tensor(lane_lengths.reshape(-1))
            return TrackingResult(None, paths, length, feasible,
                                  torch.full((batch,), 50, dtype=torch.int32))

    monkeypatch.setattr(runner, "BatchPlanner", Planner)
    parameters = runner.DEFAULT_PARAMETERS
    result = runner.run_grid_suite(scenarios, parameters, astar_init=False, restart_failed=r,
                                   device="cpu", max_iterations=50, min_iterations=0)
    choice = ref.restart_choice(lane_feasible, lane_lengths)
    assert list(choice) == [2, -1, 0]
    failed = np.where(~base_feasible)[0]
    for j, b in enumerate(failed):
        lane = j * r + choice[j]
        want = 200.0 + lane if choice[j] >= 0 else 100.0 + b
        assert np.all(result.paths[b] == want) and result.feasible[b] == (choice[j] >= 0)
    assert np.all(result.paths[0] == 100.0) and result.feasible[0]
