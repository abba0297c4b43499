"""Benchmark suite runner: a whole suite of grid worlds solved as one batch
on the card (port of `nfopp_tpu/bench/runner.py`).

The reference runs one scenario per subprocess (bench-mr's MPB harness
spawning scripts/run_bench_mr.py, SURVEY.md §3.3) and pools 10 seeds in
notebooks. Here a whole suite (all seeds x scenarios of one world type) is
ONE batch: the worlds are built on the host, every problem is seeded with a
batched wavefront geodesic path, solved at once with best-path tracking and
early stop, shortcut, re-solved as restarts where it failed, and evaluated
with the PathStatistics suite (native C++ evaluator) into a results JSON of
the reference's schema.

Both versions shard the batch over a mesh: JAX's over devices, the port's
over processes, one per card (`mesh=`, `parallel/mesh.py`; default: the
default process group, or this process alone on `device=`, "cuda" unless the
caller asks for the CPU). Every rank builds the same worlds from the same
seeds and keeps its rows for the wavefront init, the solves and the
shortcut pass; their results are gathered, so every host decision (restart
lanes, rounds) and the evaluation see the whole suite on every rank. Where
JAX draws from PRNG keys the port seeds a `torch.Generator` from the same
integers (`seed`, `seed ^ 0x5C0C` for the shortcut, `seed ^ (0x5EED0F +
round * 0x9E3779)` for each restart round), so the worlds, endpoint checks
and initial trajectories equal JAX's and the solves' random streams differ.
"""
from __future__ import annotations

import pathlib
import time
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..astar.initializer import batched_wavefront_trajectories
from ..ops.shortcut import shortcut_batch, shortcut_pairs
from ..parallel import BatchPlanner, batch_sharding, gather_batch, problem_mesh, shard_batch
from ..solver import ConstrainedSolver, config_from_parameters
from ..solver.api import DEFAULT_PARAMETERS
from ..solver.tracking import evaluate_path
from ..utils import profiling
from ..utils.tree import tree_map
from ..worlds.oracle import GridOracle, grid_collision
from ..worlds.scenarios import GridScenario
from .metrics import active_evaluator, path_statistics
from .results import ResultsLog, grid_environment_info

__all__ = ["SuiteResult", "run_grid_suite"]


@dataclass
class SuiteResult:
    paths: np.ndarray  # [B, N+2, 3]
    feasible: np.ndarray  # [B] bool
    lengths: np.ndarray  # [B]
    iterations: np.ndarray  # [B]
    stats: list  # [B] PathStatistics
    wall_time: float
    log: ResultsLog
    # start/goal-in-collision prechecks (the reference exits 3/4 on these,
    # run_bench_mr.py:94-98; batched mode flags per problem instead)
    start_invalid: np.ndarray | None = None  # [B] bool
    goal_invalid: np.ndarray | None = None  # [B] bool
    # provenance: how many infeasible problems the shortcut pass chord-
    # repaired to feasible, and how many restart rounds ran
    repaired_by_shortcut: int = 0
    restart_rounds_used: int = 0


def _shortcut_pass(solver, oracles, paths, lengths, feasible, generator, trials,
                   samples_per_segment: int = 5, mesh=None):
    """Random-pair shortcut pass over a whole path batch: each rank shortens
    its rows (the pairs cut from the block drawn for the whole batch), and
    the results are gathered.

    Returns updated (paths, lengths, feasible, repaired_mask[B]). A candidate
    is taken whenever its dense re-check passes: accepted shortcuts can't
    break feasibility at the same sampling density, and a chord spanning an
    infeasible path's colliding span can even REPAIR it; the per-lane
    repaired mask lets callers attribute rescues exactly."""
    mesh = problem_mesh(device=solver.device) if mesh is None else mesh
    batch, m = paths.shape[:2]
    rows = batch_sharding(mesh, batch)
    pairs = shortcut_pairs(generator, trials, batch, m, solver.device)[:, rows]
    local_oracles = shard_batch(oracles, mesh, batch)
    short = shortcut_batch(solver.oracle_fn, local_oracles,
                           torch.as_tensor(paths[rows], device=solver.device), pairs, trials,
                           samples_per_segment)
    collides_s, lengths_s = evaluate_path(solver.oracle_fn, local_oracles, short,
                                          samples_per_segment)
    short, collides_s, lengths_s = gather_batch((short, collides_s, lengths_s), mesh)
    take = ~collides_s.cpu().numpy()
    repaired_mask = take & ~feasible
    paths = paths.copy()
    lengths = lengths.copy()
    paths[take] = short.cpu().numpy()[take]
    lengths[take] = lengths_s.cpu().numpy()[take]
    return paths, lengths, feasible | take, repaired_mask


def _stack_oracles(oracles: list) -> GridOracle:
    """One batched oracle from per-world oracles (leading axis 1 each)."""
    return type(oracles[0])(*(torch.cat(leaves) for leaves in zip(*oracles)))


def run_grid_suite(
    scenarios: list[GridScenario],
    parameters: Mapping | None = None,
    footprint_radius: float = 0.0,
    max_iterations: int = 1000,
    min_iterations: int = 200,
    check_freq: int = 50,
    seed: int = 0,
    planner_name: str = "constrained_onf_planner",
    astar_init: bool = True,
    stop_on_plateau: bool = True,
    restart_failed: int = 0,
    checkpoint_path=None,
    checkpoint_every_chunks: int = 4,
    resume: bool = False,
    shortcut_trials: int = 0,
    restart_rounds: int = 1,
    require_native_evaluator: bool = False,
    solve_oracles=None,
    oracle_fn=None,
    obstacle_segments: list | None = None,
    device="cuda",
    aot: bool = False,
    mesh=None,
) -> SuiteResult:
    """Solve every scenario in one batch, sharded over `mesh` (default: the
    default process group, or this process alone on `device`); scenarios
    must share grid shape, and every rank passes the same ones. The batch
    must divide over the mesh; restart batches are padded to it.

    astar_init=True seeds each problem with a batched wavefront geodesic path
    (the benchmark-mode AstarTrajectoryInitializer role, run_bench_mr.py:23-27),
    computed on the device against the footprint-dilated grid.

    stop_on_plateau=False spends the full iteration budget refining instead of
    stopping at the reference's first non-improving feasible check (see
    solver.tracking.run_with_tracking).

    restart_failed=R > 0 re-solves every infeasible problem as a batch of R
    fresh random restarts (same world, same init trajectory, new random
    streams) and keeps the shortest feasible restart. restart_rounds=M > 1
    iterates the fallback: problems still infeasible after a round get
    another R fresh streams, up to M rounds or until every problem is
    feasible. The shortcut/repair pass (if enabled) runs BEFORE the restart
    decision, so a chord-repairable problem never costs R full re-solves.

    checkpoint_path enables mid-suite recovery: the tracked solve checkpoints
    its carry and its generator every `checkpoint_every_chunks` chunks
    (BatchPlanner.solve_checkpointed); restart round r uses a sibling
    '<name>-retry.npz' ('<name>-retry<r>.npz' after the first). resume=True
    picks up from the newest checkpoint: everything before the solve (world
    build, init, wavefront) is deterministic, so a killed-and-resumed suite
    is bit-identical to an uninterrupted checkpointed one.

    shortcut_trials=T > 0 runs T random-pair shortcut attempts per path after
    the solve (ops/shortcut.py: the OMPL PathSimplifier role the reference
    never invokes). Feasible paths only get shorter at the same dense-check
    density; a chord spanning an infeasible path's colliding region can
    repair it, and repaired paths are counted feasible.

    solve_oracles + oracle_fn replace the rasterized grid oracle with exact
    geometry (e.g. worlds.oracle.PolygonOracle / polygon_collision); the
    wavefront initializer still seeds from the rasterized grid, and every
    solve, evaluation and shortcut check uses the exact oracle.

    aot=True runs every solve as replays of captured chunk programs
    (`BatchPlanner(aot_prefix="suite")`) and records their `aot_events` in
    the log's suite settings.
    """
    with profiling.span("suite", batch=len(scenarios), aot=aot):
        if parameters is None:
            parameters = DEFAULT_PARAMETERS
        # fail BEFORE the solve: an unavailable native library must not discard
        # minutes of card time at evaluation (checked again post-solve for the log)
        if require_native_evaluator and active_evaluator() != "native":
            raise RuntimeError(
                "native path-statistics evaluator requested but unavailable "
                "(bench/native build failed?) — refusing to start a suite whose "
                "artifacts would silently be numpy-evaluated"
            )
        config = config_from_parameters(parameters)
        oracle_fn = oracle_fn if oracle_fn is not None else grid_collision
        solver = ConstrainedSolver(config, oracle_fn,
                                   device=device if mesh is None else mesh.device)
        # aot=True runs the solves as replays of captured chunk programs
        # (utils/aot.py; keys carry source, config and shape identity)
        planner = BatchPlanner(solver, mesh, aot_prefix="suite" if aot else None)
        device, mesh = solver.device, planner.mesh

        grid_oracles = _stack_oracles([s.oracle(footprint_radius, device) for s in scenarios])
        oracles = solve_oracles if solve_oracles is not None else grid_oracles

        def batched(values) -> torch.Tensor:
            return torch.tensor(np.stack([np.asarray(v, np.float32) for v in values]),
                                device=device)

        starts = batched([s.start for s in scenarios])
        goals = batched([s.goal for s in scenarios])
        bounds = batched([s.bounds for s in scenarios])

        # start/goal validity precheck against the solve oracles
        endpoint_check = oracle_fn(oracles, torch.stack([starts, goals], dim=1)).cpu().numpy()
        start_invalid, goal_invalid = endpoint_check[:, 0], endpoint_check[:, 1]

        t0 = time.time()
        trajectories = None
        if astar_init:
            # each rank plans its rows; the planner takes the whole batch
            rows = batch_sharding(mesh, len(scenarios))
            with profiling.span("suite.wavefront"):
                trajectories = gather_batch(batched_wavefront_trajectories(
                    grid_oracles.occupancy[rows],  # footprint-dilated occupancy [B, H, W]
                    starts[rows], goals[rows], batched([s.origin for s in scenarios])[rows],
                    batched([s.resolution for s in scenarios])[rows], config.trajectory_length,
                ), mesh)
        generator = torch.Generator(device=device).manual_seed(seed)
        with profiling.span("suite.init"):
            states = planner.init_batch(generator, starts, goals, bounds, oracles, trajectories)
        solve_kw = dict(max_iterations=max_iterations, min_iterations=min_iterations,
                        check_freq=check_freq, stop_on_plateau=stop_on_plateau)
        with profiling.span("suite.solve"):
            if checkpoint_path is not None:
                result = planner.solve_checkpointed(
                    states, oracles, generator, checkpoint_path,
                    checkpoint_every_chunks=checkpoint_every_chunks, resume=resume, **solve_kw,
                )
            else:
                result = planner.solve(states, oracles, generator, **solve_kw)
            paths = result.path.cpu().numpy().copy()
            feasible = result.feasible.cpu().numpy().copy()
            lengths = result.length.cpu().numpy().copy()
            iterations = result.iterations.cpu().numpy().copy()

        # cheap shortcut/repair pass FIRST: a chord-repairable problem must not
        # burn restart_failed full re-solves (the repair is ~free)
        repaired_total = 0
        if shortcut_trials > 0:
            with profiling.span("suite.shortcut"):
                paths, lengths, feasible, rep_mask = _shortcut_pass(
                    solver, oracles, paths, lengths, feasible,
                    torch.Generator(device=device).manual_seed(seed ^ 0x5C0C), shortcut_trials,
                    mesh=mesh,
                )
            repaired_total += int(rep_mask.sum())  # base batch: one lane == one problem

        rounds_used = 0
        for rnd in range(restart_rounds if restart_failed > 0 else 0):
            if feasible.all():
                break
            with profiling.span("suite.restart") as span:
                rounds_used += 1
                failed = np.where(~feasible)[0]
                r = restart_failed
                total = len(failed) * r
                # problem-major replication, padded to a multiple of the device count
                sel = np.repeat(failed, r)
                pad = (-total) % planner.device_count
                if pad:
                    sel = np.concatenate([sel, np.repeat(failed[-1:], pad)])
                if span is not None:
                    span.attrs["lanes"] = len(sel)
                idx = torch.as_tensor(sel, device=device)
                oracles_f = tree_map(lambda x: x[idx], oracles)
                retry_seed = seed ^ (0x5EED0F + rnd * 0x9E3779)
                retry_generator = torch.Generator(device=device).manual_seed(retry_seed)
                states_f = planner.init_batch(
                    retry_generator, starts[idx], goals[idx], bounds[idx], oracles_f,
                    None if trajectories is None else trajectories[idx],
                )
                if checkpoint_path is not None:
                    cp = pathlib.Path(checkpoint_path)
                    suffix = "-retry.npz" if rnd == 0 else f"-retry{rnd}.npz"
                    retry = planner.solve_checkpointed(
                        states_f, oracles_f, retry_generator,
                        cp.with_name(cp.name.replace(".npz", "") + suffix),
                        checkpoint_every_chunks=checkpoint_every_chunks, resume=resume, **solve_kw,
                    )
                else:
                    retry = planner.solve(states_f, oracles_f, retry_generator, **solve_kw)
                r_paths_flat = retry.path.cpu().numpy().copy()
                r_feas_flat = retry.feasible.cpu().numpy().copy()
                r_len_flat = retry.length.cpu().numpy().copy()
                r_repaired_flat = np.zeros(len(r_feas_flat), bool)
                if shortcut_trials > 0:
                    # restarts get the same repair chance as the base solve
                    r_paths_flat, r_len_flat, r_feas_flat, r_repaired_flat = _shortcut_pass(
                        solver, oracles_f, r_paths_flat, r_len_flat, r_feas_flat,
                        torch.Generator(device=device).manual_seed(retry_seed ^ 0x5C0C),
                        shortcut_trials, mesh=mesh,
                    )
                r_paths = r_paths_flat[:total].reshape(len(failed), r, *paths.shape[1:])
                r_feas = r_feas_flat[:total].reshape(len(failed), r)
                r_len = r_len_flat[:total].reshape(len(failed), r)
                r_iter = retry.iterations.cpu().numpy()[:total].reshape(len(failed), r)
                r_repaired = r_repaired_flat[:total].reshape(len(failed), r)
                for j, b in enumerate(failed):
                    ok = np.where(r_feas[j])[0]
                    if len(ok):
                        best = ok[np.argmin(r_len[j][ok])]
                        paths[b] = r_paths[j, best]
                        lengths[b] = r_len[j, best]
                        feasible[b] = True
                        # a problem counts as shortcut-repaired only if the lane the
                        # selection kept owes its feasibility to the chord repair
                        # (per PROBLEM, never per lane)
                        repaired_total += int(r_repaired[j, best])
                        # total optimization spent on this problem: first try + restarts
                        iterations[b] = iterations[b] + int(r_iter[j, best])
        wall = time.time() - t0

        with profiling.span("suite.evaluate"):
            evaluator = active_evaluator()
            if require_native_evaluator and evaluator != "native":
                raise RuntimeError(
                    "native path-statistics evaluator requested but unavailable "
                    "(bench/native build failed?) — refusing to emit numpy-evaluated "
                    "artifacts silently"
                )
            log = ResultsLog(settings={
                "nfomp": dict(parameters),
                "evaluator": evaluator,
                "suite": {
                    "shortcut_trials": shortcut_trials,
                    "repaired_by_shortcut": repaired_total,
                    "restart_failed": restart_failed,
                    "restart_rounds": restart_rounds,
                    "restart_rounds_used": rounds_used,
                    "stop_on_plateau": stop_on_plateau,
                    **({"aot_events": planner.aot_events} if aot else {}),
                },
            })
            goals_np = goals.cpu().numpy()
            stats_list = []
            for b, scenario in enumerate(scenarios):
                occupied = np.argwhere(scenario.blocked)
                # obstacle cell centers for clearing metrics
                ox, oy = scenario.origin
                obstacle_points = np.stack(
                    [
                        ox + (occupied[:, 1] + 0.5) * scenario.resolution,
                        oy + (occupied[:, 0] + 0.5) * scenario.resolution,
                    ],
                    axis=1,
                ) if len(occupied) else None
                stats = path_statistics(
                    paths[b],
                    obstacles=obstacle_points,
                    collides=not bool(feasible[b]),
                    planner=planner_name,
                    planning_time=wall / len(scenarios),
                    goal=goals_np[b],
                    obstacle_segments=(
                        None if obstacle_segments is None else obstacle_segments[b]
                    ),
                )
                stats_list.append(stats)
                log.log_run(
                    planner_name, paths[b], stats,
                    extra={"iterations": int(iterations[b]), "seed_index": b},
                    environment=grid_environment_info(
                        scenario.blocked, scenario.resolution, scenario.origin,
                        scenario.start, scenario.goal,
                    ),
                )
        return SuiteResult(
            paths=paths, feasible=feasible, lengths=lengths, iterations=iterations,
            stats=stats_list, wall_time=wall, log=log,
            start_invalid=start_invalid, goal_invalid=goal_invalid,
            repaired_by_shortcut=repaired_total, restart_rounds_used=rounds_used,
        )
