#!/usr/bin/env python3
"""Replan-cycle latency of the PyTorch/CUDA port (the counterpart of
scripts/replan_latency.py) — the reference's ROS-mode budget check.

The reference replans at 10 Hz with a 0.1 s per-cycle stepping budget
(ros/goal_planner_adapter_factory.py:28, goal_planner_adapter.py:44-63). On
the car scene with run_planner_config:

    python3 scripts/replan_latency_torch.py                     # host service
    python3 scripts/replan_latency_torch.py --fleet 8           # fleet service
    python3 scripts/replan_latency_torch.py --session           # scripted session
    python3 scripts/replan_latency_torch.py --session --fleet 256 --subgroups 2 \
        --group-size 128 --goals 2 --cycles-per-goal 25 --steps-per-cycle 20
    python3 scripts/replan_latency_torch.py --fleet-sweep 1,8,32,128,256/2
    python3 scripts/replan_latency_torch.py --device cpu        # any mode, on the CPU

The host-service mode drives `ReplanningService` (or, with --fleet,
`FleetReplanningService`) through moving-robot cycles on a persistent
planner and prints the p50/p90/p99 cycle wall and the optimization steps
that fit the budget per cycle.

--session runs the scripted session (`service.replan_session`, or
`fleet_replan_session` with --fleet, --subgroups, --group-size): per cycle
the same update_start + fixed-step burst the services run, with a goal
change every --cycles-per-goal cycles. The port has no single device program
for a session (JAX's --device-true): the session is a Python loop, timed with
CUDA events after a synchronize, and its mean cycle is reported. --fleet-sweep
runs it over fleet sizes ('R/S': R robots in S sub-fleets).

--aot runs every mode's bursts as replays of captured chunk programs (one
CUDA graph per 10-step chunk, `utils/aot.py`: the solver's `with_aot`), where
the JAX script's --aot loads its session programs from the AOT store; the
result lists the programs captured. The kernel library is built and loaded
before any timing (`utils/compile_cache.py`). --device (default cuda;
refused without a card) replaces --cpu.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def car_setup(device, field_freq: int = 1, aot: bool = False):
    """(solver, oracle, env) of the car scene with run_planner_config (the
    field trained every `field_freq`-th step), on `device`; with `aot` the
    solver runs its static schedule as captured chunk programs."""
    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import car_environment, rectangle_collision

    config = run_planner_config()
    if field_freq > 1:
        if config.reparametrize_trajectory_freq % field_freq != 0:
            raise SystemExit(f"--field-freq {field_freq} must divide the reparam freq "
                             f"{config.reparametrize_trajectory_freq} (static schedule)")
        config = config._replace(optimize_collision_model_freq=field_freq)
    solver = ConstrainedSolver(config, rectangle_collision, device=device)
    if aot:
        solver = solver.with_aot("replan")
    oracle = car_world(1, device)[0]
    return solver, oracle, car_environment()


def goal_rows(env, robots: int, goals: int) -> np.ndarray:
    """[goals, robots, 3]: robots alternate goal / start targets, and every
    other round swaps them (tests/test_session.py's rows)."""
    base = np.stack([env.goal if i % 2 == 0 else env.start for i in range(robots)])
    return np.stack([base if j % 2 == 0 else base[::-1] for j in range(goals)]).astype(np.float32)


def fleet_quality(solver, oracle, states) -> dict:
    """Feasible fraction (5 samples per segment) and mean xy length of the
    session's final plans."""
    from nfopp_tpu_torch.solver import evaluate_path

    collides, lengths = evaluate_path(solver.oracle_fn, oracle, solver.full_trajectory(states))
    return {"final_plans_feasible_frac": float(1.0 - collides.float().mean()),
            "final_plans_mean_length": float(lengths.mean())}


def fleet_states(solver, oracle, env, robots: int, group_size: int, seed: int):
    """`robots` copies of the car query, one field init per group."""
    import torch

    g = torch.Generator(device=solver.device).manual_seed(seed)

    def tile(a):
        return np.tile(np.asarray(a, np.float32)[None], (robots, 1))

    return solver.init_state(g, tile(env.start), tile(env.goal), tile(env.bounds), oracle,
                             group_size=group_size)


def run_session(solver, oracle, states, rows: np.ndarray, cycles_per_goal: int, steps: int,
                group_size: int, subgroups: int, seed: int):
    """The timed session of `states` over the goal rows [G, R, 3]:
    `replan_session` for one robot, else `fleet_replan_session` (noise from
    a generator seeded `seed`, or `subfleet_generators(seed, subgroups)`).
    Returns (seconds, final states, aux)."""
    import torch

    from nfopp_tpu_torch.service import (
        fleet_replan_session,
        replan_session,
        subfleet_generators,
    )
    from nfopp_tpu_torch.tools.scene import timed

    device = solver.device
    if rows.shape[1] == 1:
        run = partial(replan_session, solver, states, oracle, rows[:, 0], cycles_per_goal, steps,
                      torch.Generator(device=device).manual_seed(seed))
    else:
        noise = (subfleet_generators(seed, subgroups, device) if subgroups > 1
                 else torch.Generator(device=device).manual_seed(seed))
        run = partial(fleet_replan_session, solver, states, oracle, rows, cycles_per_goal, steps,
                      group_size, noise, subgroups=subgroups)
    seconds, (final, aux) = timed(run, device)
    return seconds, final, aux


def session_row(args, solver, oracle, env, robots: int, subgroups: int) -> dict:
    group = args.group_size or max(1, robots // subgroups)
    if robots > 1 and (robots // subgroups) % group != 0:
        raise SystemExit(f"--group-size {group} must divide the sub-fleet {robots // subgroups}")
    g, c, s = args.goals, args.cycles_per_goal, args.steps_per_cycle
    # warm-up: a one-cycle session on other states (kernel loads, allocator)
    warm = fleet_states(solver, oracle, env, robots, group, args.seed + 100)
    run_session(solver, oracle, warm, goal_rows(env, robots, 1), 1, s, group, subgroups,
                args.seed + 101)
    states = fleet_states(solver, oracle, env, robots, group, args.seed)
    wall, final, _ = run_session(solver, oracle, states, goal_rows(env, robots, g), c, s, group,
                                 subgroups, args.seed + 1)
    cycles = g * c
    per_cycle_ms = wall / cycles * 1e3
    per_step_us = wall / (cycles * s) * 1e6
    return {
        "robots": robots,
        **({"subgroups": subgroups} if subgroups > 1 else {}),
        **({"group_size": group} if robots > 1 else {}),
        **fleet_quality(solver, oracle, final),
        "per_cycle_ms": per_cycle_ms,
        "per_step_us": per_step_us,
        "steps_fitting_budget": int(args.timeout / (per_step_us * 1e-6)),
        "robot_replans_per_s": robots / (per_cycle_ms * 1e-3),
        "goal_changes": g,
        "cycles": cycles,
        "steps_per_cycle": s,
        "session_wall_s": wall,
    }


def host_service(args, solver, oracle, env) -> dict:
    """ReplanningService on NFOPPlanner: `args.cycles` cycles of a robot that
    follows its plan to waypoint 3 between cycles."""
    from nfopp_tpu_torch.service import PathPostprocessor, ReplanningService
    from nfopp_tpu_torch.solver import NFOPPlanner

    planner = NFOPPlanner(solver, oracle, seed=args.seed)
    published = []
    service = ReplanningService(planner, planning_timeout=args.timeout,
                                steps_per_chunk=args.steps_per_chunk,
                                postprocessor=PathPostprocessor(),
                                path_callback=published.append)
    service.update_boundaries(env.bounds)
    service.update_robot_pose(env.start)
    assert service.set_goal(env.goal)
    service.replan_cycle()  # warm-up
    cycle_times, steps_per_cycle = [], []
    pose = np.asarray(env.start, np.float32)
    for _ in range(args.cycles):
        service.update_robot_pose(pose)
        t0 = time.perf_counter()
        path = service.replan_cycle()
        cycle_times.append(time.perf_counter() - t0)
        # update_start_point at the top of each cycle resets step_count, so
        # the post-cycle count IS the number of steps this cycle ran
        steps_per_cycle.append(int(planner.state.step_count[0]))
        if path is not None and len(path) > 2:
            pose = np.asarray(path[min(3, len(path) - 1)], np.float32)
    return {"metric": "replan_cycle_latency", **percentiles(cycle_times), "budget_ms":
            args.timeout * 1e3, "mean_steps_per_cycle": float(np.mean(steps_per_cycle)),
            "cycles": args.cycles, "paths_published": len(published)}


def host_fleet(args, solver, oracle, env) -> tuple[dict, object, dict]:
    """FleetReplanningService: robots alternate start -> goal and goal ->
    start, each following its plan to waypoint 3 between cycles. Returns
    (result, the service, the last cycle's paths); the result counts the
    steps of every cycle, the warm-up included."""
    from nfopp_tpu_torch.service import FleetReplanningService, PathPostprocessor

    svc = FleetReplanningService(solver, args.fleet, env.bounds, oracle,
                                 planning_timeout=args.timeout,
                                 steps_per_chunk=args.steps_per_chunk,
                                 group_size=args.group_size,
                                 postprocessor=PathPostprocessor(), seed=args.seed)
    for r in range(args.fleet):
        svc.update_robot_pose(r, env.start if r % 2 == 0 else env.goal)
        assert svc.set_goal(r, env.goal if r % 2 == 0 else env.start)
    cycle_times, steps = [], []
    for cycle in range(args.cycles + 1):  # cycle 0 is the warm-up
        t0 = time.perf_counter()
        paths = svc.replan_cycle()
        if cycle:
            cycle_times.append(time.perf_counter() - t0)
        # every robot is active, so update_start at the top of each cycle
        # resets every lane's step_count: the count after it is the cycle's
        steps.append(int(svc._states.step_count[0]))
        for r, p in paths.items():
            if len(p) > 2:
                svc.update_robot_pose(r, p[min(3, len(p) - 1)])
    return {"metric": "fleet_replan_cycle_latency", "robots": args.fleet,
            **percentiles(cycle_times), "budget_ms": args.timeout * 1e3,
            "mean_steps_per_cycle": float(np.mean(steps[1:])),
            "robot_replans_per_s": args.fleet / float(np.mean(cycle_times)),
            "cycles": args.cycles, "steps_run": sum(steps)}, svc, paths


def percentiles(seconds) -> dict:
    ms = np.asarray(seconds) * 1e3
    return {f"p{q}_ms": float(np.percentile(ms, q)) for q in (50, 90, 99)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cycles", type=int, default=30)
    parser.add_argument("--timeout", type=float, default=0.1,
                        help="per-cycle stepping budget (reference: 0.1 s)")
    parser.add_argument("--steps-per-chunk", type=int, default=10)
    parser.add_argument("--fleet", type=int, default=0, metavar="N",
                        help="serve N robots on one map as one batched fleet "
                             "(FleetReplanningService / fleet_replan_session, shared fields)")
    parser.add_argument("--subgroups", type=int, default=1, metavar="S",
                        help="session fleet: S sequential sub-fleet bursts per cycle, each "
                             "with its own shared fields and noise source")
    parser.add_argument("--group-size", type=int, default=None, metavar="G",
                        help="robots per shared-field group (default: the whole sub-fleet)")
    parser.add_argument("--session", action="store_true",
                        help="run the scripted session (service.replan_session / "
                             "fleet_replan_session) and report its mean cycle")
    parser.add_argument("--goals", type=int, default=2,
                        help="session: scripted goal changes")
    parser.add_argument("--cycles-per-goal", type=int, default=10,
                        help="session: replan cycles between goal changes")
    parser.add_argument("--steps-per-cycle", type=int, default=40,
                        help="session: optimization steps per cycle (a multiple of the "
                             "reparametrization freq)")
    parser.add_argument("--field-freq", type=int, default=1, metavar="S",
                        help="train the occupancy field every S-th step (S divides the "
                             "reparametrization freq 10)")
    parser.add_argument("--fleet-sweep", default=None, metavar="SIZES",
                        help="session fleet-scaling curve: comma list of fleet sizes, "
                             "'R/S' for R robots in S sub-fleets (e.g. '1,8,128,256/2')")
    parser.add_argument("--aot", action="store_true",
                        help="run the bursts as replays of captured chunk programs "
                        "(CUDA graphs; the result lists them)")
    parser.add_argument("--json-out", default=None,
                        help="also write the result JSON to this path")
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "replan_latency_torch")
    enable_compile_cache(device)
    solver, oracle, env = car_setup(device, args.field_freq, args.aot)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    if args.fleet_sweep:
        rows = []
        for token in args.fleet_sweep.split(","):
            r, _, s = token.partition("/")
            rows.append(session_row(args, solver, oracle, env, int(r), int(s or 1)))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
        result = {"metric": "fleet_replan_scaling_session", "budget_ms": args.timeout * 1e3,
                  "steps_per_cycle": args.steps_per_cycle, "field_freq": args.field_freq,
                  "sizes": rows, "device": name}
    elif args.session:
        result = {"metric": "fleet_replan_cycle_latency_session" if args.fleet > 1
                  else "replan_cycle_latency_session",
                  **session_row(args, solver, oracle, env, max(args.fleet, 1), args.subgroups),
                  "field_freq": args.field_freq, "budget_ms": args.timeout * 1e3,
                  "device": name}
    elif args.fleet:
        result = {**host_fleet(args, solver, oracle, env)[0], "device": name}
    else:
        result = {**host_service(args, solver, oracle, env), "device": name}
    if args.aot:
        result["aot_events"] = solver.aot_events
    out = json.dumps(result)
    print(out)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
