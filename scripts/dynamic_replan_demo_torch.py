#!/usr/bin/env python3
"""Closed-loop dynamic-obstacle replanning demo of the PyTorch/CUDA port (the
counterpart of scripts/dynamic_replan_demo.py).

End-to-end exercise of the service stack the reference runs as a ROS node
(ros/goal_planner_adapter.py 10 Hz cycle + collision_checker_adapter.py live
point-cloud merging): a robot drives toward a goal while a disc obstacle
oscillates across its straight-line route; every simulation tick feeds fresh
"sensor" points into `WorldState`, swaps the merged oracle into the planner
(`ReplanningService.update_world`), tracks the robot pose, and replans within
the cycle budget. The ONF field must keep UN-learning the obstacle's old
position (the replay buffer ages stale points out): the executed trace must
stay collision-free against the TRUE moving disc and reach the goal.

    python3 scripts/dynamic_replan_demo_torch.py [--cycles 250] [--device cpu]
    python3 scripts/dynamic_replan_demo_torch.py --session [--fleet 16] [--aot]

--session runs the closed loop as a scripted session
(`service.dynamic_replan_session`, or `fleet_dynamic_session` with --fleet R
robots on staggered lanes and one shared field): the obstacle script becomes
per-cycle oracle points, and the session's wall (CUDA events after a
synchronize) over its cycles is the per-cycle latency; with --aot its solver
is a `with_aot` copy, so the init's pretraining and every burst replay
captured programs (one per 10-step chunk; `aot_events` in the result), as
the JAX script's --aot loads its session programs. The host loop needs no
flag: its `NFOPPlanner` pretrains and steps through captured programs on the
card (any step count). Both modes check the executed poses offline against
the true disc. The result JSON goes to --out;
the JAX script's PNG panels are not drawn here.
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

BOUNDS = (0.0, 5.0, 0.0, 3.0)
OBST_R = 0.35
ROBOT_CLEAR = 0.3  # planner's circle-checker radius
START = np.array([0.4, 1.5, 0.0], np.float32)
GOAL = np.array([4.6, 1.5, 0.0], np.float32)
CAPACITY = 32  # obstacle slots of the session's oracle


def obstacle_center(t: float) -> np.ndarray:
    """Disc oscillating vertically across the start-goal line at x=2.5."""
    span_lo, span_hi = 0.55, 2.45
    period = 8.0
    phase = (t % period) / period  # 0..1
    tri = 2 * abs(phase - 0.5)  # 1 -> 0 -> 1
    y = span_lo + (span_hi - span_lo) * (1 - tri)
    return np.array([2.5, y], np.float32)


def obstacle_points(center: np.ndarray) -> np.ndarray:
    """Sample the disc as the sensor would see it (rings + center)."""
    pts = [center[None]]
    for r, n in ((OBST_R, 16), (OBST_R * 0.5, 8)):
        a = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pts.append(center[None] + r * np.stack([np.cos(a), np.sin(a)], axis=1))
    return np.concatenate(pts, axis=0).astype(np.float32)


def advance_along_path(pose: np.ndarray, path: np.ndarray, dist: float) -> np.ndarray:
    """Move `dist` along the path polyline starting at its closest vertex."""
    xy = path[:, :2]
    i = int(np.argmin(np.sum((xy - pose[None, :2]) ** 2, axis=1)))
    p = pose[:2].copy()
    remaining = dist
    while remaining > 0 and i + 1 < len(xy):
        seg = xy[i + 1] - p
        seg_len = float(np.linalg.norm(seg))
        if seg_len < 1e-9:
            i += 1
            continue
        if seg_len >= remaining:
            p = p + seg / seg_len * remaining
            remaining = 0.0
        else:
            p = xy[i + 1].copy()
            remaining -= seg_len
            i += 1
    if remaining > 0:  # past the final vertex: close on the path end directly
        seg = xy[-1] - p
        seg_len = float(np.linalg.norm(seg))
        if seg_len > 1e-9:
            p = p + seg / seg_len * min(remaining, seg_len)
    theta = path[min(i + 1, len(path) - 1), 2] if path.shape[1] == 3 else 0.0
    return np.array([p[0], p[1], theta], np.float32)


def demo_parameters():
    """DEFAULT_PARAMETERS with 100 pretraining iterations (the demo's)."""
    from nfopp_tpu_torch.solver import DEFAULT_PARAMETERS
    from nfopp_tpu_torch.utils.config import Config

    return (Config.from_dict(DEFAULT_PARAMETERS)
            .update({"planner": {"init_collision_iteration": 100}})
            .as_attribute_dict())


def clearance(poses: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Distance of each robot centre to the disc centre minus the disc's
    radius; the robot (a disc of ROBOT_CLEAR) touches the obstacle below
    ROBOT_CLEAR."""
    return np.linalg.norm(poses[..., :2] - centers, axis=-1) - OBST_R


def host_loop(cycles: int, dt: float, robot_speed: float, budget: float, device,
              seed: int = 0) -> tuple[dict, dict]:
    """The host demo: WorldState -> circle_oracle -> update_world ->
    update_robot_pose -> replan_cycle (PathPostprocessor) per tick. Returns
    the result and the traces (executed poses, obstacle centres, raw planner
    paths with the pose fed before each, published paths, cycle walls, steps
    per cycle, the planner and the world)."""
    from nfopp_tpu_torch.service import PathPostprocessor, ReplanningService, WorldState
    from nfopp_tpu_torch.solver import PlannerFactory
    from nfopp_tpu_torch.worlds import GridScenario, circle_collision

    # empty static map: the demo world is pure boundaries + live points
    scenario = GridScenario(np.zeros((30, 50), bool), 0.1, (0.0, 0.0), START, GOAL)
    world = WorldState(point_capacity=64, device=device)
    world.update_map(scenario)
    t_sim = 0.0
    world.update_sensor_points(obstacle_points(obstacle_center(t_sim)))
    planner = PlannerFactory.make_constrained_onf_planner(
        circle_collision, world.circle_oracle(ROBOT_CLEAR), demo_parameters(), seed=seed,
        device=device)
    service = ReplanningService(planner, planning_timeout=budget, steps_per_chunk=10,
                                postprocessor=PathPostprocessor())
    pose = START.copy()
    service.update_robot_pose(pose)
    service.update_boundaries(BOUNDS)
    assert service.set_goal(GOAL)

    traces = {key: [] for key in ("pose", "center", "fed", "raw", "path", "cycle_s", "steps")}
    reached = False
    for _ in range(cycles):
        t0 = time.perf_counter()
        # sensor tick: the obstacle moved; merge fresh points + replan
        world.update_sensor_points(obstacle_points(obstacle_center(t_sim)))
        service.update_world(world.circle_oracle(ROBOT_CLEAR))
        service.update_robot_pose(pose)
        path = service.replan_cycle()
        traces["cycle_s"].append(time.perf_counter() - t0)
        traces["steps"].append(int(planner.state.step_count[0]))
        traces["fed"].append(pose.copy())
        traces["raw"].append(planner.get_path())
        # execute: advance along the fresh plan; obstacle advances too
        pose = advance_along_path(pose, path, robot_speed * dt)
        t_sim += dt
        traces["pose"].append(pose.copy())
        traces["center"].append(obstacle_center(t_sim))
        traces["path"].append(np.asarray(path))
        if np.linalg.norm(pose[:2] - GOAL[:2]) < 0.2:
            reached = True
            break
    clear = clearance(np.asarray(traces["pose"]), np.asarray(traces["center"]))
    ms = np.asarray(traces["cycle_s"]) * 1e3
    result = {
        "scenario": "oscillating disc (r=0.35) crossing the route at x=2.5, "
                    "bounds (0,5)x(0,3), 10 Hz cycles",
        "cycles": len(traces["pose"]),
        "sim_seconds": t_sim,
        "reached_goal": reached,
        "collided": bool((clear < ROBOT_CLEAR).any()),
        "min_clearance": float(clear.min()),
        "cycle_ms_p50": float(np.percentile(ms, 50)),
        "cycle_ms_p99": float(np.percentile(ms, 99)),
        "mean_steps_per_cycle": float(np.mean(traces["steps"])),
        "planning_budget_ms": budget * 1e3,
        "robot_speed": robot_speed,
        "robot_radius": ROBOT_CLEAR,
    }
    return result, {**traces, "planner": planner, "world": world}


def session_world(cycles: int, dt: float, t_offset: float, device):
    """(oracle builder, per-cycle obstacle points [C, CAPACITY, 2], mask) of
    the disc script from `t_offset`, on `device`."""
    import torch

    from nfopp_tpu_torch.worlds import CircleOracle

    npts = len(obstacle_points(obstacle_center(0.0)))
    seq = np.full((cycles, CAPACITY, 2), 1e9, np.float32)
    for c in range(cycles):
        seq[c, :npts] = obstacle_points(obstacle_center(t_offset + c * dt))
    mask = torch.zeros((1, CAPACITY), dtype=torch.bool, device=device)
    mask[0, :npts] = True
    radius = torch.tensor([ROBOT_CLEAR], device=device)
    bounds = torch.tensor([BOUNDS], dtype=torch.float32, device=device)

    def builder(points_t):
        return CircleOracle(points_t[None], mask, radius, bounds)

    return builder, torch.tensor(seq, device=device)


def fleet_lanes(robots: int) -> tuple[np.ndarray, np.ndarray]:
    """Staggered lanes all crossing the disc's oscillation line."""
    ys = np.linspace(0.7, 2.3, robots).astype(np.float32)
    zeros = np.zeros(robots, np.float32)
    starts = np.stack([np.full(robots, 0.4, np.float32), ys, zeros], axis=1)
    goals = np.stack([np.full(robots, 4.6, np.float32), ys[::-1], zeros], axis=1)
    return starts, goals


def session_states(solver, builder, xs0, starts, goals, seed: int):
    """A (grouped, one field for the fleet) init of the robots' queries."""
    import torch

    g = torch.Generator(device=solver.device).manual_seed(seed)
    robots = len(starts)
    return solver.init_state(g, starts, goals, np.tile(np.asarray(BOUNDS, np.float32), (robots, 1)),
                             builder(xs0), group_size=robots)


def run_session(solver, states, builder, xs, goals, steps_per_cycle: int, step_dist: float,
                seed: int):
    """The timed scripted session: `dynamic_replan_session` for one robot,
    else `fleet_dynamic_session` with one shared field, noise from a
    generator seeded `seed`. Returns (seconds, final states, aux)."""
    import torch

    from nfopp_tpu_torch.service import dynamic_replan_session, fleet_dynamic_session
    from nfopp_tpu_torch.tools.scene import timed

    noise = torch.Generator(device=solver.device).manual_seed(seed)
    if len(goals) == 1:
        run = partial(dynamic_replan_session, solver, states, builder, xs, goals[0],
                      steps_per_cycle, step_dist, noise)
    else:
        run = partial(fleet_dynamic_session, solver, states, builder, xs, goals, steps_per_cycle,
                      step_dist, len(goals), noise)
    seconds, (final, aux) = timed(run, solver.device)
    return seconds, final, aux


def session_check(aux, dt: float) -> dict:
    """Offline check of an executed trace against the true disc, until each
    robot reaches its goal (then it is frozen at the goal); each robot's
    reach cycle (the first cycle it is at its goal, as the JAX script's
    `reach_cycle`), None where it never reached."""
    poses = aux.pose.cpu().numpy()
    reached = aux.reached.cpu().numpy()
    reach = [int(np.argmax(r)) if r.any() else None
             for r in reached.reshape(len(reached), -1).T]
    centers = np.stack([obstacle_center(c * dt) for c in range(len(poses))])
    if poses.ndim == 3:
        centers = centers[:, None]
    active = ~reached
    clear = clearance(poses, centers)
    return {
        "collided": bool((clear[active] < ROBOT_CLEAR).any()),
        "min_clearance_while_active": float(clear[active].min()) if active.any() else None,
        "reached": reached[-1].tolist(),
        "reach_cycle": reach[0] if reached.ndim == 1 else reach,
    }


def session_main(args, device) -> dict:
    """--session: a warm-up session on a phase-shifted script, then the timed
    one from t=0, checked against the true disc."""
    from nfopp_tpu_torch.solver import ConstrainedSolver, config_from_parameters
    from nfopp_tpu_torch.worlds import circle_collision

    solver = ConstrainedSolver(config_from_parameters(demo_parameters()), circle_collision,
                               device=device)
    if args.aot:
        solver = solver.with_aot("session")
    if args.fleet > 1:
        starts, goals = fleet_lanes(args.fleet)
    else:
        starts, goals = START[None], GOAL[None]
    step_dist = args.robot_speed * args.dt
    for t_offset, seed in ((1.7, args.seed + 1), (0.0, args.seed)):
        builder, xs = session_world(args.session_cycles, args.dt, t_offset, device)
        states = session_states(solver, builder, xs[0], starts, goals, seed)
        wall, _, aux = run_session(solver, states, builder, xs, goals, args.steps_per_cycle,
                                   step_dist, seed + 2)
    per_cycle_ms = wall / args.session_cycles * 1e3
    check = session_check(aux, args.dt)
    reached = np.asarray(check.pop("reached"), bool).reshape(-1)
    return {
        "metric": ("fleet_dynamic_replan_cycle_latency_session" if args.fleet > 1
                   else "dynamic_replan_cycle_latency_session"),
        "robots": len(goals),
        "scenario": "oscillating disc (r=0.35) crossing every route at x=2.5, bounds "
                    "(0,5)x(0,3); per-cycle sensor points, pose tracking, goal freeze and a "
                    f"{args.steps_per_cycle}-step burst (one shared field for a fleet)",
        "cycles": args.session_cycles,
        "per_cycle_ms": per_cycle_ms,
        "budget_ms": args.budget * 1e3,
        "within_budget": bool(per_cycle_ms <= args.budget * 1e3),
        "steps_per_cycle": args.steps_per_cycle,
        "session_wall_s": wall,
        "robots_reached_goal": int(reached.sum()),
        **check,
        "robot_radius": ROBOT_CLEAR,
        "robot_replans_per_s": len(goals) / (per_cycle_ms * 1e-3),
        **({"aot_events": solver.aot_events} if args.aot else {}),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cycles", type=int, default=250)
    parser.add_argument("--dt", type=float, default=0.1)
    parser.add_argument("--robot-speed", type=float, default=0.35)
    parser.add_argument("--budget", type=float, default=0.08,
                        help="per-cycle planning budget (s)")
    parser.add_argument("--out", default="artifacts/dynamic_replan_torch.json")
    parser.add_argument("--session", action="store_true",
                        help="run the closed loop as a scripted session "
                             "(service.dynamic_replan_session / fleet_dynamic_session)")
    parser.add_argument("--session-cycles", type=int, default=300,
                        help="session: cycles (30 s of simulated time at dt 0.1)")
    parser.add_argument("--steps-per-cycle", type=int, default=40,
                        help="session: optimization steps per cycle (a multiple of the "
                             "reparametrization freq)")
    parser.add_argument("--aot", action="store_true",
                        help="session: pretrain and run the bursts as replays of captured "
                             "programs (solver.with_aot)")
    parser.add_argument("--fleet", type=int, default=1, metavar="R",
                        help="session: R robots on staggered lanes crossing the same moving "
                             "disc, one shared field")
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "dynamic_replan_demo_torch")
    enable_compile_cache(device)  # the kernel library, before any timing
    if args.session:
        result = session_main(args, device)
    else:
        result, _ = host_loop(args.cycles, args.dt, args.robot_speed, args.budget, device,
                              args.seed)
    result["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
