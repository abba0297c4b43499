#!/usr/bin/env python3
"""GPMP2 comparison baseline over benchmark worlds, on one card (the
counterpart of scripts/run_gpmp2.py): the reference's scripts/run_gpmp2.py
role, with gtsam/gpmp2 replaced by nfopp_tpu_torch.baselines.gpmp2, batched
across all seeds at once.

    python3 scripts/run_gpmp2_torch.py --suite corridor --seeds 4
    python3 scripts/run_gpmp2_torch.py --suite movingai --seeds 16
    python3 scripts/run_gpmp2_torch.py --suite forest --seeds 2 --device cpu

Builds the worlds on the host, seeds every problem with the batched
wavefront path on --device (the reference's A* initialization,
run_gpmp2.py:52-60), solves all of them in one batched Gauss-Newton run
(GPMP2Config(num_steps=100): 30 iterations), checks each path densely (500
samples) against its footprint-dilated grid, logs PathStatistics in the
reference's results schema, and prints one JSON line: wall time, s per
problem, collision-free count, mean length and smoothness, the device.
--device is cuda unless asked for the CPU; the script refuses to start
without a card otherwise.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PLANNER = "gpmp2_torch"
DENSE_SAMPLES = 500  # the dense collision check's samples per path


def build_scenarios(suite: str, seeds: int, min_geodesic: float = 0.0):
    """The suite's worlds, built on the host: `seeds` corridor or forest
    worlds (endpoints resampled to a geodesic of at least min_geodesic), or
    the first `seeds` entries of the committed MovingAI city map's .scen."""
    from nfopp_tpu_torch.worlds import (
        GridScenario,
        corridor,
        parse_movingai_map,
        parse_movingai_scen,
        random_forest,
        resample_distant_endpoints,
    )

    if suite == "movingai":
        # the committed city 256x256 fixture + .scen endpoints, the worlds of
        # run_benchmark.py's movingai suite (the reference's GPMP2 MovingAI
        # number ran bench-mr's Berlin_0_256, not in its repo)
        base = parse_movingai_map((ROOT / "assets/movingai/city_0_256.map").read_text())
        entries = parse_movingai_scen(
            (ROOT / "assets/movingai/city_0_256.map.scen").read_text())[:seeds]
        return [
            GridScenario(
                base.blocked, base.resolution, base.origin,
                np.array([e["start_x"] + 0.5, e["start_y"] + 0.5, 0.0], np.float32),
                np.array([e["goal_x"] + 0.5, e["goal_y"] + 0.5, 0.0], np.float32),
            )
            for e in entries
        ]
    make = corridor if suite == "corridor" else (lambda seed: random_forest(seed=seed))
    return resample_distant_endpoints([make(seed=s) for s in range(seeds)], min_geodesic,
                                      device="cpu")


def prepare(scenarios, footprint_radius: float, config, device):
    """(oracles [B], batched SDF, starts [B, 2], goals [B, 2], init_xy [B, N, 2])
    on `device`: the footprint-dilated grid oracles, their SDFs, and the
    wavefront initial paths with the true endpoints at both ends."""
    import torch

    from nfopp_tpu_torch.astar.initializer import batched_wavefront_trajectories
    from nfopp_tpu_torch.baselines import build_sdf, stack_sdfs
    from nfopp_tpu_torch.worlds import GridOracle

    oracle_list = [s.oracle(footprint_radius, device) for s in scenarios]
    oracles = GridOracle(*(torch.cat(leaves) for leaves in zip(*oracle_list)))
    sdf = stack_sdfs([
        build_sdf(o.occupancy[0].cpu().numpy(), s.resolution, s.origin, device)
        for s, o in zip(scenarios, oracle_list)
    ])

    def batched(values):
        return torch.tensor(np.stack([np.asarray(v, np.float32) for v in values]),
                            device=device)

    starts3, goals3 = batched([s.start for s in scenarios]), batched([s.goal for s in scenarios])
    init_xy = batched_wavefront_trajectories(
        oracles.occupancy, starts3, goals3, batched([s.origin for s in scenarios]),
        batched([s.resolution for s in scenarios]), config.num_steps - 2,
    )[:, :, :2]
    starts, goals = starts3[:, :2], goals3[:, :2]
    init_xy = torch.cat([starts[:, None], init_xy, goals[:, None]], dim=1)
    return oracles, sdf, starts, goals, init_xy


def plan(sdf, starts, goals, config, init_xy):
    """(states [B, N, 4], wall seconds): one batched gpmp2_plan, finished on
    the device before the clock is read."""
    import torch

    from nfopp_tpu_torch.baselines import gpmp2_plan

    def sync():
        if starts.device.type == "cuda":
            torch.cuda.synchronize(starts.device)

    sync()
    t0 = time.perf_counter()
    states = gpmp2_plan(sdf, starts, goals, config, init_xy)
    sync()
    return states, time.perf_counter() - t0


def dense_paths(states: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(paths [B, N, 3] with tangent headings, dense [B, 500, 3]) of [B, N, 4]
    GPMP2 states: the reference's 500-sample linear interpolation."""
    from nfopp_tpu_torch.utils.host_math import calculate_tangent

    paths, dense = [], []
    for s in states:
        xy = s[:, :2]
        t = np.linspace(0, 1, len(xy))
        theta = calculate_tangent(xy[:, 0], xy[:, 1], t)
        path = np.concatenate([xy, theta[:, None]], axis=1)
        dense_idx = np.linspace(0, len(path) - 1, DENSE_SAMPLES)
        dense.append(np.stack([np.interp(dense_idx, np.arange(len(path)), path[:, k])
                               for k in range(3)], axis=1))
        paths.append(path)
    return np.stack(paths), np.stack(dense)


def evaluate(states, scenarios, oracles, wall: float, suite: str):
    """(ResultsLog, collides [B], stats [B]): the dense collision check on
    the oracles' device and path_statistics per problem."""
    import torch

    from nfopp_tpu_torch.bench import ResultsLog, path_statistics
    from nfopp_tpu_torch.worlds import grid_collision

    paths, dense = dense_paths(states.cpu().numpy())
    device = oracles.occupancy.device
    collides = grid_collision(
        oracles, torch.tensor(dense, dtype=torch.float32, device=device)).any(dim=1).cpu().numpy()
    log = ResultsLog(environment_info={"suite": suite})
    stats = []
    for b, scenario in enumerate(scenarios):
        s = path_statistics(paths[b], collides=bool(collides[b]), planner=PLANNER,
                            planning_time=wall / len(scenarios), goal=scenario.goal)
        log.log_run(PLANNER, paths[b], s)
        stats.append(s)
    return log, collides, stats


def summary(suite: str, wall: float, collides, stats, device) -> dict:
    """The JSON line's numbers."""
    import torch

    batch = len(stats)
    return {
        "suite": suite, "problems": batch, "wall_s": wall, "s_per_problem": wall / batch,
        "collision_free": int((~collides).sum()),
        "mean_length": float(np.mean([s.path_length for s in stats])),
        "mean_smoothness": float(np.mean([s.smoothness for s in stats])),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--suite", choices=["corridor", "forest", "movingai"],
                        default="corridor")
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--footprint-radius", type=float, default=1.0)
    parser.add_argument("--min-geodesic", type=float, default=0.0,
                        help="resample endpoints until the grid geodesic is at "
                        "least this long (bench-mr's recorded corridor runs "
                        "have ~170-length paths; uniform draws are shorter)")
    parser.add_argument("--out", default="nfopp_gpmp2_results.json")
    parser.add_argument("--device", default="cuda",
                        help="device of the solve (cuda, or cpu for the plain "
                        "PyTorch path)")
    args = parser.parse_args()

    from nfopp_tpu_torch.baselines import GPMP2Config
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "run_gpmp2_torch.py")
    scenarios = build_scenarios(args.suite, args.seeds, args.min_geodesic)
    config = GPMP2Config(num_steps=100)
    oracles, sdf, starts, goals, init_xy = prepare(scenarios, args.footprint_radius, config,
                                                   device)
    states, wall = plan(sdf, starts, goals, config, init_xy)
    log, collides, stats = evaluate(states, scenarios, oracles, wall, args.suite)
    print(f"{'#':>3} {'collides':>9} {'length':>9} {'smooth':>8}")
    for b, s in enumerate(stats):
        print(f"{b:>3} {str(bool(collides[b])):>9} {s.path_length:>9.2f} {s.smoothness:>8.3f}")
    out = log.save(args.out)
    print(f"wall {wall:.2f}s for {len(scenarios)} problems (batched); saved {out}")
    print(json.dumps(summary(args.suite, wall, collides, stats, device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
