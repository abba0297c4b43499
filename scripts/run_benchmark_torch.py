#!/usr/bin/env python3
"""Benchmark suite CLI of the PyTorch/CUDA port (the counterpart of
scripts/run_benchmark.py): the reference's scripts/run_bench_mr.py +
notebook pooling, as one batched run on one card.

    python3 scripts/run_benchmark_torch.py --suite corridor --seeds 256 \
        --min-geodesic 120 --restart-failed 8
    python3 scripts/run_benchmark_torch.py --suite forest --seeds 10 --out results.json
    python3 scripts/run_benchmark_torch.py --suite movingai --map path/to/Berlin_0_256.map \
        --scen path/to/Berlin_0_256.map.scen --seeds 10
    python3 scripts/run_benchmark_torch.py --suite corridor --seeds 4 --device cpu

Builds the worlds on the host (the wavefront fields of --min-geodesic on the
CPU), solves all seeds at once in one batch on --device (default cuda; the
script refuses to start without a card unless --device cpu), evaluates the
PathStatistics suite per problem, prints a summary table, and saves results
JSON in the reference's schema. The flags are run_benchmark.py's, except
--cpu, which --device replaces. --aot runs the solves as replays of captured
chunk programs (one CUDA graph per 10-step chunk, `utils/aot.py`) where
JAX's loads compiled executables from its AOT store.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# the scenario preparation's device: host work, as the JAX version's
BUILD_DEVICE = "cpu"


def build_scenarios(args):
    from nfopp_tpu_torch.worlds import (
        GridScenario,
        corridor,
        parse_movingai_map,
        parse_movingai_scen,
        random_forest,
        random_free_pose,
        resample_distant_endpoints,
        warehouse,
    )

    def far(scenarios):
        return resample_distant_endpoints(
            scenarios, getattr(args, "min_geodesic", 0) or 0.0, device=BUILD_DEVICE
        )

    if args.suite == "corridor":
        return far([corridor(seed=s, size=100, branches=100, radius=3) for s in range(args.seeds)])
    if args.suite == "forest":
        return far([random_forest(seed=s, size=(100, 100), obstacle_ratio=0.03)
                    for s in range(args.seeds)])
    if args.suite == "warehouse":
        return far([warehouse(seed=s) for s in range(args.seeds)])
    if args.suite == "movingai":
        base = parse_movingai_map(pathlib.Path(args.map).read_text())
        scenarios = []
        if args.scen:
            entries = parse_movingai_scen(pathlib.Path(args.scen).read_text())[: args.seeds]
            for e in entries:
                start = np.array([e["start_x"] + 0.5, e["start_y"] + 0.5, 0.0], np.float32)
                goal = np.array([e["goal_x"] + 0.5, e["goal_y"] + 0.5, 0.0], np.float32)
                scenarios.append(GridScenario(base.blocked, base.resolution, base.origin,
                                              start, goal))
        else:
            for s in range(args.seeds):
                rng = np.random.RandomState(s)
                start = random_free_pose(rng, base)
                goal = random_free_pose(rng, base)
                scenarios.append(GridScenario(base.blocked, base.resolution, base.origin,
                                              start, goal))
        return scenarios
    raise ValueError(args.suite)


def bench_parameters():
    """The reference run_bench_mr.py planner parameters (:20-67) with two
    measured improvements for 100x100 grid worlds (a copy of
    scripts/run_benchmark.py::bench_parameters): sigma=5 (sharper Fourier
    features: sigma=50 cannot represent 1-cell walls; the reference's own
    bench value is 10) and 100 iterations of field pretraining on 200 random
    points (the reference's init_collision_iteration mechanism, disabled in
    its configs, which stops the smoothness term from dragging the feasible
    A* init into walls before the field has learned them)."""
    from nfopp_tpu_torch.utils.config import AttributeDict

    return AttributeDict(
        trajectory_length=100,
        collision_model=AttributeDict(
            mean=0.0, sigma=5.0, use_cos=True, bias=True, use_normal_init=True,
            angle_encoding=True, name="ONF",
        ),
        collision_optimizer=AttributeDict(lr=2e-2, betas=(0.9, 0.9)),
        trajectory_optimizer=AttributeDict(lr=5e-2, betas=(0.9, 0.9)),
        planner=AttributeDict(
            name="ConstrainedNFOPPlanner",
            trajectory_random_offset=0.02, collision_weight=100.0,
            velocity_hessian_weight=0.5, random_field_points=10,
            init_collision_iteration=100, constraint_deltas_weight=100.0,
            multipliers_lr=0.1, init_collision_points=200,
            reparametrize_trajectory_freq=10, optimize_collision_model_freq=1,
            angle_weight=5.0, angle_offset=0.3, boundary_weight=1.0,
            direction_delta_weight=100.0, collision_multipliers_lr=1e-3,
            collision_beta=10.0, course_random_offset=1.5,
        ),
    )


def movingai_overrides():
    """256x256 city-map adjustments (a copy of
    scripts/run_benchmark.py::movingai_overrides): at 2.56x world scale the
    distance-shortening gradient overwhelms the fixed-scale collision terms
    and paths skim corners, so collision_weight 100->500 and
    constraint_deltas 100->300 rebalance it; trajectory_length 100->150 keeps
    segments ~2 cells; sigma 5->2.5 smooths the field at the larger extent."""
    return {
        "trajectory_length": 150,
        "collision_model": {"sigma": 2.5},
        "planner": {"collision_weight": 500.0, "constraint_deltas_weight": 300.0},
    }


def exact_warehouse_oracles(scenarios, seeds: int, footprint_radius: float, device):
    """run_grid_suite's keywords for --exact: the warehouse worlds' true
    polygons as a batched PolygonOracle (footprint as exact edge-distance
    inflation) and their edges for exact clearance metrics."""
    import torch

    from nfopp_tpu_torch.bench import polygons_to_segments
    from nfopp_tpu_torch.worlds import (
        PolygonOracle,
        pad_polygons,
        polygon_collision,
        warehouse_polygons,
    )

    poly_lists = [warehouse_polygons(s) for s in range(seeds)]
    capacity = max(len(p) for p in poly_lists)
    max_vertices = max(len(v) for polys in poly_lists for v in polys)
    padded = [pad_polygons(polys, capacity, max_vertices) for polys in poly_lists]
    oracle = PolygonOracle(
        torch.tensor(np.stack([v for v, _ in padded]), device=device),
        torch.tensor(np.stack([m for _, m in padded]), device=device),
        torch.full((len(scenarios),), footprint_radius, device=device),
        torch.tensor(np.stack([np.asarray(sc.bounds, np.float32) for sc in scenarios]),
                     device=device),
    )
    return dict(solve_oracles=oracle, oracle_fn=polygon_collision,
                obstacle_segments=[polygons_to_segments(p) for p in poly_lists])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--suite", choices=["corridor", "forest", "movingai", "warehouse"],
                        default="corridor")
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--map", help="MovingAI .map file (suite=movingai)")
    parser.add_argument("--scen", help="MovingAI .scen file (optional)")
    parser.add_argument("--footprint-radius", type=float, default=1.0)
    parser.add_argument("--min-geodesic", type=float, default=0.0,
                        help="resample endpoints until the grid geodesic is at "
                        "least this long (corridor/forest suites)")
    parser.add_argument("--max-iterations", type=int, default=1000)
    parser.add_argument("--min-iterations", type=int, default=200)
    parser.add_argument("--full-budget", action="store_true",
                        help="disable the reference's plateau early-stop: spend "
                        "all iterations refining, return the best tracked path")
    parser.add_argument("--restart-failed", type=int, default=0, metavar="R",
                        help="re-solve infeasible problems as R fresh restarts "
                        "(one extra batched solve), keep the best feasible")
    parser.add_argument("--restart-rounds", type=int, default=1, metavar="M",
                        help="iterate the restart fallback up to M rounds "
                        "(fresh streams each round, stop at "
                        "feasible-or-budget)")
    parser.add_argument("--shortcut", type=int, default=0, metavar="T",
                        help="post-solve random-pair shortcut attempts per "
                        "path (ops/shortcut.py: the OMPL PathSimplifier "
                        "role; the reference never simplifies)")
    parser.add_argument("--nfomp", help="JSON file/string with parameter overrides")
    parser.add_argument("--checkpoint", metavar="PATH",
                        help="checkpoint the solve every --checkpoint-every "
                        "tracking chunks to PATH (recovery; the retry "
                        "phase uses PATH-retry)")
    parser.add_argument("--checkpoint-every", type=int, default=4,
                        help="tracking chunks between checkpoint saves")
    parser.add_argument("--resume", action="store_true",
                        help="resume from --checkpoint if it exists")
    parser.add_argument("--exact", action="store_true",
                        help="warehouse only: solve and evaluate against the "
                        "TRUE polygon geometry (worlds.oracle.PolygonOracle, "
                        "footprint as exact edge-distance inflation) instead "
                        "of the rasterized grid; clearance metrics become "
                        "exact segment distances")
    parser.add_argument("--aot", action="store_true",
                        help="run the solves as replays of captured chunk programs "
                        "(CUDA graphs, utils/aot.py); their events go into the log")
    parser.add_argument("--out", default="nfopp_results.json")
    parser.add_argument("--device", default="cuda",
                        help="device of the solve (cuda, or cpu for the plain "
                        "PyTorch path)")
    args = parser.parse_args()
    if args.exact and args.suite != "warehouse":
        parser.error("--exact is only meaningful for the polygon (warehouse) suite")

    import torch

    from nfopp_tpu_torch.bench.runner import run_grid_suite
    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.config import Config
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "run_benchmark_torch.py")
    enable_compile_cache(device)
    scenarios = build_scenarios(args)
    parameters = bench_parameters()
    if args.suite == "movingai":
        parameters = Config.from_dict(parameters).update(movingai_overrides()).as_attribute_dict()
    if args.nfomp:
        override = (
            json.loads(pathlib.Path(args.nfomp).read_text())
            if pathlib.Path(args.nfomp).exists()
            else json.loads(args.nfomp)
        )
        parameters = Config.from_dict(parameters).update(override).as_attribute_dict()
    exact_kw = (exact_warehouse_oracles(scenarios, args.seeds, args.footprint_radius, device)
                if args.exact else {})

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"suite={args.suite} problems={len(scenarios)} "
          f"grid={scenarios[0].blocked.shape} device={name}"
          + (" geometry=EXACT polygons" if args.exact else ""))
    result = run_grid_suite(
        scenarios, parameters,
        footprint_radius=args.footprint_radius,
        max_iterations=args.max_iterations,
        min_iterations=args.min_iterations,
        stop_on_plateau=not args.full_budget,
        restart_failed=args.restart_failed,
        restart_rounds=args.restart_rounds,
        checkpoint_path=args.checkpoint,
        checkpoint_every_chunks=args.checkpoint_every,
        resume=args.resume,
        shortcut_trials=args.shortcut,
        device=device,
        aot=args.aot,
        **exact_kw,
    )

    feasible = result.feasible
    if args.aot:
        events = result.log.settings["suite"].get("aot_events", [])
        loaded = sum(1 for e in events if e["loaded"])
        print(f"programs: {loaded}/{len(events)} taken from the store (capture bypassed): "
              f"{json.dumps(events)}")
    print(f"\nwall time (all problems, one batch): {result.wall_time:.2f}s")
    print(f"feasible: {int(feasible.sum())}/{len(feasible)}")
    bad = (result.start_invalid | result.goal_invalid)
    if bad.any():
        print(f"note: {int(bad.sum())} problem(s) had start/goal in collision "
              f"(reference exit codes 3/4): {np.where(bad)[0].tolist()}")
    header = (f"{'#':>3} {'ok':>3} {'iters':>6} {'length':>9} {'max_k':>7} {'norm_k':>8} "
              f"{'AOL':>7} {'smooth':>8} {'clear':>7}")
    print(header)
    for b, stats in enumerate(result.stats):
        clearing = stats.mean_clearing_distance
        print(f"{b:>3} {str(bool(feasible[b]))[:1]:>3} {int(result.iterations[b]):>6} "
              f"{stats.path_length:>9.2f} {stats.max_curvature:>7.2f} "
              f"{stats.normalized_curvature:>8.2f} {stats.aol:>7.3f} "
              f"{stats.smoothness:>8.3f} "
              f"{clearing if clearing is None else round(clearing, 2)!s:>7}")
    out = result.log.save(args.out)
    print(f"\nresults saved to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
