#!/usr/bin/env python3
"""Seed-averaged quality parity on the benchmark suites (the counterpart of
scripts/compare_suites.py): corridor, forest, movingai and warehouse worlds,
the port's batched suite on one card against the PyTorch reference planner,
same worlds, same A*-style init, same parameters, a COMMON evaluation.

Both sides run on the same generated occupancy-grid worlds
(`nfopp_tpu_torch.worlds.scenarios`, the generators of
scripts/run_benchmark_torch.py, endpoints resampled on the CPU). The
reference planner is imported in place from a checkout of the reference
repository named by the environment variable NFOPP_REFERENCE (no other
directory is looked in) and driven through a
grid-backed CollisionChecker subclass implementing its checker interface,
its own AstarTrajectoryInitializer and its run_bench_mr.py best-path tracking
loop (:111-134). With the variable unset, or no directory there, the script
prints `reference: skipped`
and reports the port's side alone. The port's side is `run_grid_suite`, as
scripts/run_benchmark_torch.py runs it.

Both sides use the bench parameter set of scripts/run_benchmark_torch.py (the
reference's run_bench_mr.py:20-67 values with sigma=5 and 100 iterations of
field pretraining, the reference's own init_collision_iteration mechanism).
Evaluation is common: dense-path collision against the footprint-dilated grid
(5 samples per segment) and xy length, `nfopp_tpu_torch.solver.evaluate_path`
for both sides' paths.

    python3 scripts/compare_suites_torch.py --suite corridor --seeds 10
    python3 scripts/compare_suites_torch.py --suite forest --seeds 10 --device cpu

The flags are compare_suites.py's, except --cpu, which --device replaces
(default cuda; the script refuses to start without a card unless --device
cpu).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FOOTPRINT_RADIUS = 1.0  # world units; run_benchmark_torch.py's default
# the scenario preparation's device: host work, as in run_benchmark_torch.py
BUILD_DEVICE = "cpu"


def reference_path(skip: bool = False) -> str | None:
    """The reference checkout that $NFOPP_REFERENCE names, or None when the
    reference half is skipped: asked to, the variable unset or empty, or no
    directory there."""
    path = os.environ.get("NFOPP_REFERENCE")
    if skip or not path or not pathlib.Path(path).is_dir():
        return None
    return path


def _import_reference():
    """Puts the reference checkout, where there is one, first on sys.path and
    installs the lightning stub its factory imports."""
    path = reference_path()
    if path is not None and path not in sys.path:
        sys.path.insert(0, path)
    _install_lightning_stub()


def build_scenarios(suite: str, seeds: int, min_geodesic: float = 0.0):
    """The suite's worlds: the generators and endpoint resampler every suite
    script uses (the same worlds as compare_suites.py's)."""
    from nfopp_tpu_torch.worlds import (
        GridScenario,
        corridor,
        parse_movingai_map,
        parse_movingai_scen,
        random_forest,
        resample_distant_endpoints,
        warehouse,
    )

    if suite == "corridor":
        scenarios = [corridor(seed=s, size=100, branches=100, radius=3) for s in range(seeds)]
    elif suite == "forest":
        scenarios = [random_forest(seed=s, size=(100, 100), obstacle_ratio=0.03)
                     for s in range(seeds)]
    elif suite == "warehouse":
        scenarios = [warehouse(seed=s) for s in range(seeds)]
    elif suite == "movingai":
        # the committed city 256x256 fixture (the reference world class:
        # movingai_experiment.ipynb cell 4); endpoints from its .scen file
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
    else:
        raise ValueError(suite)
    return resample_distant_endpoints(scenarios, min_geodesic, device=BUILD_DEVICE)


def dilated_blocked(scenario) -> np.ndarray:
    """The footprint-dilated grid both sides plan against (GridScenario.oracle
    does the same fold for the port's side)."""
    from nfopp_tpu_torch.worlds import dilate

    return dilate(scenario.blocked, int(np.ceil(FOOTPRINT_RADIUS / scenario.resolution)))


# ---------------------------------------------------------------- our side


def suite_parameters(suite: str):
    """The port's parameter set: the bench set, plus the measured movingai
    256x256 overrides for the city suite (run_benchmark_torch.py applies the
    same)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from run_benchmark_torch import bench_parameters, movingai_overrides

    from nfopp_tpu_torch.utils.config import Config

    parameters = bench_parameters()
    if suite == "movingai":
        parameters = Config.from_dict(parameters).update(movingai_overrides()).as_attribute_dict()
    return parameters


def ours_suite_run(scenarios, parameters, iterations: int, full_budget: bool = False,
                   restart_failed: int = 0, solve_oracles=None, oracle_fn=None,
                   restart_rounds: int = 1, device="cuda"):
    """The whole suite in one batch on `device`: (paths [B, N+2, 3], wall s)."""
    from nfopp_tpu_torch.bench.runner import run_grid_suite

    t0 = time.time()
    result = run_grid_suite(
        scenarios,
        parameters,
        footprint_radius=FOOTPRINT_RADIUS,
        max_iterations=iterations,
        min_iterations=200,
        check_freq=50,
        stop_on_plateau=not full_budget,
        restart_failed=restart_failed,
        restart_rounds=restart_rounds,
        solve_oracles=solve_oracles,
        oracle_fn=oracle_fn,
        device=device,
    )
    return result.paths, time.time() - t0


# ------------------------------------------------- exact polygon geometry


def build_exact_oracles(seeds: int, device):
    """Per-seed EXACT warehouse oracles (PolygonOracle), padded to a common
    [P, K] shape so the suite batches, with the disc footprint as exact
    edge-distance inflation (the grid side's dilation radius). Returns
    (polygons per seed, the batched oracle, per-seed oracles of one row)."""
    import torch

    from nfopp_tpu_torch.utils.tree import tree_rows
    from nfopp_tpu_torch.worlds import PolygonOracle, pad_polygons, warehouse_polygons

    poly_lists = [warehouse_polygons(s) for s in range(seeds)]
    capacity = max(len(p) for p in poly_lists)
    max_vertices = max(len(v) for polys in poly_lists for v in polys)
    padded = [pad_polygons(polys, capacity, max_vertices) for polys in poly_lists]
    batched = PolygonOracle(
        torch.tensor(np.stack([v for v, _ in padded]), device=device),
        torch.tensor(np.stack([m for _, m in padded]), device=device),
        torch.full((seeds,), FOOTPRINT_RADIUS, device=device),
        torch.tensor([[0.0, 120.0, 0.0, 80.0]] * seeds, device=device),
    )
    singles = [tree_rows(batched, i, i + 1) for i in range(seeds)]
    return poly_lists, batched, singles


def _make_exact_polygon_checker(polygons, radius, bounds):
    """Reference-interface checker against the TRUE polygons (numpy even-odd
    + exact segment distance < footprint radius), the host twin of
    polygon_collision, so both sides plan against identical exact geometry
    (the reference's own polygon worlds are checked exactly,
    BenchmarkAdapter.cpp:175-187)."""
    _import_reference()
    from neural_field_optimal_planner.collision_checker import CollisionChecker

    from nfopp_tpu_torch.bench import polygons_to_segments

    segs = polygons_to_segments(polygons)
    a, d = segs[:, :2], segs[:, 2:] - segs[:, :2]
    denom = np.maximum((d * d).sum(axis=1), 1e-30)
    loops = [np.asarray(p, np.float64) for p in polygons]
    xmin, xmax, ymin, ymax = bounds

    class ExactPolygonChecker(CollisionChecker):
        def check_collision(self, test_positions):
            if hasattr(test_positions, "translation"):
                xy = np.asarray(test_positions.translation, np.float64)
            else:
                xy = np.asarray(test_positions, np.float64)[:, :2]
            inside = np.zeros(len(xy), bool)
            for poly in loops:
                v0, v1 = poly, np.roll(poly, -1, axis=0)
                straddles = (v0[None, :, 1] > xy[:, 1:2]) != (v1[None, :, 1] > xy[:, 1:2])
                t = (xy[:, 1:2] - v0[None, :, 1]) / (v1[None, :, 1] - v0[None, :, 1] + 1e-30)
                crosses = straddles & (
                    xy[:, 0:1] < v0[None, :, 0] + t * (v1[None, :, 0] - v0[None, :, 0])
                )
                # inside ANY polygon (|=), the device polygon_collision's rule
                inside |= (crosses.sum(axis=1) % 2).astype(bool)
            w = xy[:, None, :] - a[None]
            tt = np.clip((w * d[None]).sum(axis=2) / denom[None], 0.0, 1.0)
            closest = a[None] + tt[..., None] * d[None]
            near = np.linalg.norm(xy[:, None, :] - closest, axis=2).min(axis=1) < radius
            oob = (xy[:, 0] < xmin) | (xy[:, 0] > xmax) | (xy[:, 1] < ymin) | (xy[:, 1] > ymax)
            return inside | near | oob

    return ExactPolygonChecker(tuple(bounds))


# ------------------------------------------------------------- evaluation


def make_evaluator(oracle_fn, oracle):
    """Common metric closure of one world (an oracle of one row):
    dense-path feasibility + xy length of a path [N+2, 3]."""
    import torch

    from nfopp_tpu_torch.solver import evaluate_path
    from nfopp_tpu_torch.utils.tree import tree_leaves

    device = tree_leaves(oracle)[0].device

    def evaluator(path):
        full = torch.as_tensor(np.asarray(path, np.float32), device=device)[None]
        collides, length = evaluate_path(oracle_fn, oracle, full, 5)
        return bool(collides[0]), float(length[0])

    return evaluator


def grid_evaluators(scenarios, device):
    """One evaluator per world against its footprint-dilated grid."""
    from nfopp_tpu_torch.worlds import grid_collision

    return [make_evaluator(grid_collision, s.oracle(FOOTPRINT_RADIUS, device))
            for s in scenarios]


# ---------------------------------------------------------- reference side


def _install_lightning_stub():
    """Minimal AttributeDict so the reference's factory imports."""
    if "pytorch_lightning" in sys.modules:
        return

    class AttributeDict(dict):
        def __getattr__(self, k):
            try:
                return self[k]
            except KeyError as e:
                raise AttributeError(k) from e

        def __setattr__(self, k, v):
            self[k] = v

    pl = types.ModuleType("pytorch_lightning")
    utilities = types.ModuleType("pytorch_lightning.utilities")
    parsing = types.ModuleType("pytorch_lightning.utilities.parsing")
    parsing.AttributeDict = AttributeDict
    utilities.parsing = parsing
    utilities.AttributeDict = AttributeDict
    pl.utilities = utilities
    sys.modules["pytorch_lightning"] = pl
    sys.modules["pytorch_lightning.utilities"] = utilities
    sys.modules["pytorch_lightning.utilities.parsing"] = parsing


def _make_grid_checker(blocked: np.ndarray, origin, resolution, bounds):
    """Grid-backed checker implementing the reference CollisionChecker
    interface (Position2 or [N, >=2] arrays; outside the grid = collision)."""
    from neural_field_optimal_planner.collision_checker import CollisionChecker

    class GridCollisionChecker(CollisionChecker):
        def check_collision(self, test_positions):
            if hasattr(test_positions, "translation"):
                xy = np.asarray(test_positions.translation)
            else:
                xy = np.asarray(test_positions)[:, :2]
            j = np.floor((xy[:, 0] - origin[0]) / resolution).astype(int)
            i = np.floor((xy[:, 1] - origin[1]) / resolution).astype(int)
            h, w = blocked.shape
            outside = (i < 0) | (i >= h) | (j < 0) | (j >= w)
            hit = np.ones(len(xy), bool)
            inside = ~outside
            hit[inside] = blocked[i[inside], j[inside]]
            return hit

    return GridCollisionChecker(tuple(bounds))


def _reference_parameters(suite: str = "corridor"):
    """The bench parameter set in the reference's schema (run_bench_mr.py:
    20-67 layout + AstarTrajectoryInitializer). For the movingai suite both
    sides get the same measured 256x256 overrides (tl=150, sigma=2.5, cw=500,
    cdw=300)."""
    p = _reference_base_parameters()
    if suite == "movingai":
        p.trajectory_length = 150
        p.collision_model.sigma = 2.5
        p.planner.collision_weight = 500
        p.planner.constraint_deltas_weight = 300
    if suite == "warehouse":
        # the generated warehouse grid's resolution (0.5 world units per cell)
        p.trajectory_initializer.resolution = 0.5
    return p


def _reference_base_parameters():
    from pytorch_lightning.utilities import AttributeDict

    return AttributeDict(
        device="cpu",
        trajectory_length=100,
        trajectory_initializer=AttributeDict(
            name="AstarTrajectoryInitializer",
            resolution=1.0,  # the generated worlds' grid resolution
            init_angles_with_trajectory=False,
        ),
        collision_model=AttributeDict(
            mean=0, sigma=5, use_cos=True, bias=True, use_normal_init=True,
            angle_encoding=True, name="ONF",
        ),
        collision_optimizer=AttributeDict(lr=2e-2, betas=(0.9, 0.9)),
        trajectory_optimizer=AttributeDict(lr=5e-2, betas=(0.9, 0.9)),
        planner=AttributeDict(
            name="ConstrainedNERFOptPlanner",
            trajectory_random_offset=0.02,
            collision_weight=100,
            velocity_hessian_weight=0.5,
            random_field_points=10,
            init_collision_iteration=100,
            constraint_deltas_weight=100,
            multipliers_lr=0.1,
            init_collision_points=200,
            reparametrize_trajectory_freq=10,
            optimize_collision_model_freq=1,
            angle_weight=5,
            angle_offset=0.3,
            boundary_weight=1,
            direction_delta_weight=100,
            collision_multipliers_lr=1e-3,
            collision_beta=10,
            course_random_offset=1.5,
        ),
    )


def _patch_reference_reparametrize():
    """The reference's AstarTrajectoryInitializer fails on its own A* output
    when the start or goal sits on a path cell's centre: the zero-length
    segment gives a duplicate arc-length x, and scipy's quadratic interp1d
    (utils/math.py:57-65) raises. Wrap the module-level function in a
    consecutive-duplicate filter (glue of this script; the reference's bench-mr
    starts never sit on cell centres, the generated worlds' may)."""
    import neural_field_optimal_planner.astar.astar_trajectory_initializer as ati

    if getattr(ati, "_nfopp_dedup_patch", False):
        return
    orig = ati.reparametrize_path

    def dedup_reparametrize(path, length, *a, **k):
        keep = np.ones(len(path), bool)
        keep[1:] = np.linalg.norm(np.diff(path, axis=0), axis=1) > 1e-9
        return orig(path[keep], length, *a, **k)

    ati.reparametrize_path = dedup_reparametrize
    ati._nfopp_dedup_patch = True


def reference_run(scenario, seed: int, iterations: int, evaluator, suite: str = "corridor",
                  checker=None):
    """One reference solve with the run_bench_mr.py tracking loop; returns
    (final path [102, 3] or None on an A* failure, collides, length,
    seconds). `checker` overrides the dilated-grid checker (e.g. the exact
    polygon checker)."""
    _import_reference()
    import torch

    torch.random.manual_seed(seed + 100)
    np.random.seed(seed + 400)
    torch.autograd.set_detect_anomaly(False)
    from neural_field_optimal_planner.planner_factory import PlannerFactory

    _patch_reference_reparametrize()

    if checker is None:
        checker = _make_grid_checker(dilated_blocked(scenario), scenario.origin,
                                     scenario.resolution, scenario.bounds)
    planner = PlannerFactory.make_constrained_onf_planner(checker, _reference_parameters(suite))
    t0 = time.time()
    try:
        # init() adds the [None] batch dim itself (nerf_opt_planner.py:181-183)
        planner.init(scenario.start.astype(np.float32), scenario.goal.astype(np.float32),
                     scenario.bounds)
    except Exception as exc:  # A* init failure (no path at this resolution)
        print(f"    reference init failed: {type(exc).__name__}: {exc}")
        return None, True, np.nan, time.time() - t0

    # best-path tracking loop, run_bench_mr.py:111-134
    best_length, best_path = np.inf, None
    for i in range(iterations):
        planner.step()
        if i > 200 and i % 50 == 0:
            path = planner.get_path()
            collision, length = evaluator(path)
            if not collision and length < best_length:
                best_length, best_path = length, path
            elif not collision:
                break
    path = planner.get_path()
    collision, length = evaluator(path)
    if collision and best_path is not None:
        path, collision, length = best_path, False, best_length
    return path, collision, length, time.time() - t0


# ------------------------------------------------------------------- main


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--suite", choices=["corridor", "forest", "movingai", "warehouse"],
                        default="corridor")
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--min-geodesic", type=float, default=0.0,
                        help="resample endpoint pairs until the dilated-grid geodesic is "
                        "at least this long (the default endpoints are often a few "
                        "cells apart)")
    parser.add_argument("--full-budget", action="store_true",
                        help="the port's side: spend the whole iteration budget refining "
                        "(no plateau early stop)")
    parser.add_argument("--restart-failed", type=int, default=0,
                        help="the port's side: portfolio restarts for infeasible problems "
                        "(reported separately: changes the comparison from single-solve "
                        "parity)")
    parser.add_argument("--restart-rounds", type=int, default=1,
                        help="the port's side: iterate the restart fallback up to this "
                        "many rounds (fresh streams each round)")
    parser.add_argument("--exact", action="store_true",
                        help="warehouse only: both sides plan and are evaluated against "
                        "the TRUE polygon geometry (PolygonOracle / its numpy twin) "
                        "instead of the rasterized grid, with the footprint as exact "
                        "edge-distance inflation; also reports the rasterized-vs-exact "
                        "feasibility delta")
    parser.add_argument("--device", default="cuda",
                        help="device of the port's solve (cuda, or cpu for the plain "
                        "PyTorch path)")
    parser.add_argument("--skip-reference", action="store_true")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    if args.exact and args.suite != "warehouse":
        parser.error("--exact is only meaningful for the polygon (warehouse) suite")

    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "compare_suites_torch.py")
    scenarios = build_scenarios(args.suite, args.seeds, args.min_geodesic)
    grid_evals = grid_evaluators(scenarios, device)
    solve_oracles = oracle_fn = poly_lists = None
    if args.exact:
        from nfopp_tpu_torch.worlds import polygon_collision

        poly_lists, solve_oracles, single_oracles = build_exact_oracles(args.seeds, device)
        oracle_fn = polygon_collision
        evaluators = [make_evaluator(polygon_collision, o) for o in single_oracles]
    else:
        evaluators = grid_evals

    ours_paths, ours_time = ours_suite_run(
        scenarios, suite_parameters(args.suite), args.iterations, args.full_budget,
        args.restart_failed, solve_oracles=solve_oracles, oracle_fn=oracle_fn,
        restart_rounds=args.restart_rounds, device=device,
    )
    ours_eval = [ev(p) for ev, p in zip(evaluators, ours_paths)]
    ours_feasible = np.array([not c for c, _ in ours_eval])
    ours_lengths = np.array([length for _, length in ours_eval])
    print(f"ours:      feasible {ours_feasible.sum()}/{len(scenarios)}, "
          f"wall {ours_time:.1f}s for ALL {len(scenarios)} problems (batched)")

    if reference_path(args.skip_reference) is None:
        print("reference: skipped")
        if args.json_out:
            report = {
                "suite": args.suite, "seeds": args.seeds, "iterations": args.iterations,
                "min_geodesic": args.min_geodesic, "full_budget": args.full_budget,
                "restart_failed": args.restart_failed, "restart_rounds": args.restart_rounds,
                "ours_feasible": int(ours_feasible.sum()),
                "ours_feasible_mask": ours_feasible.tolist(),
                "ours_lengths": [round(float(x), 4) for x in ours_lengths],
                "ours_wall_s": round(ours_time, 1),
                "device": str(device),
            }
            pathlib.Path(args.json_out).write_text(json.dumps(report, indent=1))
            print(f"report written to {args.json_out}")
        return 0

    ref_eval, ref_paths, ref_secs = [], [], 0.0
    for k, (scenario, ev) in enumerate(zip(scenarios, evaluators)):
        checker = None
        if args.exact:
            checker = _make_exact_polygon_checker(poly_lists[k], FOOTPRINT_RADIUS,
                                                  scenario.bounds)
        path, collision, length, secs = reference_run(scenario, k, args.iterations, ev,
                                                      args.suite, checker=checker)
        ref_secs += secs
        ref_eval.append((collision, length))
        ref_paths.append(path)
        status = "init-failed" if path is None else ("COLLIDES" if collision else "feasible")
        print(f"  reference problem {k}: {status} ({secs:.1f}s)")
    ref_feasible = np.array([not c for c, _ in ref_eval])
    ref_lengths = np.array([length for _, length in ref_eval])
    print(f"reference: feasible {ref_feasible.sum()}/{len(scenarios)}, "
          f"wall {ref_secs:.1f}s sequential")

    both = ours_feasible & ref_feasible
    report = {
        "suite": args.suite,
        "exact_geometry": bool(args.exact),
        "seeds": args.seeds,
        "iterations": args.iterations,
        "min_geodesic": args.min_geodesic,
        "footprint_radius": FOOTPRINT_RADIUS,
        "full_budget": args.full_budget,
        "restart_failed": args.restart_failed,
        "restart_rounds": args.restart_rounds,
        "ours_feasible": int(ours_feasible.sum()),
        "ref_feasible": int(ref_feasible.sum()),
        "both_feasible": int(both.sum()),
        "ours_feasible_mask": ours_feasible.tolist(),
        "ref_feasible_mask": ref_feasible.tolist(),
        "ours_lengths": [round(float(x), 4) for x in ours_lengths],
        "ref_lengths": [None if np.isnan(x) else round(float(x), 4) for x in ref_lengths],
        "ours_wall_s": round(ours_time, 1),
        "ref_wall_s": round(ref_secs, 1),
        "device": str(device),
    }
    if both.any():
        ratio = ours_lengths[both].mean() / ref_lengths[both].mean()
        report["cost_ratio_both_feasible"] = round(float(ratio), 4)
        print(f"cost ratio over {both.sum()} both-feasible problems "
              f"(ours/reference): {ratio:.4f} ({(ratio - 1) * 100:+.2f}%)")
    if args.exact:
        # rasterized-vs-exact feasibility delta: the same paths re-checked
        # against the footprint-dilated grid
        ours_grid = np.array([not ev(p)[0] for ev, p in zip(grid_evals, ours_paths)])
        ref_grid = np.array([(p is not None) and (not ev(p)[0])
                             for ev, p in zip(grid_evals, ref_paths)])
        report["delta_rasterized"] = {
            "ours_feasible_exact": int(ours_feasible.sum()),
            "ours_feasible_rasterized": int(ours_grid.sum()),
            "ours_disagreements": int((ours_feasible != ours_grid).sum()),
            "ref_feasible_exact": int(ref_feasible.sum()),
            "ref_feasible_rasterized": int(ref_grid.sum()),
            "ref_disagreements": int((ref_feasible != ref_grid).sum()),
        }
        print(f"rasterized-vs-exact delta: ours exact {int(ours_feasible.sum())} vs "
              f"rasterized {int(ours_grid.sum())}; reference exact "
              f"{int(ref_feasible.sum())} vs rasterized {int(ref_grid.sum())}")
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(report, indent=1))
        print(f"report written to {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
