#!/usr/bin/env python3
"""Holonomic base-planner parity of the port (the counterpart of
scripts/compare_holonomic.py): `nfopp_tpu_torch.solver.HolonomicSolver`
against the reference's NERFOptPlanner (nerf_opt_planner.py:60-71) on the
reference's own holonomic fixture (test/test_nerf_opt_planner.py:14-26):

  * the two-walls scene, start (0.5, 0.5) -> goal (2.5, 2.5), bounds
    (-0.1..3.1)
  * ONF(mean=1.5, sigma=1): use_cos=False, use_normal_init=False
  * a disc robot of radius 0.3, bounds (0, 3, 0, 3)
  * Adam 1e-2 on both optimizers (torch's defaults: betas (0.9, 0.999))
  * trajectory_random_offset 0.02, collision_weight 0.5,
    velocity_hessian_weight 1, init_collision_iteration 100 (the
    constructor's defaults, nerf_opt_planner.py:12-14)

The methodology of compare_with_reference_torch.py: N seeds on each side
(the random streams differ, so the comparison is seed-averaged), a common
dense evaluation (circle-oracle collision at 5 samples per segment, xy
length). The port solves all seeds as one batch on one card (problem i draws
from the batch's generator), then again with best-path tracking over the
full budget, then restarts the still-infeasible seeds with fresh generators
(up to 4 rounds). The reference is imported in place from a checkout named by
the environment variable NFOPP_REFERENCE; with the variable unset, or no
directory there, the script prints `reference: skipped`.

The two-walls scene is knife-edge for the pure-gradient holonomic planner
(BASELINE_MEASURED.md): feasibility below 1.0 is expected on both sides.

    python3 scripts/compare_holonomic_torch.py --seeds 20
    python3 scripts/compare_holonomic_torch.py --seeds 2 --iterations 50 --device cpu

The flags are compare_holonomic.py's, except --cpu, which --device replaces
(default cuda), and --seed.
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
sys.path.insert(0, str(ROOT / "scripts"))

from compare_suites_torch import _import_reference, reference_path  # noqa: E402
MAX_RESTART_ROUNDS = 4
RESTART_SEED_STRIDE = 1000  # round r's generator: seed + 1000 r (JAX: PRNGKey(s + 1000 r))


def reference_run(seed: int, iterations: int):
    """One reference NERFOptPlanner solve; returns (path [102, 2], seconds)."""
    _import_reference()
    import torch

    torch.random.manual_seed(seed)
    np.random.seed(seed + 300)
    # the reference test writes CollisionChecker(0.3, (0,3,0,3)), but the base
    # class takes only boundaries and ignores obstacles; the intended class is
    # CircleCollisionChecker (circle_collision_checker.py:6-14), used here
    from neural_field_optimal_planner.collision_checker import CircleCollisionChecker
    from neural_field_optimal_planner.nerf_opt_planner import NERFOptPlanner
    from neural_field_optimal_planner.onf_model import ONF
    from neural_field_optimal_planner.test_environment_builder import TestEnvironmentBuilder

    torch.autograd.set_detect_anomaly(False)

    env = TestEnvironmentBuilder.make_test_environment()
    collision_model = ONF(1.5, 1)
    collision_checker = CircleCollisionChecker(0.3, (0, 3, 0, 3))
    collision_checker.update_obstacle_points(env.obstacle_points)
    collision_optimizer = torch.optim.Adam(collision_model.parameters(), 1e-2)
    trajectory = torch.zeros(100, 2, requires_grad=True)
    trajectory_optimizer = torch.optim.Adam([trajectory], 1e-2)
    planner = NERFOptPlanner(
        trajectory, collision_model, collision_checker,
        collision_optimizer, trajectory_optimizer, 0.02, 0.5, 1,
    )
    planner.init(env.start_point, env.goal_point, env.bounds)
    t0 = time.time()
    for _ in range(iterations):
        planner.step()
    return planner.get_path(), time.time() - t0


def holonomic_config():
    from nfopp_tpu_torch.models import ONFConfig
    from nfopp_tpu_torch.solver import SolverConfig

    return SolverConfig(
        onf=ONFConfig(mean=1.5, sigma=1.0, use_cos=False, use_normal_init=False,
                      angle_encoding=False),
        collision_lr=1e-2,
        collision_betas=(0.9, 0.999),
        trajectory_lr=1e-2,
        trajectory_betas=(0.9, 0.999),
        trajectory_random_offset=0.02,
        collision_weight=0.5,
        velocity_hessian_weight=1.0,
        init_collision_iteration=100,
    )


def make_oracle(device):
    """The fixture's circle oracle (a leading axis of 1: one world)."""
    import torch

    from nfopp_tpu_torch.worlds import CircleOracle, pad_obstacle_points, two_walls_environment

    env = two_walls_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    return CircleOracle(torch.tensor(pts, device=device)[None],
                        torch.tensor(mask, device=device)[None],
                        torch.tensor([0.3], device=device),
                        torch.tensor([[0.0, 3.0, 0.0, 3.0]], device=device))


def ours_run(seeds, iterations: int, device="cuda", seed: int = 0):
    """All seeds at once on `device`: the final iterates (paths [S, 102, 2],
    wall s), the tracked solve's paths and feasibility (full budget,
    best-feasible tracking), and after up to 4 restart rounds of the
    infeasible seeds the paths, feasibility and rounds used per seed."""
    import torch

    from nfopp_tpu_torch.solver import HolonomicSolver, run_with_tracking
    from nfopp_tpu_torch.worlds import circle_collision, two_walls_environment

    env = two_walls_environment()
    oracle = make_oracle(device)
    solver = HolonomicSolver(holonomic_config(), circle_collision, device=device)
    sync = torch.cuda.synchronize if solver.device.type == "cuda" else (lambda: None)

    def init(count, generator):
        def tile(a):
            return np.tile(np.asarray(a, np.float32)[None], (count, 1))

        return solver.init_state(generator, tile(env.start), tile(env.goal), tile(env.bounds),
                                 oracle)

    g = torch.Generator(device=solver.device).manual_seed(seed)
    states = init(len(seeds), g)
    sync()
    t0 = time.time()
    final_states, _ = solver.run(states, oracle, iterations, g)
    sync()
    elapsed = time.time() - t0
    paths = solver.full_trajectory(final_states).cpu().numpy()

    # production mode: the full budget with best-feasible-path tracking
    # (run_bench_mr.py's semantics, stop_on_plateau=False), from the same
    # initial states, reported beside the final iterates
    result = run_with_tracking(solver, states, oracle, g, iterations, 200, 50, 5, False)
    tracked_paths = result.path.cpu().numpy()
    tracked_feasible = result.feasible.cpu().numpy()

    # the restart fallback (bench/runner.py's restart_failed): re-solve the
    # still-infeasible seeds with fresh streams at the same budget
    restart_paths = tracked_paths.copy()
    restart_feasible = tracked_feasible.copy()
    restarts_used = np.zeros(len(seeds), np.int32)
    for r in range(1, MAX_RESTART_ROUNDS + 1):
        if restart_feasible.all():
            break
        idx = np.flatnonzero(~restart_feasible)
        rg = torch.Generator(device=solver.device).manual_seed(seed + RESTART_SEED_STRIDE * r)
        res = run_with_tracking(solver, init(len(idx), rg), oracle, rg, iterations, 200, 50,
                                5, False)
        ok = res.feasible.cpu().numpy()
        restart_paths[idx[ok]] = res.path.cpu().numpy()[ok]
        restart_feasible[idx[ok]] = True
        restarts_used[idx] = r
    return (paths, elapsed, tracked_paths, tracked_feasible, restart_paths, restart_feasible,
            restarts_used)


def evaluate(paths: np.ndarray, device="cuda"):
    """Common metric: dense-collision feasibility + xy path length, all
    paths [S, M, 2] at once."""
    import torch

    from nfopp_tpu_torch.solver import evaluate_path
    from nfopp_tpu_torch.worlds import circle_collision

    collides, lengths = evaluate_path(
        circle_collision, make_oracle(device),
        torch.as_tensor(np.asarray(paths, np.float32), device=device), 5)
    return ~collides.cpu().numpy(), lengths.cpu().numpy()


def summary(seeds, ours, device) -> dict:
    """The record of the port's three solves (final iterate, tracked, with
    restarts), as the JAX script writes it."""
    (paths, elapsed, tracked_paths, _, restart_paths, _, restarts_used) = ours

    def row(p):
        feasible, lengths = evaluate(p, device)
        mean = float(lengths[feasible].mean()) if feasible.any() else None
        return {"feasible": int(feasible.sum()), "mean_feasible_length": mean}

    return {
        "fixture": "two_walls holonomic (test_nerf_opt_planner.py setUp)",
        "seeds": len(seeds),
        "ours": {**row(paths), "wall_s_batched": round(elapsed, 2)},
        "ours_tracked": row(tracked_paths),
        "ours_restarts": {
            **row(restart_paths),
            "max_restarts": MAX_RESTART_ROUNDS,
            # per seed, the restart rounds attempted (0: the first try was
            # feasible; a seed's last attempt may still have failed)
            "restarts_used": restarts_used.tolist(),
        },
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=20)
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the port's batch generator")
    parser.add_argument("--device", default="cuda",
                        help="device of the port's solves (cuda, or cpu for the plain "
                        "PyTorch path)")
    parser.add_argument("--skip-reference", action="store_true")
    parser.add_argument("--out", type=str, default=None, help="write a JSON record here")
    args = parser.parse_args()

    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "compare_holonomic_torch.py")
    seeds = list(range(args.seeds))
    ours = ours_run(seeds, args.iterations, device, args.seed)
    result = {**summary(seeds, ours, device), "iterations": args.iterations,
              "device": str(device)}
    mine, tracked, restarted = (result["ours"], result["ours_tracked"],
                                result["ours_restarts"])
    print(f"ours:      feasible {mine['feasible']}/{len(seeds)}, mean feasible length "
          f"{mine['mean_feasible_length']}, wall {mine['wall_s_batched']:.1f}s for ALL "
          f"{len(seeds)} seeds (batched)")
    print(f"ours+trk:  feasible {tracked['feasible']}/{len(seeds)}, mean feasible length "
          f"{tracked['mean_feasible_length']} (full budget + best-feasible tracking)")
    print(f"ours+rst:  feasible {restarted['feasible']}/{len(seeds)}, mean feasible length "
          f"{restarted['mean_feasible_length']} (+ up to {MAX_RESTART_ROUNDS} fresh-stream "
          "restarts of infeasible seeds)")

    ref_available = reference_path(args.skip_reference) is not None
    if ref_available:
        try:
            ref_paths, ref_times = [], []
            for s in seeds:
                path, secs = reference_run(s, args.iterations)
                ref_paths.append(path)
                ref_times.append(secs)
                print(f"  reference seed {s}: {secs:.1f}s", flush=True)
            ref_paths = np.asarray(ref_paths)
        except Exception as exc:
            print(f"reference: unavailable ({type(exc).__name__}: {exc})")
            ref_available = False
    if ref_available:
        ref_feasible, ref_lengths = evaluate(ref_paths, device)
        ref_mean = float(ref_lengths[ref_feasible].mean()) if ref_feasible.any() else None
        print(f"reference: feasible {ref_feasible.sum()}/{len(seeds)}, mean feasible length "
              f"{ref_mean}, wall {np.sum(ref_times):.1f}s sequential")
        result["reference"] = {"feasible": int(ref_feasible.sum()),
                               "mean_feasible_length": ref_mean,
                               "wall_s_sequential": round(float(np.sum(ref_times)), 2)}
        for key, mean in (("cost_ratio", mine["mean_feasible_length"]),
                          ("cost_ratio_tracked", tracked["mean_feasible_length"])):
            if mean is not None and ref_mean is not None:
                ratio = mean / ref_mean
                print(f"{key} (ours/reference, path length): {ratio:.4f} "
                      f"({(ratio - 1) * 100:+.2f}%)")
                result[key] = round(ratio, 4)
    else:
        print("reference: skipped")

    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
