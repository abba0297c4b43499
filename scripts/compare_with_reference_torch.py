#!/usr/bin/env python3
"""Seed-averaged quality parity of the port against the PyTorch reference
(the counterpart of scripts/compare_with_reference.py).

Runs both planners on the reference demo problem (the car/parking scene,
rectangle footprint, run_planner.py's configuration, 1000 iterations) over
N seeds and compares them with a COMMON evaluation (dense-path collision
check and xy path length by the port's `evaluate_path`):

  * feasibility rate (collision-free final paths)
  * mean feasible path length (the "final trajectory cost within 1%"
    anchor; the random streams differ between the planners, so the
    comparison is seed-averaged)

The port solves all seeds as ONE batch on one card: problem i draws from
the batch's generator (seeded with --seed), not from a stream of its own.
The reference is imported in place from a checkout of the reference
repository named by the environment variable NFOPP_REFERENCE; with the
variable unset, or no directory there, the script prints `reference: skipped`.

    python3 scripts/compare_with_reference_torch.py --seeds 5
    python3 scripts/compare_with_reference_torch.py --seeds 2 --iterations 20 --device cpu

The flags are compare_with_reference.py's, except --cpu, which --device
replaces (default cuda), and --seed.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from compare_suites_torch import _import_reference, reference_path  # noqa: E402


def reference_run(seed: int, iterations: int):
    """One reference solve; returns (path [102, 3], seconds)."""
    _import_reference()
    import torch

    torch.random.manual_seed(seed)
    np.random.seed(seed + 300)
    from pytorch_lightning.utilities import AttributeDict
    from neural_field_optimal_planner.collision_checker import RectangleCollisionChecker
    from neural_field_optimal_planner.planner_factory import PlannerFactory
    from neural_field_optimal_planner.test_environment_builder import TestEnvironmentBuilder

    torch.autograd.set_detect_anomaly(False)

    params = AttributeDict(
        device="cpu",
        trajectory_length=100,
        collision_model=AttributeDict(
            mean=0, sigma=1, use_cos=True, bias=True, use_normal_init=True,
            angle_encoding=True, name="ONF",
        ),
        trajectory_initializer=AttributeDict(name="TrajectoryInitializer", resolution=0.05),
        collision_optimizer=AttributeDict(lr=5e-2, betas=(0.9, 0.9)),
        trajectory_optimizer=AttributeDict(lr=1e-2, betas=(0.9, 0.9)),
        planner=AttributeDict(
            name="ConstrainedNERFOptPlanner", trajectory_random_offset=0.02,
            collision_weight=1, velocity_hessian_weight=0.5, random_field_points=10,
            init_collision_iteration=0, constraint_deltas_weight=20, multipliers_lr=0.1,
            init_collision_points=100, reparametrize_trajectory_freq=10,
            optimize_collision_model_freq=1, angle_weight=0.5, angle_offset=0.3,
            boundary_weight=1, collision_multipliers_lr=1e-3,
        ),
    )
    env = TestEnvironmentBuilder().make_car_environment()
    checker = RectangleCollisionChecker((-0.3, 0.2, -0.3, 0.2), (0, 3, 0, 3))
    checker.update_obstacle_points(env.obstacle_points)
    planner = PlannerFactory.make_constrained_onf_planner(checker, params)
    planner.init(env.start_point, env.goal_point, env.bounds)
    t0 = time.time()
    for _ in range(iterations):
        planner.step()
    return planner.get_path(), time.time() - t0


def ours_run(seeds, iterations: int, device="cuda", seed: int = 0):
    """All seeds solved at once as one batch on `device`, with
    run_planner_config; returns (paths [S, 102, 3] numpy, seconds)."""
    import torch

    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(len(seeds), device)
    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=device)
    g = torch.Generator(device=solver.device).manual_seed(seed)
    states = solver.init_state(g, start, goal, bounds, oracle)
    sync = torch.cuda.synchronize if solver.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    states, _ = solver.run(states, oracle, iterations, g)
    sync()
    elapsed = time.time() - t0
    return solver.full_trajectory(states).cpu().numpy(), elapsed


def evaluate(paths: np.ndarray, device="cuda"):
    """Common metric: dense-collision feasibility + xy path length, all
    paths [S, M, 3] at once."""
    import torch

    from nfopp_tpu_torch.solver import evaluate_path
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle = car_world(1, device)[0]
    collides, lengths = evaluate_path(
        rectangle_collision, oracle,
        torch.as_tensor(np.asarray(paths, np.float32), device=device), 5)
    return ~collides.cpu().numpy(), lengths.cpu().numpy()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=5)
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the port's batch generator")
    parser.add_argument("--device", default="cuda",
                        help="device of the port's solve (cuda, or cpu for the plain "
                        "PyTorch path)")
    parser.add_argument("--skip-reference", action="store_true")
    args = parser.parse_args()

    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "compare_with_reference_torch.py")
    seeds = list(range(args.seeds))
    ours_paths, ours_time = ours_run(seeds, args.iterations, device, args.seed)
    ours_feasible, ours_lengths = evaluate(ours_paths, device)
    ours_mean = ours_lengths[ours_feasible].mean() if ours_feasible.any() else float("nan")
    print(f"ours:      feasible {ours_feasible.sum()}/{len(seeds)}, "
          f"mean feasible length {ours_mean:.4f}, "
          f"wall {ours_time:.1f}s for ALL {len(seeds)} seeds (batched)")

    if reference_path(args.skip_reference) is None:
        print("reference: skipped")
        return 0
    try:
        ref_paths, ref_times = [], []
        for s in seeds:
            path, secs = reference_run(s, args.iterations)
            ref_paths.append(path)
            ref_times.append(secs)
        ref_paths = np.asarray(ref_paths)
    except Exception as exc:  # the reference or its dependencies unavailable
        print(f"reference: unavailable ({type(exc).__name__}: {exc})")
        return 0
    ref_feasible, ref_lengths = evaluate(ref_paths, device)
    ref_mean = ref_lengths[ref_feasible].mean() if ref_feasible.any() else float("nan")
    print(f"reference: feasible {ref_feasible.sum()}/{len(seeds)}, "
          f"mean feasible length {ref_mean:.4f}, "
          f"wall {np.sum(ref_times):.1f}s sequential")

    if ours_feasible.any() and ref_feasible.any():
        ratio = ours_mean / ref_mean
        print(f"cost ratio (ours/reference, path length): {ratio:.4f} "
              f"({(ratio - 1) * 100:+.2f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
