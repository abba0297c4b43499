#!/usr/bin/env python3
"""Two-walls reliability probe of the port (the counterpart of
scripts/two_walls_reliability.py): portfolio restarts against single solves.

The reference does not reliably solve its own two-walls demo scene (two
offset walls; BASELINE_MEASURED.md). Over S seeds this probe measures
  (a) single-solve feasibility (the reference-equivalent behaviour),
  (b) portfolio feasibility (R random restarts, the best feasible picked),
  (c) the portfolio with one field shared by the restarts,
each through `BatchPlanner.solve_portfolio` on one device. Where the JAX
script gives all three solves of a seed the key PRNGKey(seed), each solve
here draws from a fresh `torch.Generator` seeded with the seed.

    python3 scripts/two_walls_reliability_torch.py --seeds 10 --restarts 8 \
        --record artifacts/two_walls_reliability.json
    python3 scripts/two_walls_reliability_torch.py --seeds 1 --restarts 2 \
        --iterations 100 --device cpu

The flags are two_walls_reliability.py's, except --cpu, which --device
replaces (default cuda), and --record, which sets each rate against the JSON
line of an earlier run (the JAX package's record, for one) by Fisher's exact
test (two-sided p per rate, under "fisher_p").
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def scene(device):
    """(planner, start, goal, bounds, oracle) of the SE(2) two-walls scene
    with a disc robot of radius 0.3 and run_planner_config."""
    import torch

    from nfopp_tpu_torch.parallel import BatchPlanner
    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.worlds import (
        CircleOracle,
        circle_collision,
        pad_obstacle_points,
        two_walls_se2_environment,
    )

    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    oracle = CircleOracle(torch.tensor(pts, device=device)[None],
                          torch.tensor(mask, device=device)[None],
                          torch.tensor([0.3], device=device),
                          torch.tensor([[0.0, 3.0, 0.0, 3.0]], device=device))
    solver = ConstrainedSolver(run_planner_config(), circle_collision, device=device)
    bounds = np.asarray(env.bounds, np.float32)
    return BatchPlanner(solver), env.start, env.goal, bounds, oracle


def reliability(seeds: int, restarts: int, iterations: int, device="cuda",
                log=None) -> dict:
    """The three feasible rates over `seeds` seeds (the script's JSON line)."""
    import torch

    planner, start, goal, bounds, oracle = scene(device)

    def solve(seed, count, shared=False):
        g = torch.Generator(device=planner.device).manual_seed(seed)
        result = planner.solve_portfolio(g, start, goal, bounds, oracle, restarts=count,
                                         max_iterations=iterations, shared_field=shared)
        return bool(result.feasible)

    single_ok, portfolio_ok, shared_ok = [], [], []
    for seed in range(seeds):
        single_ok.append(solve(seed, 1))
        portfolio_ok.append(solve(seed, restarts))
        shared_ok.append(solve(seed, restarts, shared=True))
        if log is not None:
            log(f"seed {seed}: single={single_ok[-1]} portfolio={portfolio_ok[-1]} "
                f"shared={shared_ok[-1]}")
    return {
        "metric": "two_walls_feasible_rate",
        "seeds": seeds,
        "restarts": restarts,
        "iterations": iterations,
        "single": sum(single_ok) / seeds,
        "portfolio": sum(portfolio_ok) / seeds,
        "portfolio_shared_field": sum(shared_ok) / seeds,
        "device": (torch.cuda.get_device_name(planner.device)
                   if planner.device.type == "cuda" else "cpu"),
    }


def fisher_against_record(result: dict, record: dict) -> dict:
    """Two-sided p of Fisher's exact test for each of the three rates: this
    run's feasible count out of its seeds against the record's."""
    from scipy.stats import fisher_exact

    p = {}
    for rate in ("single", "portfolio", "portfolio_shared_field"):
        counts = []
        for run in (result, record):
            solved = round(run[rate] * run["seeds"])
            counts.append([solved, run["seeds"] - solved])
        p[rate] = float(fisher_exact(counts).pvalue)
    return p


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--restarts", type=int, default=8)
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--device", default="cuda",
                        help="device of the solves (cuda, or cpu for the plain PyTorch path)")
    parser.add_argument("--record", default=None,
                        help="JSON line of an earlier run to test each rate against")
    args = parser.parse_args()

    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "two_walls_reliability_torch.py")
    enable_compile_cache(device)  # the kernel library, before any timing
    result = reliability(args.seeds, args.restarts, args.iterations, device,
                         log=lambda msg: print(msg, file=sys.stderr, flush=True))
    if args.record:
        result["fisher_p"] = fisher_against_record(
            result, json.loads(pathlib.Path(args.record).read_text()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
