#!/usr/bin/env python3
"""Hyperparameter sweep over a benchmark suite (the counterpart of
scripts/run_sweep.py): the reference's run_bench_mr_configured.py
capability (it sweeps sigma and collision_weight, :19-23, :69-80), batched:
every (sigma, collision weight) cell solves the whole seed batch at once
through `run_grid_suite` on one card.

    python3 scripts/run_sweep_torch.py --suite corridor --seeds 4 \
        --sigmas 2.5,5,10 --collision-weights 50,100,200
    python3 scripts/run_sweep_torch.py --seeds 2 --sigmas 5 --collision-weights 100 \
        --max-iterations 100 --device cpu

The flags are run_sweep.py's, except --cpu, which --device replaces
(default cuda); --out defaults to a file in the working directory.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def sweep_scenarios(suite: str, seeds: int):
    """The sweep's worlds: the generators' own endpoints, no resampling."""
    from nfopp_tpu_torch.worlds import corridor, random_forest

    make = corridor if suite == "corridor" else (lambda seed: random_forest(seed=seed))
    return [make(seed=s) for s in range(seeds)]


def cell_parameters(sigma: float, weight: float):
    """run_benchmark_torch.py's bench parameters with one cell's sigma and
    collision weight."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from run_benchmark_torch import bench_parameters

    from nfopp_tpu_torch.utils.config import Config

    return Config.from_dict(bench_parameters()).update({
        "collision_model": {"sigma": sigma},
        "planner": {"collision_weight": weight},
    }).as_attribute_dict()


def sweep(scenarios, sigmas, weights, max_iterations: int = 1000,
          footprint_radius: float = 1.0, device="cuda", log=print) -> list[dict]:
    """One suite solve per (sigma, collision weight); a row per cell."""
    import numpy as np

    from nfopp_tpu_torch.bench.runner import run_grid_suite

    rows = []
    log(f"{'sigma':>7} {'c_weight':>9} {'feasible':>9} {'mean_len':>9} {'wall_s':>7}")
    for sigma in sigmas:
        for weight in weights:
            result = run_grid_suite(scenarios, cell_parameters(sigma, weight),
                                    footprint_radius=footprint_radius,
                                    max_iterations=max_iterations, device=device)
            feasible = result.feasible
            mean_len = float(result.lengths[feasible].mean()) if feasible.any() else float("nan")
            rows.append({
                "sigma": sigma,
                "collision_weight": weight,
                "feasible": int(feasible.sum()),
                "total": len(feasible),
                "mean_feasible_length": mean_len if np.isfinite(mean_len) else None,
                "wall_s": result.wall_time,
            })
            log(f"{sigma:>7} {weight:>9} {int(feasible.sum()):>4}/{len(feasible):<4} "
                f"{mean_len:>9.2f} {result.wall_time:>7.1f}")
    return rows


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--suite", choices=["corridor", "forest"], default="corridor")
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--sigmas", default="2.5,5,10")
    parser.add_argument("--collision-weights", default="50,100,200")
    parser.add_argument("--max-iterations", type=int, default=1000)
    parser.add_argument("--footprint-radius", type=float, default=1.0)
    parser.add_argument("--out", default="nfopp_sweep_torch.json")
    parser.add_argument("--device", default="cuda",
                        help="device of the solves (cuda, or cpu for the plain PyTorch path)")
    args = parser.parse_args()

    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "run_sweep_torch.py")
    rows = sweep(sweep_scenarios(args.suite, args.seeds),
                 [float(x) for x in args.sigmas.split(",")],
                 [float(x) for x in args.collision_weights.split(",")],
                 args.max_iterations, args.footprint_radius, device)
    pathlib.Path(args.out).write_text(json.dumps(rows, indent=2))
    print(f"sweep saved to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
