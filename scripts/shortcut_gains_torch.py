#!/usr/bin/env python3
"""The shortcut-gains record of the port (the counterpart of
scripts/shortcut_gains.py, which made artifacts/shortcut_gains.json).

For each world class: run the full-budget suite ONCE on the parity worlds
(the generators and endpoints of compare_suites_torch.py), then apply the
random-pair shortcut pass to the SAME solved paths and measure the length
gain and the repair count under the runner's accounting
(bench/runner.py::_shortcut_pass: a chord whose dense re-check passes is
taken, and taken-over-infeasible counts as `repaired`). The reference's
lengths come from the committed parity artifacts (the reference never
simplifies: get_path returns the raw iterate).

    python3 scripts/shortcut_gains_torch.py --out shortcut_gains_torch.json
    python3 scripts/shortcut_gains_torch.py --suites corridor --smoke --device cpu

The flags are shortcut_gains.py's, except --cpu, which --device replaces
(default cuda); --out defaults to a file in the working directory.
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

TRIALS = 128
SHORTCUT_SEED = 0x5C0C  # run_grid_suite's shortcut seed (seed 0)

SUITES = {
    # suite -> (seeds, min_geodesic, iterations, parity artifact with the reference's lengths)
    "corridor": (10, 160.0, 1000, "artifacts/parity_corridor.json"),
    "forest": (20, 80.0, 1000, "artifacts/parity_forest.json"),
    "warehouse": (10, 0.0, 1000, "artifacts/parity_warehouse_fullbudget.json"),
    "movingai": (10, 0.0, 3000, "artifacts/parity_movingai_fullbudget.json"),
}
SMOKE_ITERATIONS = 100  # --smoke: a mechanics check, the ratios mean nothing

# the reference side's feasibility for parity artifacts that predate the
# ref_feasible_mask field: corridor was 10/10; forest's reference failed seeds
# 0, 4 and 17 (BASELINE_MEASURED.md)
REF_FAIL_SEEDS = {"corridor": [], "forest": [0, 4, 17]}


def reference_row(suite: str, seeds: int, feasible_s: np.ndarray, lengths_s: np.ndarray) -> dict:
    """The shortcut paths against the reference's lengths of the committed
    parity artifact, on the problems both solved."""
    parity_file = SUITES[suite][3]
    parity_path = ROOT / parity_file
    if not parity_path.exists():
        return {}
    parity = json.loads(parity_path.read_text())
    ref_lengths = parity.get("ref_lengths")
    ref_mask = parity.get("ref_feasible_mask")
    if ref_mask is None and suite in REF_FAIL_SEEDS:
        ref_mask = [s not in REF_FAIL_SEEDS[suite] for s in range(seeds)]
    if ref_lengths is None or ref_mask is None:
        return {}
    both = np.asarray(ref_mask, bool)[:len(feasible_s)] & feasible_s
    ref_arr = np.asarray([np.nan if x is None else x for x in ref_lengths])[:len(feasible_s)]
    if not both.any():
        return {}
    return {
        "both_feasible": int(both.sum()),
        "vs_reference_ratio_both_feasible": round(float(
            lengths_s[both].mean() / ref_arr[both].mean()), 4),
        "ref_parity_artifact": parity_file,
    }


def suite_gains(suite: str, smoke: bool = False, device="cuda") -> dict:
    """One world class: the full-budget suite, then the shortcut pass on the
    same paths; the row of the record."""
    import torch

    from compare_suites_torch import FOOTPRINT_RADIUS, build_scenarios, suite_parameters

    from nfopp_tpu_torch.bench.runner import _shortcut_pass, _stack_oracles, run_grid_suite
    from nfopp_tpu_torch.solver import ConstrainedSolver, config_from_parameters
    from nfopp_tpu_torch.worlds import grid_collision

    seeds, min_geo, iterations, _ = SUITES[suite]
    if smoke:
        iterations = SMOKE_ITERATIONS
    t0 = time.time()
    scenarios = build_scenarios(suite, seeds, min_geo)
    parameters = suite_parameters(suite)
    result = run_grid_suite(
        scenarios, parameters, footprint_radius=FOOTPRINT_RADIUS,
        max_iterations=iterations, min_iterations=200, check_freq=50,
        stop_on_plateau=False, device=device,
    )
    solver = ConstrainedSolver(config_from_parameters(parameters), grid_collision, device=device)
    oracles = _stack_oracles([s.oracle(FOOTPRINT_RADIUS, solver.device) for s in scenarios])
    paths_s, lengths_s, feasible_s, repaired = _shortcut_pass(
        solver, oracles, result.paths, result.lengths, result.feasible,
        torch.Generator(device=solver.device).manual_seed(SHORTCUT_SEED), TRIALS,
    )
    wall = time.time() - t0
    raw = result.feasible
    row = {
        "seeds": seeds,
        "iterations": iterations,
        "feasible_raw": int(raw.sum()),
        "feasible_after_shortcut": int(feasible_s.sum()),
        "repaired_by_shortcut": int(repaired.sum()),
        # null where no raw path is feasible (no mean to take)
        "mean_raw_feasible": float(result.lengths[raw].mean()) if raw.any() else None,
        "mean_shortcut_same_set": float(lengths_s[raw].mean()) if raw.any() else None,
        "gain_pct_feasible": (round(float(
            (1 - lengths_s[raw].mean() / result.lengths[raw].mean()) * 100), 3)
            if raw.any() else None),
        "wall_s": round(wall, 1),
    }
    row.update(reference_row(suite, seeds, feasible_s, lengths_s))
    return row


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="shortcut_gains_torch.json")
    parser.add_argument("--suites", default="corridor,forest,warehouse,movingai")
    parser.add_argument("--device", default="cuda",
                        help="device of the solves (cuda, or cpu for the plain PyTorch path)")
    parser.add_argument("--smoke", action="store_true",
                        help=f"mechanics check: {SMOKE_ITERATIONS}-iteration solves (the "
                        "ratios mean nothing; the record is not for keeping)")
    args = parser.parse_args()

    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "shortcut_gains_torch.py")
    enable_compile_cache(device)  # the kernel library, before any timing
    out = {
        "postprocess": f"ops/shortcut.py random-pair shortcutting, {TRIALS} trials per "
                       "path, dense 5-sample check",
        "note": "the worlds of the parity_* artifacts; the shortcut pass is applied to "
                "the SAME solved paths (one suite solve, then the pass): a chord whose "
                "dense re-check passes is taken, take-over-infeasible is counted in "
                "repaired_by_shortcut. The reference never simplifies.",
        "trials": TRIALS,
        "device": str(device),
    }
    for suite in args.suites.split(","):
        out[suite] = suite_gains(suite, args.smoke, device)
        print(json.dumps({suite: out[suite]}), file=sys.stderr, flush=True)
    text = json.dumps(out, indent=2)
    pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
