#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, a short
window of the cell's own traffic, then the numbers its check compares, once
for the program (the lower readings) and once with the control, the
reference in the nearest precision below the configuration's, in the
program's place (the upper readings). One process serves every seed.

    python3 nfbench/readings.py --workload car-batch-256 --seeds 1,2,3 --seconds 8

Prints one JSON line per seed and candidate on standard output. With
`--fault <name>`, one of the faults the cell's traffic lists
(`nfbench/faults.py`) is planted under the timed path first and only the
program is read: the readings a fault gives at the cell's own size.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from nfbench.harness import core  # noqa: E402


def spread(gaps) -> dict:
    """Quantiles of one followed unit's gaps per problem."""
    v = torch.sort(gaps.double().cpu()).values
    return {q: float(v[min(len(v) - 1, int(q * len(v)))]) for q in (0.25, 0.5, 0.9, 0.99, 1.0)}


def readings(cell, seeds, seconds: float, device, overrides=None, candidates=("program", "control")):
    """[(seed, candidate, {name: value})] for every seed."""
    out = []
    for seed in seeds:
        driver = core.driver_module(cell.traffic["driver"]).Driver(
            cell, seed, device, core.Spans(), overrides or {})
        driver.setup()
        driver.window(seconds, core.Tracer(False, driver.spans, device))
        for candidate in candidates:
            numbers = {name: value for name, value, _ in driver.judge(candidate)}
            detail = getattr(driver, "detail", {})
            numbers["detail"] = {key: spread(torch.cat(gaps)) for key, gaps in detail.items()}
            if detail:
                numbers["detail"]["all"] = spread(torch.cat([g for gaps in detail.values()
                                                             for g in gaps]))
            out.append((seed, candidate, numbers))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--fault", default=None, help="a fault the cell's traffic lists")
    args = parser.parse_args(argv)
    core.cache_dirs()
    cell = core.Cell.load(args.workload)
    candidates = ("program", "control")
    if args.fault is not None:
        from nfbench import faults

        faults.plant(cell.small["faults"][args.fault])
        candidates = ("program",)
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for seed, candidate, numbers in readings(cell, [int(s) for s in args.seeds.split(",")],
                                             args.seconds, device, candidates=candidates):
        print(json.dumps({"workload": args.workload, "seed": seed, "candidate": candidate,
                          "fault": args.fault, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
