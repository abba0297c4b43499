#!/usr/bin/env python3
"""Shared-field grouped-mode step cost against plain per-problem fields (the
counterpart of scripts/bench_grouped.py).

The shared-field mode (`ConstrainedSolver.run_grouped`) keeps one ONF field
per group of G problems by averaging the field gradients over the group.
This measures what that averaging costs on one card at B problems with
group sizes G, against the plain per-problem-field run, as bench.py runs
(bf16, the car scene, run_planner_config):

    python3 scripts/bench_grouped_torch.py --batch 256 --groups 8 32 256 [--aot]
    python3 scripts/bench_grouped_torch.py --device cpu --batch 4 --groups 2 --chunk 10 --chunks 1

Each label runs one warm-up --chunk, then --chunks timed chunks of --chunk
steps on an evolving state, host clock after a synchronize, and reports µs
per step per problem. --aot runs every chunk as replays of captured chunk
programs (`BatchPlanner(aot_prefix="grouped")`, one CUDA graph per 10
steps); the warm-up captures them. Prints one JSON object. --device is cuda
unless asked for the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def bench_grouped(device, batch: int, groups: list, chunk: int, chunks: int, aot: bool,
                  seed: int = 0) -> tuple[dict, list]:
    """({label: µs per step per problem}, aot_events) for the plain run and
    each group size."""
    import torch

    from nfopp_tpu_torch.parallel import BatchPlanner
    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    config = run_planner_config()
    config = config._replace(onf=config.onf._replace(compute_dtype="bfloat16"))
    solver = ConstrainedSolver(config, rectangle_collision, device=device)
    planner = BatchPlanner(solver, aot_prefix="grouped" if aot else None)
    oracle, starts, goals, bounds = car_world(batch, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def timed(init, run) -> float:
        g = torch.Generator(device=device).manual_seed(seed)
        states = run(init(g), g)  # warm-up (and capture)
        sync()
        t0 = time.perf_counter()
        for _ in range(chunks):
            states = run(states, g)
        sync()
        return (time.perf_counter() - t0) / (chunks * chunk) / batch * 1e6

    results = {"plain": timed(
        lambda g: planner.init_batch(g, starts, goals, bounds, oracle),
        lambda s, g: planner.run(s, oracle, chunk, g)[0])}
    for size in groups:
        results[f"grouped_{size}"] = timed(
            lambda g, size=size: planner.init_batch_grouped(g, starts, goals, bounds, oracle,
                                                            size),
            lambda s, g, size=size: planner.run_grouped(s, oracle, chunk, size, g)[0])
    return results, planner.aot_events


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--groups", type=int, nargs="+", default=[8, 32, 256])
    parser.add_argument("--chunk", type=int, default=200, help="steps per timed call")
    parser.add_argument("--chunks", type=int, default=3)
    parser.add_argument("--aot", action="store_true",
                        help="run the chunks as replays of captured chunk programs")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.tools.scene import card_line
    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "bench_grouped_torch")
    if enable_compile_cache(device):
        torch.backends.cuda.matmul.allow_tf32 = False
    results, events = bench_grouped(device, args.batch, args.groups, args.chunk, args.chunks,
                                    args.aot)
    out = {"batch": args.batch, "chunk": args.chunk, "compute_dtype": "bfloat16",
           "captured": args.aot, "us_per_step_per_problem": results,
           **({"aot_events": events} if args.aot else {}),
           "device": card_line() if device.type == "cuda" else "cpu"}
    print(json.dumps(out), flush=True)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
