"""Where a step of the PyTorch/CUDA port's main path spends its time.

Runs the workload of `chip_smoke.py`'s main path (car scene, run_planner_config
in f32, or with --bf16 in bf16 as bench.py runs it by default, B problems,
seeded) on one CUDA card: `--warmup` steps, then
`--steps` steps timed on the host clock, then the same number of steps under
torch.profiler. The trace's kernel events give the device's busy time per
step (kernels on the one stream do not overlap), its idle share, and the
time and launches per step of each kernel. Prints one JSON object; the
Chrome trace goes to --trace.

    python3 -m nfopp_tpu_torch.tools.profile_step --trace profiles/torch_step_trace.json
    python3 -m nfopp_tpu_torch.tools.profile_step --bf16 --trace profiles/torch_step_trace_bf16.json
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time

import torch

from ..solver import ConstrainedSolver, run_planner_config
from ..worlds import rectangle_collision
from .scene import car_world, card_line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--warmup", type=int, default=20)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="the field's products in bf16 (compute_dtype='bfloat16')")
    parser.add_argument("--trace", default="profiles/torch_step_trace.json")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    oracle, start, goal, bounds = car_world(args.batch, device)
    cfg = run_planner_config()
    if args.bf16:
        cfg = cfg._replace(onf=cfg.onf._replace(compute_dtype="bfloat16"))
    solver = ConstrainedSolver(cfg, rectangle_collision, device=device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    # warm-up and the timed window use whole chunks of the static schedule
    state, _ = solver.run(state, oracle, args.warmup, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = solver.run(state, oracle, args.steps, g)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, _ = solver.run(state, oracle, args.steps, g)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / args.steps * 1e3
    trace = pathlib.Path(args.trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))

    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the trace holds no kernel events: device time not measured")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    busy_us = sum(e["dur"] for e in kernels)
    window_us = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "")]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "card": card_line(),
        "compute_dtype": cfg.onf.compute_dtype,
        "batch": args.batch,
        "host_ms_per_step": host_ms,
        "profiled_ms_per_step": profiled_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_window_ms_per_step": window_us / 1e3 / args.steps,
        # the profiled window is stretched by the profiler's own overhead; the
        # busy time against the unprofiled step is the better idle estimate
        "idle_share_profiled_window": 1.0 - busy_us / window_us,
        "idle_share_vs_host_step": 1.0 - busy_us / 1e3 / args.steps / host_ms,
        "kernels_per_step": len(kernels) / args.steps,
        "launch_calls_per_step": len(launches) / args.steps,
        "host_launch_ms_per_step": sum(e["dur"] for e in launches) / 1e3 / args.steps,
        "top_kernels": [
            {"name": name[:80], "ms_per_step": us / 1e3 / args.steps,
             "launches_per_step": n / args.steps, "share_of_busy": us / busy_us}
            for name, (us, n) in top
        ],
    }
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
