"""Where a step of the PyTorch/CUDA port's main path spends its time.

Runs the workload of `chip_smoke.py`'s main path (car scene, run_planner_config
in f32, or with --bf16 in bf16 as bench.py runs it by default, B problems,
seeded) on one CUDA card, in the default step order or, with --order, in
the Jacobi order or the merged field+trajectory step
(`ExperimentalConstrainedSolver(jacobi_step=True | merged_step=True)`), and
with --aot (in any order) as replays of the captured programs
(`solver.with_aot`, captured in the warm-up: one CUDA graph per 10-step
chunk, or, where --warmup leaves the state off a chunk's start or --steps
is not a multiple of 10, one per step of the dynamic schedule):
`--warmup` steps, then
`--steps` steps timed on the host clock, then the same number of steps under
torch.profiler. The trace's kernel events give the device's busy time per
step (kernels on the one stream do not overlap), its idle share within the
profiled window, and the time and launches per step of each kernel, beside
the port's own kernels' launches per step (`kernels.LAUNCHES`, which count
through replays) and the program's `replay` spans per step
(`utils.profiling`: one per call of a captured program). Prints one JSON
object; the Chrome trace goes to --trace.

Reading the trace: the program's spans are ranges named
`nfopp_tpu_torch.<span>` on the CPU rows, on the device rows' clock. A gap
between kernels on the device row is explained by the innermost range the
host was in at that time: `nfopp_tpu_torch.sync` (the host waited for the
card to drain, then had nothing queued), `nfopp_tpu_torch.program` (the
program's key and lookup, or a capture), `nfopp_tpu_torch.replay` (the
copy-in and the graph's launch), `nfopp_tpu_torch.run.outputs` (the output
state's clone), or no range at all (this tool's own host work).

    python3 -m nfopp_tpu_torch.tools.profile_step --trace profiles/torch_step_trace.json
    python3 -m nfopp_tpu_torch.tools.profile_step --bf16 --trace profiles/torch_step_trace_bf16.json
    python3 -m nfopp_tpu_torch.tools.profile_step --order merged --trace profiles/merged.json
    python3 -m nfopp_tpu_torch.tools.profile_step --aot [--bf16] [--order merged] --trace profiles/aot.json
    python3 -m nfopp_tpu_torch.tools.profile_step --aot --warmup 25   # off the chunk
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import tempfile
import time

import torch

from .. import kernels as port_kernels
from ..experimental import ExperimentalConstrainedSolver
from ..solver import ConstrainedSolver, run_planner_config
from ..utils import profiling
from ..utils.aot import aot_or_compile
from ..worlds import rectangle_collision
from .scene import car_world, card_line


def trace_events(prof, trace) -> list:
    """The events of profiler `prof`'s Chrome trace, written to `trace`."""
    trace = pathlib.Path(trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    return json.loads(trace.read_text())["traceEvents"]


def part_times(part, state, oracle, generator, steps: int, captured: bool, name: str) -> dict:
    """Host ms and device ms per call of part(state, oracle, generator),
    `steps` calls on the same inputs after one warm-up, eagerly or as a
    captured program (`utils/aot.py`, named `name`, not stored) that hands
    its argument buffers back, so a replay copies nothing in. On the CPU
    device ms are not measured (None)."""

    def call(s, o, g):
        return s, o, part(s, o, g)

    on_card = state.start.device.type == "cuda"
    fn = (aot_or_compile(f"part-{name}", call, (state, oracle, generator), enabled=False)
          if captured else call)
    s, o, _ = fn(state, oracle, generator)  # warm-up (and the program's first copy)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        s, o, _ = fn(s, o, generator)
    sync()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    if not on_card:
        return {"host_ms": host_ms, "device_ms": None}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            s, o, _ = fn(s, o, generator)
        sync()
    with tempfile.TemporaryDirectory() as tmp:
        events = trace_events(prof, pathlib.Path(tmp) / "trace.json")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError(f"{name}: the trace holds no kernel events")
    return {"host_ms": host_ms, "device_ms": sum(e["dur"] for e in kernels) / 1e3 / steps,
            "kernels_per_call": len(kernels) / steps}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--warmup", type=int, default=20)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="the field's products in bf16 (compute_dtype='bfloat16')")
    parser.add_argument("--order", choices=("default", "jacobi", "merged"), default="default",
                        help="the step order: the default solver, or the experimental "
                        "jacobi_step / merged_step")
    parser.add_argument("--aot", action="store_true",
                        help="run the steps as replays of the captured programs")
    parser.add_argument("--trace", default="profiles/torch_step_trace.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(profile(args), indent=1))
    return 0


def profile(args) -> dict:
    """The profile of `args` (main's flags, any object with those attributes)
    on CUDA card 0, as one dict."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    oracle, start, goal, bounds = car_world(args.batch, device)
    cfg = run_planner_config()
    if args.bf16:
        cfg = cfg._replace(onf=cfg.onf._replace(compute_dtype="bfloat16"))
    if args.order == "default":
        solver = ConstrainedSolver(cfg, rectangle_collision, device=device)
    else:
        solver = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=device,
                                               **{f"{args.order}_step": True})
    if args.aot:
        solver = solver.with_aot("profile")
    g = torch.Generator(device=device).manual_seed(args.seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    # the warm-up captures; whole chunks of it leave the timed window on the
    # static schedule, any other count on the dynamic one
    state, _ = solver.run(state, oracle, args.warmup, g)
    torch.cuda.synchronize()
    port_kernels.reset_launches()
    t0 = time.perf_counter()
    state, _ = solver.run(state, oracle, args.steps, g)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3
    port_launches = {name: n / args.steps for name, n in port_kernels.LAUNCHES.items() if n}

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.clear_spans()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, _ = solver.run(state, oracle, args.steps, g)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / args.steps * 1e3
    replays = [s for s in profiling.spans() if s.name == "replay"]
    events = trace_events(prof, args.trace)
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
        "order": args.order,
        "captured": args.aot,
        **({"aot_events": solver.aot_events} if args.aot else {}),
        "batch": args.batch,
        "host_ms_per_step": host_ms,
        "profiled_ms_per_step": profiled_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_window_ms_per_step": window_us / 1e3 / args.steps,
        "idle_share_profiled_window": 1.0 - busy_us / window_us,
        "kernels_per_step": len(kernels) / args.steps,
        "port_kernel_launches_per_step": port_launches,
        "launch_calls_per_step": len(launches) / args.steps,
        "graph_replays_per_step": len(replays) / args.steps,
        "host_launch_ms_per_step": sum(e["dur"] for e in launches) / 1e3 / args.steps,
        "host_launch_ms_per_step_by_call": {
            name: sum(e["dur"] for e in launches if e["name"] == name) / 1e3 / args.steps
            for name in sorted({e["name"] for e in launches})},
        "top_kernels": [
            {"name": name[:80], "ms_per_step": us / 1e3 / args.steps,
             "launches_per_step": n / args.steps, "share_of_busy": us / busy_us}
            for name, (us, n) in top
        ],
    }
    return result


if __name__ == "__main__":
    sys.exit(main())
