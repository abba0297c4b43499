#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 nfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(nfbench/configs/<config>.json) and its traffic (nfbench/traffic/<mix>.json),
whose "driver" names the general generator that serves it
(nfbench/drivers/<driver>.py); its limits are nfbench/limits/<cell>.json and
each per-layer metric is read by nfbench/layer_metrics/<metric>.py. The run
loads and warms up (set-up), measures for --seconds, checks what the timed
path produced against the plain reference (nfbench/reference/), and prints
one JSON object as the last line of standard output; the numbers compared
and their limits are also the last lines of standard error. With --trace 1
a slice of the window runs under the profiler and the line holds the
per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402

# one host thread for the process's math libraries: the card does the
# work, and threads that spin against each other widen the runs' spread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from nfbench.harness import core  # noqa: E402


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, started: float | None = None
             ) -> tuple[dict, list]:
    """Set-up, window, metrics and check of one run on `device`; returns the
    result line's object and the checks [(name, value, limit)]. `overrides`
    shrink the traffic (the CPU tests' runs)."""
    import torch

    started = time.perf_counter() if started is None else started
    spans = core.Spans()
    driver = core.driver_module(cell.traffic["driver"]).Driver(
        cell, seed, device, spans, overrides or {})
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    tracer = core.Tracer(trace, spans, device)
    tracer.warm()
    setup_s = time.perf_counter() - started
    log(f"set-up {setup_s:.3f} s")
    driver.window(seconds, tracer)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    found = core.forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark runs the port alone")
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        if on_card and tracer.trace is None:
            raise RuntimeError("the window ended before its traced slice")
        ctx = types.SimpleNamespace(trace=tracer.trace, spans=spans, cell=cell,
                                    counters=driver.counters(), device=device,
                                    card=torch.cuda.get_device_name(device) if on_card else "")
        for metric in cell.per_layer:
            value = core.metric_reader(metric["name"]).read(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": units[metric["name"]]}
    else:
        values = {**driver.end_to_end(), "setup_s": setup_s}
        for metric in cell.end_to_end:
            metrics[metric["name"]] = {"value": values[metric["name"]],
                                       "unit": units[metric["name"]]}
    attempted, failed = driver.attempted_failed()
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace and tracer.trace is not None:
        device_info["busy_s"] = tracer.trace.busy_s
        device_info["window_s"] = tracer.trace.window_s
        result["breakdown"] = {"device_ops": tracer.trace.top_kernels(),
                               "idle_gaps": tracer.trace.idle_gaps()}
    t0 = time.perf_counter()
    checks = driver.judge()
    log(f"check {time.perf_counter() - t0:.3f} s")
    result["correct"] = all(value <= limit for _, value, limit in checks)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    core.cache_dirs()
    cell = core.Cell.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cell.config.get("tf32", False))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                              started=PROCESS_START)
    for name, value, limit in checks:
        log(f"{name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
