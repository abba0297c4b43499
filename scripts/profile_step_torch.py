#!/usr/bin/env python3
"""Ablation profile of the port's solver step on one card (the counterpart of
scripts/profile_step.py).

Measures µs per step per problem for the full step and with pieces of it
switched off through the config (the field update never due, the
reparametrization never due, a replay buffer of 32, both off), to locate the
bottleneck without a trace: the car scene, run_planner_config in f32, B
problems initialised from --seed, `run` of --steps steps from the same state,
one warm-up call and then the minimum of 3 timed calls (host clock around the
call and a synchronize), as the JAX script does (`scripts/profile_step.py:
22-38`). With --aot each variant runs on a `with_aot` copy (the warm-up
captures its program): a variant whose reparametrization freq divides
--steps runs the static schedule, replaying one captured CUDA graph per 10
steps; the others (no reparametrization, trajectory update only) run the
dynamic schedule, replaying the captured one-step program, as the JAX
script's jitted `run` scans `step`. Each line names its schedule and
whether it ran captured. Prints one line per variant on stderr and one JSON
object on stdout.

    python3 scripts/profile_step_torch.py [--batch 256] [--steps 50] [--aot]
    python3 scripts/profile_step_torch.py --device cpu --batch 2 --steps 10

--device is cuda unless asked for the CPU, where nothing is captured.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# (label, run_planner_config fields replaced), in the JAX script's order
VARIANTS = (
    ("full step", {}),
    ("no field update", {"optimize_collision_model_freq": 1_000_000}),
    ("no reparametrization", {"reparametrize_trajectory_freq": 1_000_000}),
    ("buffer K=32 (topk+batch smaller)", {"collision_point_count": 32}),
    ("trajectory update only", {"optimize_collision_model_freq": 1_000_000,
                                "reparametrize_trajectory_freq": 1_000_000}),
)


def variant_configs() -> list:
    """[(label, SolverConfig)] of the five variants."""
    from nfopp_tpu_torch.solver import run_planner_config

    base = run_planner_config()
    return [(label, base._replace(**fields)) for label, fields in VARIANTS]


def measure(solver, state, oracle, steps: int, device, seed: int) -> tuple[float, float]:
    """(µs per step per problem as the minimum of 3 timed calls, seconds of
    the warm-up call) of `solver.run(state, oracle, steps)`."""
    import torch

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    g = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    solver.run(state, oracle, steps, g)
    sync()
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        solver.run(state, oracle, steps, g)
        sync()
        times.append(time.perf_counter() - t0)
    return min(times) / steps / state.start.shape[0] * 1e6, warmup_s


def profile_variants(device, batch: int, steps: int, aot: bool, seed: int = 0) -> dict:
    """{label: {us_per_step_per_problem, warmup_s, schedule, captured,
    programs}} of every variant (programs: what its with_aot copy resolved,
    with --aot)."""
    import torch

    from nfopp_tpu_torch.solver import ConstrainedSolver
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(batch, device)
    out = {}
    for label, config in variant_configs():
        solver = ConstrainedSolver(config, rectangle_collision, device=device)
        freq = config.reparametrize_trajectory_freq
        static = freq > 1 and steps % freq == 0
        if aot:
            solver = solver.with_aot("profile")
        state = solver.init_state(torch.Generator(device=device).manual_seed(seed),
                                  start, goal, bounds, oracle)
        us, warmup_s = measure(solver, state, oracle, steps, device, seed + 1)
        schedule = "static" if static else "dynamic"
        out[label] = {"us_per_step_per_problem": us, "warmup_s": warmup_s,
                      "schedule": schedule, "captured": aot and device.type == "cuda",
                      **({"programs": solver.aot_events} if aot else {})}
        how = f"{'captured' if out[label]['captured'] else 'eager'} ({schedule} schedule)"
        print(f"{label:35s} {us:8.2f} us/step/problem  (warm-up {warmup_s:.1f}s, {how})",
              file=sys.stderr, flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--aot", action="store_true",
                        help="run each variant as replays of its captured program (one per "
                             "chunk, or one per step for the dynamic schedule)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.tools.scene import card_line
    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "profile_step_torch")
    if enable_compile_cache(device):
        torch.backends.cuda.matmul.allow_tf32 = False
    variants = profile_variants(device, args.batch, args.steps, args.aot, args.seed)
    print(json.dumps({"metric": "step_ablation_us_per_step_per_problem", "batch": args.batch,
                      "steps": args.steps, "compute_dtype": "float32", "aot": args.aot,
                      "variants": variants,
                      "device": card_line() if device.type == "cuda" else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
