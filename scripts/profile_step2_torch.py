#!/usr/bin/env python3
"""Structural profile of the port's step: each part timed on its own (the
counterpart of scripts/profile_step2.py).

On the car scene with run_planner_config (f32, or --bf16), B problems
initialised from --seed, each part of `ConstrainedSolver`'s step runs
--steps times on the same state, eagerly and as a captured program
(`utils/aot.py`, one CUDA graph per call):

- field sampling: segment jitter, candidate scoring (the ONF logits kernel),
  Gumbel top-k resample of the replay buffer;
- oracle labels of one fixed training batch;
- field loss and gradient on that batch (the field-gradient kernel);
- field Adam on one fixed gradient;
- trajectory update: loss and gradient through the collision kernels,
  H^-1 preconditioning, Adam and dual ascent;
- reparametrization;
- the full step without reparametrization, for calibration.

For each part and mode it reports host ms per call (host clock around the
calls and a synchronize) and device ms per call (the kernels' time in a
torch.profiler trace of as many calls). Prints one JSON object.

    python3 scripts/profile_step2_torch.py [--batch 256] [--steps 20] [--bf16]
    python3 scripts/profile_step2_torch.py --device cpu --batch 4 --steps 2

--device is cuda unless asked for the CPU, where nothing is captured and
device ms are not measured (null).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def parts(solver, state, oracle, generator) -> dict:
    """{name: part(state, oracle, generator)} of the step's parts; the fixed
    training batch, labels and gradient are drawn once from `generator`."""
    from nfopp_tpu_torch.ops.sampling import GeneratorNoise
    from nfopp_tpu_torch.solver.field import field_loss_and_grad, sample_field_points

    cfg = solver.config

    def sample(s, o, g):
        return sample_field_points(cfg, GeneratorNoise(g), s.prev_trajectory, s.buffer_points,
                                   s.buffer_ages, s.field_params, s.bounds)

    points = sample(state, oracle, generator).train_points
    truth = solver.oracle_fn(oracle, points)
    _, grads = field_loss_and_grad(cfg, state.field_params, points, truth)
    return {
        "field sampling": sample,
        "oracle labels": lambda s, o, g: solver.oracle_fn(o, points),
        "field loss and gradient": lambda s, o, g: field_loss_and_grad(cfg, s.field_params,
                                                                       points, truth),
        "field Adam": lambda s, o, g: solver._field_adam(grads, s.field_opt_state,
                                                         s.field_params),
        "trajectory update": lambda s, o, g: solver._trajectory_step(s, GeneratorNoise(g)),
        "reparametrization": lambda s, o, g: solver._reparametrize(s),
        "full step (no reparametrization)": lambda s, o, g: solver.step_static(s, o, g, False),
    }


def profile_parts(device, batch: int = 256, steps: int = 20, seed: int = 0,
                  bf16: bool = False) -> dict:
    """Every part's eager and captured numbers on the car scene (see the
    module docstring)."""
    import torch

    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.profile_step import part_times
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    cfg = run_planner_config()
    if bf16:
        cfg = cfg._replace(onf=cfg.onf._replace(compute_dtype="bfloat16"))
    oracle, start, goal, bounds = car_world(batch, device)
    solver = ConstrainedSolver(cfg, rectangle_collision, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(generator, start, goal, bounds, oracle)
    state, _ = solver.run(state, oracle, 10, generator)  # a state inside a solve
    result = {}
    for name, part in parts(solver, state, oracle, generator).items():
        result[name] = {
            mode: part_times(part, state, oracle, generator, steps, mode == "captured", name)
            for mode in ("eager", "captured")}
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=20, help="calls per part and mode")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="the field's products in bf16 (compute_dtype='bfloat16')")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.tools.scene import card_line
    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "profile_step2_torch")
    if enable_compile_cache(device):
        torch.backends.cuda.matmul.allow_tf32 = False
    result = {
        "metric": "step_parts_ms", "batch": args.batch, "steps": args.steps,
        "compute_dtype": "bfloat16" if args.bf16 else "float32",
        "parts": profile_parts(device, args.batch, args.steps, args.seed, args.bf16),
        "device": card_line() if device.type == "cuda" else "cpu",
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
