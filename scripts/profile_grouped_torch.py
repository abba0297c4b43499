#!/usr/bin/env python3
"""Structural profile of the grouped (shared-field) step at fleet scale (the
counterpart of scripts/profile_grouped.py).

At each fleet size G (batch == G, one shared-field group; car scene,
run_planner_config, f32) every component of the grouped step is timed on
its own beside the same component of the independent (per-robot field)
step, so the table shows what sharing a field costs or saves: the full step
without reparametrization, grouped and independent; the field update,
grouped and independent; the field gradients alone, without and with the
group mean; the trajectory update; the reparametrization. Each runs --steps
calls on the same state, eagerly and, with --aot, also as a captured
program (`utils/aot.py`), through `tools/profile_step.py::part_times`: host
ms and device ms per call, and host µs per step per robot. Prints one JSON
object.

    python3 scripts/profile_grouped_torch.py --sizes 64,128 [--aot]
    python3 scripts/profile_grouped_torch.py --device cpu --sizes 4 --steps 2

--device is cuda unless asked for the CPU (device ms not measured there).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def components(solver, g: int) -> dict:
    """{name: part(state, oracle, generator)} of the grouped step and its
    independent counterparts at group size `g`."""
    from nfopp_tpu_torch.ops.sampling import GeneratorNoise
    from nfopp_tpu_torch.utils.tree import tree_leaves

    def grads_only(group):
        def part(s, o, gen):
            _, losses, grads = solver._field_grads(s, o, GeneratorNoise(gen), group)
            return losses, tree_leaves(grads)
        return part

    return {
        "grouped full step (no reparam)":
            lambda s, o, gen: solver.step_static(s, o, gen, False, True, g),
        "independent full step (no reparam)":
            lambda s, o, gen: solver.step_static(s, o, gen, False, True, 1),
        "field update, grouped": lambda s, o, gen: solver._field_step(s, o, GeneratorNoise(gen), g),
        "field update, independent":
            lambda s, o, gen: solver._field_step(s, o, GeneratorNoise(gen), 1),
        "field grads only (sample+fwd+bwd)": grads_only(1),
        "field grads + group mean": grads_only(g),
        "trajectory update only": lambda s, o, gen: solver._trajectory_step(s, GeneratorNoise(gen)),
        "reparametrization only": lambda s, o, gen: solver._reparametrize(s),
    }


def profile_grouped(device, sizes: list, steps: int, aot: bool, seed: int = 0) -> list:
    import torch

    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.profile_step import part_times
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=device)
    modes = ("eager", "captured") if aot else ("eager",)
    rows = []
    for g in sizes:
        oracle, starts, goals, bounds = car_world(g, device)
        generator = torch.Generator(device=device).manual_seed(seed)
        states = solver.init_state(generator, starts, goals, bounds, oracle, group_size=g)
        row = {"robots": g, "components": {}}
        for name, part in components(solver, g).items():
            row["components"][name] = {}
            for mode in modes:
                t = part_times(part, states, oracle, generator, steps, mode == "captured", name)
                t["host_us_per_step_per_robot"] = t["host_ms"] / g * 1e3
                row["components"][name][mode] = t
        rows.append(row)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default="64,128",
                        help="comma list of fleet sizes G (batch == G, one shared-field group)")
    parser.add_argument("--steps", type=int, default=20, help="calls per component and mode")
    parser.add_argument("--aot", action="store_true", help="also time each part captured")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.tools.scene import card_line
    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "profile_grouped_torch")
    if enable_compile_cache(device):
        torch.backends.cuda.matmul.allow_tf32 = False
    report = {"metric": "grouped_step_profile", "steps": args.steps, "captured": args.aot,
              "sizes": profile_grouped(device, [int(x) for x in args.sizes.split(",")],
                                       args.steps, args.aot),
              "device": card_line() if device.type == "cuda" else "cpu"}
    out = json.dumps(report)
    print(out)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
