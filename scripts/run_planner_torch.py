#!/usr/bin/env python3
"""Standalone demo on one card (the counterpart of scripts/run_planner.py,
the reference's scripts/run_planner.py).

Car/parking scene, rectangle footprint, SE(2) constrained planner
(`run_planner_config`, f32), one problem, 1000 iterations through the port's
ConstrainedSolver: on CUDA every step runs the ONF logits, field-gradient
and collision kernels once. Optionally renders the field heatmap + trajectory
to PNG frames (where matplotlib imports).

    python3 scripts/run_planner_torch.py [--show-every 100] [--out frames]
    python3 scripts/run_planner_torch.py --iterations 20 --device cpu

Prints the field and trajectory losses after every chunk, then the elapsed
time and the final path's length and feasibility; exits 1 if the path
collides. --device is cuda unless asked for the CPU.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build(seed: int, device):
    """(solver, state, oracle, generator) of one car-scene problem on
    `device`, the state initialised from a generator seeded with `seed`."""
    import torch

    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(1, device)
    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(generator, start, goal, bounds, oracle)
    return solver, state, oracle, generator


def render(solver, state, path: pathlib.Path) -> None:
    """One PNG frame: the field's occupancy heatmap, the obstacles and the
    trajectory (plotting.plot_planner_data)."""
    import torch
    from matplotlib import pyplot as plt

    from nfopp_tpu_torch.models import onf_apply
    from nfopp_tpu_torch.plotting import plot_planner_data
    from nfopp_tpu_torch.worlds import car_environment

    env = car_environment()

    def field_fn(queries):
        x = torch.tensor(queries, device=solver.device)[None]
        with torch.no_grad():
            return onf_apply(state.field_params, x, solver.config.onf)[0, :, 0].cpu().numpy()

    fig = plt.figure(dpi=150)
    trajectory = solver.full_trajectory(state)[0].cpu().numpy()
    plot_planner_data(trajectory, field_fn, env.bounds, env.obstacle_points)
    fig.savefig(path)
    plt.close(fig)


def run(solver, state, oracle, generator, iterations: int, show_every: int = 0,
        out_dir: pathlib.Path | None = None, log=print):
    """(state, [(iterations done, field loss, trajectory loss)], seconds):
    `iterations` steps in chunks of `show_every` (all at once when 0), a
    frame after each chunk when show_every > 0, the losses logged."""
    import torch

    chunk = show_every if show_every > 0 else iterations
    if show_every:
        out_dir.mkdir(parents=True, exist_ok=True)
    losses = []
    t0 = time.perf_counter()
    done = 0
    frame = 0
    while done < iterations:
        state, aux = solver.run(state, oracle, chunk, generator)
        done += chunk
        if show_every:
            render(solver, state, out_dir / f"frame_{frame:04d}.png")
            frame += 1
        field_loss = float(aux.field_loss[0, -1])
        traj_loss = float(aux.trajectory_loss[0, -1])
        losses.append((done, field_loss, traj_loss))
        log(f"iter {done}: field_loss={field_loss:.4f} traj_loss={traj_loss:.4f}")
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    return state, losses, time.perf_counter() - t0


def final_path(solver, state, oracle):
    """(path [N+2, 3] numpy, collides, xy length) of the solved problem
    (evaluate_path: 5 samples per segment)."""
    from nfopp_tpu_torch.solver import evaluate_path
    from nfopp_tpu_torch.worlds import rectangle_collision

    path = solver.full_trajectory(state)
    collides, length = evaluate_path(rectangle_collision, oracle, path)
    return path[0].cpu().numpy(), bool(collides[0]), float(length[0])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--show-every", type=int, default=0,
                        help="render a PNG frame every K iterations (0 = off)")
    parser.add_argument("--out", default="nfopp_frames")
    parser.add_argument("--device", default="cuda",
                        help="device of the solve (cuda, or cpu for the plain "
                        "PyTorch path)")
    args = parser.parse_args()

    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "run_planner_torch.py")
    solver, state, oracle, generator = build(args.seed, device)
    state, _, elapsed = run(solver, state, oracle, generator, args.iterations,
                            args.show_every, pathlib.Path(args.out))
    path, collides, length = final_path(solver, state, oracle)
    if not np.isfinite(path).all():
        raise SystemExit("run_planner_torch.py: the final path is not finite")
    print(f"done in {elapsed:.2f}s  ({elapsed / args.iterations * 1e3:.3f} ms/iter)")
    print(f"final path: length={length:.3f} collision_free={not collides}")
    return 0 if not collides else 1


if __name__ == "__main__":
    raise SystemExit(main())
