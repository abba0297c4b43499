#!/usr/bin/env python3
"""Multi-process batched solving over torch.distributed, one process per card
(PyTorch port of scripts/run_multihost.py).

Launch one process per rank:

    python scripts/run_multihost_torch.py --coordinator <host0>:29500 \
        --num-processes 2 --process-id $RANK --batch-per-host 128
    torchrun --nproc-per-node 2 scripts/run_multihost_torch.py --batch-per-host 128

(torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT stand in for the
flags). Two ranks sharing one card: `--backend gloo --device cuda:0`, with a
file rendezvous `--init-file /tmp/rendezvous` (a path no run has used). On
the CPU: `--cpu` (gloo).

Every rank builds the same global batch of the car scene
(`run_planner_config()`, f32), keeps its rows through
`BatchPlanner(solver, problem_mesh())`, runs `--steps` steps, and reduces
the metrics over the mesh (`mean_over_problems`: a local sum and one
all_reduce). `--group-size G` solves with one shared field per G problems
(`run_grouped`); a G above the batch per rank spans ranks, whose mean field
gradient then takes one all_reduce per step. One process alone is the plain
batched path (no process group).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--coordinator", default=None, help="rank 0's address:port")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="ranks in all (default: WORLD_SIZE, else 1)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this rank (default: RANK, else 0)")
    parser.add_argument("--batch-per-host", type=int, default=256)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    parser.add_argument("--json-out", default=None, help="write this rank's result JSON")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="default: nccl where every rank has a card, else gloo")
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: cuda:<local rank>, or cpu)")
    parser.add_argument("--group-size", type=int, default=1,
                        help="problems sharing one field (run_grouped); 1: independent")
    parser.add_argument("--init-file", default=None,
                        help="a file:// rendezvous at this path instead of --coordinator")
    parser.add_argument("--seed", type=int, default=0, help="seed of the init and the noise")
    parser.add_argument("--timeout", type=float, default=120.0,
                        help="seconds before the rendezvous or a collective gives up")
    return parser.parse_args(argv)


def run(args) -> tuple[dict, dict]:
    """The solve of this rank: (the result JSON's fields, the context a
    caller can hold the kernels in: planner, this rank's states and oracle
    rows)."""
    import torch

    from nfopp_tpu_torch.parallel import (
        BatchPlanner, gather_batch, initialize_distributed, mean_over_problems, problem_mesh,
    )
    from nfopp_tpu_torch.parallel.mesh import COLLECTIVES, barrier, reset_collectives, shard_batch
    from nfopp_tpu_torch.solver import ConstrainedSolver, evaluate_path, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.utils.tree import tree_leaves
    from nfopp_tpu_torch.worlds import rectangle_collision

    backend = args.backend if args.backend is not None or not args.cpu else "gloo"
    init_method = (None if args.init_file is None
                   else pathlib.Path(args.init_file).resolve().as_uri())
    backend = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                     backend, init_method=init_method, timeout=args.timeout)
    device = args.device if args.device is not None else ("cpu" if args.cpu else None)
    mesh = problem_mesh(device=device)
    total_batch = args.batch_per_host * mesh.size
    print(f"[rank {mesh.rank}] ranks: {mesh.size}; device {mesh.device}; backend {backend}; "
          f"global batch {total_batch}", flush=True)

    oracle, starts, goals, bounds = car_world(total_batch, mesh.device)
    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=mesh.device)
    planner = BatchPlanner(solver, mesh)
    generator = torch.Generator(device=mesh.device).manual_seed(args.seed)
    grouped = args.group_size > 1
    if grouped:
        states = planner.init_batch_grouped(generator, starts, goals, bounds, oracle,
                                            args.group_size)
    else:
        states = planner.init_batch(generator, starts, goals, bounds, oracle)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    sync()
    barrier(mesh)  # the backend's first collective sets up its communicator: not timed
    reset_collectives()
    t0 = time.perf_counter()
    if grouped:
        states, aux = planner.run_grouped(states, oracle, args.steps, args.group_size, generator)
    else:
        states, aux = planner.run(states, oracle, args.steps, generator)
    sync()
    elapsed = time.perf_counter() - t0
    collectives = dict(COLLECTIVES)
    # cross-rank metric reductions: a local sum and one all_reduce each
    mean_loss = float(mean_over_problems(aux.trajectory_loss[:, -1], mesh))
    mean_final_xy = float(mean_over_problems(
        torch.linalg.norm(states.trajectory[:, -1, :2], dim=-1), mesh))
    collides, _ = evaluate_path(rectangle_collision, oracle, planner.paths(states))
    feasible = (~collides).cpu().numpy()
    replicas_equal = None
    if grouped:
        field = gather_batch((states.field_params, states.field_opt_state), mesh)
        replicas_equal = all(
            bool(torch.equal(g, g[:, :1].expand_as(g)))
            for leaf in tree_leaves(field)
            for g in [leaf.reshape((-1, args.group_size) + tuple(leaf.shape[1:]))])
    steps_per_s = args.steps / elapsed
    print(f"[rank {mesh.rank}] {args.steps} steps x {total_batch} problems in {elapsed:.2f}s "
          f"-> {total_batch * steps_per_s / 1000:.1f} solves/s over the mesh; mean loss "
          f"{mean_loss:.4f}; feasible {feasible.mean():.4f}; {collectives['count']} "
          f"collectives in the run", flush=True)
    result = {
        "process_id": mesh.rank,
        "num_processes": mesh.size,
        "global_devices": mesh.size,
        "local_devices": 1,
        "total_batch": total_batch,
        "steps": args.steps,
        "mean_loss": mean_loss,
        "mean_final_xy": mean_final_xy,
        "backend": backend,
        "device": str(mesh.device),
        "group_size": args.group_size,
        "seconds": elapsed,
        "s_per_1000_steps": elapsed / args.steps * 1000,
        "feasible_fraction": float(feasible.mean()),
        "feasible": [bool(f) for f in feasible],
        "collectives": collectives["count"],
        "collectives_per_step": collectives["count"] / args.steps,
        "collective_ms": (1e3 * collectives["seconds"] / collectives["count"]
                          if collectives["count"] else None),
        "replicas_equal": replicas_equal,
    }
    context = {"planner": planner, "states": states,
               "oracle": shard_batch(oracle, mesh, total_batch), "mesh": mesh}
    return result, context


def main(argv=None) -> int:
    args = parse_args(argv)
    result, _ = run(args)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(result))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
