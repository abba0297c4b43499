#!/usr/bin/env python3
"""Sustained anytime-serving throughput of the PyTorch/CUDA port: a refilling
batch server on one card (the counterpart of scripts/anytime_server.py).

One batch under the reference's early-stop semantics finishes when its
slowest lane stops; a server refills finished lanes with new problems, so
its sustained rate follows the mean lane instead. This measures that: B
lanes run 50-step chunks of `ConstrainedSolver.run` (car scene,
run_planner_config in bf16); after each chunk every lane is checked under
the reference stop rule (feasible and non-improving past min_iterations,
run_bench_mr.py:111-127); completed lanes are counted and replaced at once
by fresh pre-initialized states from a pool on the card (`index_select` +
`tree_where`, no host round trip). Sustained solves/s = completions / loop
wall (CUDA events after a synchronize).

    python3 scripts/anytime_server_torch.py [--batch 256 --pool-rounds 4 --chunks 40]
    python3 scripts/anytime_server_torch.py --device cpu --batch 4 --chunks 2
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


class Server:
    """The refilling batch server: B lanes, a pool of B * pool_rounds fresh
    states, and the per-lane tracking of the stop rule, all on the solver's
    device."""

    def __init__(self, batch: int, pool_rounds: int, seed: int, device, check_freq: int = 50,
                 min_iterations: int = 200):
        import torch

        from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
        from nfopp_tpu_torch.tools.scene import car_world
        from nfopp_tpu_torch.utils.tree import tree_rows
        from nfopp_tpu_torch.worlds import rectangle_collision

        config = run_planner_config()
        self.solver = ConstrainedSolver(
            config._replace(onf=config.onf._replace(compute_dtype="bfloat16")),
            rectangle_collision, device=device)
        self.batch, self.check_freq, self.min_iterations = batch, check_freq, min_iterations
        self.oracle, start, goal, bounds = car_world(batch * (1 + pool_rounds), device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        everything = self.solver.init_state(self.generator, start, goal, bounds, self.oracle)
        self.states = tree_rows(everything, 0, batch)
        self.pool = tree_rows(everything, batch, None)
        self.pool_size = batch * pool_rounds
        device = self.solver.device
        self.best = torch.full((batch,), torch.inf, device=device)
        self.iterations = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.cursor = torch.zeros((), dtype=torch.int64, device=device)
        self.completed = torch.zeros((), dtype=torch.int64, device=device)
        self.length_sum = torch.zeros((), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0

    def chunk(self) -> None:
        """One check_freq-step chunk, the stop rule, and the refill."""
        import torch

        from nfopp_tpu_torch.solver import evaluate_path
        from nfopp_tpu_torch.utils.tree import tree_map, tree_where

        solver = self.solver
        self.states, _ = solver.run(self.states, self.oracle, self.check_freq, self.generator)
        collides, length = evaluate_path(solver.oracle_fn, self.oracle,
                                         solver.full_trajectory(self.states))
        self.iterations = self.iterations + self.check_freq
        feasible = ~collides
        improving = feasible & (length < self.best)
        self.best = torch.where(improving, length, self.best)
        # run_bench_mr.py:119-127: past min_iterations a feasible,
        # non-improving check ends the solve (the best path is returned)
        done = (self.iterations > self.min_iterations) & feasible & ~improving
        # refill: lane j (done) takes pool[cursor + rank(j)]; when the pool
        # runs dry the lane keeps optimizing and is not counted
        rank = torch.cumsum(done.long(), dim=0) - 1
        src = self.cursor + torch.where(done, rank, torch.zeros_like(rank))
        in_pool = done & (src < self.pool_size)
        src = torch.clamp(src, max=self.pool_size - 1)
        fresh = tree_map(lambda p: torch.index_select(p, 0, src), self.pool)
        self.states = tree_where(in_pool, fresh, self.states)
        self.completed = self.completed + in_pool.sum()
        self.length_sum = self.length_sum + torch.where(in_pool, self.best, 0.0).sum()
        self.best = torch.where(in_pool, torch.inf, self.best)
        self.iterations = torch.where(in_pool, 0, self.iterations)
        self.cursor = self.cursor + in_pool.sum()

    def result(self, seconds: float, chunks: int) -> dict:
        completed = int(self.completed)
        out = {
            "metric": "anytime_sustained_solves_per_s",
            "value": completed / seconds,
            "unit": "solves/s",
            "completed_solves": completed,
            "elapsed_s": seconds,
            "batch": self.batch,
            "chunks": chunks,
            "server_iterations": chunks * self.check_freq,
            "mean_length_completed": float(self.length_sum) / max(completed, 1),
            "pool_init_s": self.init_s,
            "pool_exhausted": bool(int(self.cursor) >= self.pool_size),
            "compute_dtype": "bfloat16",
            "semantics": "reference early-stop per lane (feasible & non-improving check past "
                         f"{self.min_iterations} iterations, run_bench_mr.py:111-127); "
                         "completed lanes refilled at once from a pool of fresh problems on "
                         "the device",
        }
        if out["pool_exhausted"]:
            out["warning"] = ("refill pool ran dry before the last chunk - sustained rate "
                              "understated; raise --pool-rounds")
        return out


def serve(server: Server, chunks: int) -> dict:
    """`chunks` timed chunks of the server; returns its result."""
    from nfopp_tpu_torch.tools.scene import timed

    seconds, _ = timed(lambda: [server.chunk() for _ in range(chunks)], server.solver.device)
    return server.result(seconds, chunks)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--pool-rounds", type=int, default=4,
                        help="pool size = batch * pool-rounds fresh states")
    parser.add_argument("--chunks", type=int, default=40,
                        help="timed 50-step chunks (40 = 2000 iterations of server time)")
    parser.add_argument("--check-freq", type=int, default=50)
    parser.add_argument("--min-iterations", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "anytime_server_torch")
    enable_compile_cache(device)  # the kernel library, before any timing
    if device.type == "cuda":
        from nfopp_tpu_torch.kernels import build

        build.load_library()  # the kernels' build stays out of the timed loop
    server = Server(args.batch, args.pool_rounds, args.seed, device, args.check_freq,
                    args.min_iterations)
    print(f"pool init: {server.init_s:.1f}s for {args.batch * (1 + args.pool_rounds)} states",
          file=sys.stderr, flush=True)
    result = serve(server, args.chunks)
    result["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(result))
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
