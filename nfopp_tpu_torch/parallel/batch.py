"""Batched planning front end: solve many NFOPP problems at once (port of
`nfopp_tpu/parallel/batch.py`).

JAX's `BatchPlanner` vmaps the solver over a problem batch and shards the
batch axis over a device mesh. The port's solvers already take a leading
problem axis, so `BatchPlanner` is a thin layer over them: it calls the
solver's `init_state`, `run`, `run_grouped` and the tracked loops of
`solver.tracking` on this rank's rows of the batch. The mesh
(`parallel/mesh.py`, default: every rank of the default process group, or
this process alone) has one process per card; a mesh of one process is the
single-card planner. Inputs are global on every rank (as in
`scripts/run_multihost.py`): every batched argument, oracles included, holds
all rows, and the planner keeps this rank's. States hold this rank's rows;
`run` and `run_grouped` return this rank's rows too; every `TrackingResult`
and `paths(...)` holds all rows, the same on every rank (`gather_batch`).

Where JAX takes a PRNG key, the port takes a `torch.Generator`, seeded alike
on every rank: `init_batch` draws every problem's init from it, and the
solves draw their noise from the generator they are given, each rank cutting
its rows from the block drawn for the global batch, so problem i's stream
depends on the global batch and not on how many ranks share it.
`aot_prefix` runs the solves and the inits' pretraining as replays of
captured programs (`solver.with_aot`, `utils/aot.py`), where JAX's loads
compiled executables from its AOT store (`init` among them,
`parallel/batch.py:184-187`).
"""
from __future__ import annotations

import pathlib
from typing import Any

import numpy as np
import torch

from ..solver.checkpoint import restore_state, save_state
from ..solver.tracking import (
    TrackingResult,
    run_grouped_with_tracking,
    run_tracking_segment,
    run_with_tracking,
    tracking_finalize,
    tracking_init,
)
from ..utils.device import check_device
from ..utils.tree import tree_map
from .mesh import RowLayout, all_over_problems, barrier, gather_batch, problem_mesh, shard_batch

__all__ = ["BatchPlanner"]


def _best_per_query(result: TrackingResult, k: int, restarts: int) -> TrackingResult:
    """Reduce a query-major [k * restarts] TrackingResult to the best restart
    per query: feasible first, then shortest (the first of equals)."""
    score = torch.where(result.feasible, result.length, torch.inf)
    best = (torch.argmin(score.reshape(k, restarts), dim=1)
            + torch.arange(k, device=score.device) * restarts)
    return tree_map(lambda x: x[best], result)


class BatchPlanner:
    """Batched front end over a `ConstrainedSolver` / `HolonomicSolver`, on
    this rank's rows of a batch sharded over `mesh`.

    All array arguments carry a leading batch axis of the global batch;
    oracle parameters are batched too (per-problem worlds, or a leading axis
    of 1 for one world). The global batch must divide over the mesh.
    `device=None` takes the solver's device; any other, and the mesh's, must
    be it. `aot_prefix` runs the solves and the inits' pretraining through
    captured programs.
    """

    def __init__(self, solver, mesh=None, device=None, aot_prefix: str | None = None):
        self.device = solver.device if device is None else check_device(device, "BatchPlanner")
        if self.device != solver.device:
            raise ValueError(f"BatchPlanner on {self.device} for a solver on {solver.device}")
        self.mesh = problem_mesh(device=self.device) if mesh is None else mesh
        if self.mesh.device != self.device:
            raise ValueError(f"a mesh on {self.mesh.device} for a solver on {self.device}")
        solver = solver.with_mesh(self.mesh)
        # aot_prefix routes every solve (run, run_grouped, the tracked loops)
        # and every init's pretraining through captured programs keyed by
        # prefix, solver config, group size, dtype and argument shapes;
        # aot_events lists each program resolved, {"program", "loaded",
        # "seconds"}, as JAX's
        self.solver = solver if aot_prefix is None else solver.with_aot(aot_prefix)
        self.aot_events: list[dict] = [] if aot_prefix is None else self.solver.aot_events

    @property
    def device_count(self) -> int:
        """Ranks of the mesh: batches are padded to a multiple of this."""
        return self.mesh.size

    def _put(self, x: Any) -> Any:
        """An array (tensor, numpy, list) or a tree of tensors (an oracle) on
        the planner's device."""
        if isinstance(x, (np.ndarray, list, tuple)) and not hasattr(x, "_fields"):
            x = torch.as_tensor(np.asarray(x))
        return tree_map(lambda t: t.to(self.device), x)

    def _local(self, x: Any, batch: int) -> Any:
        """This rank's rows of a global batched input (an array or an oracle
        tree) of `batch` problems, on the planner's device."""
        if isinstance(x, (np.ndarray, list, tuple)) and not hasattr(x, "_fields"):
            x = torch.as_tensor(np.asarray(x))
        return shard_batch(x, self.mesh, batch)

    def _oracle_rows(self, oracle_params: Any, states: Any) -> Any:
        """This rank's rows of a global oracle, for this rank's `states`."""
        return self._local(oracle_params, states.start.shape[0] * self.mesh.size)

    def _gather(self, tree: Any) -> Any:
        return gather_batch(tree, self.mesh)

    def init_batch(
        self,
        generator: torch.Generator,
        starts,
        goals,
        bounds,
        oracle_params: Any,
        trajectories=None,
    ) -> Any:
        """A batch of solver states; the field inits, replay buffers and
        pretraining draw from `generator`. `trajectories` [B, N, d]
        optionally overrides the straight-line initializer (e.g. batched
        wavefront paths). With `aot_prefix` the pretraining replays its
        captured program. Returns this rank's rows."""
        batch = len(starts)
        return self.solver.init_state(
            generator, self._local(starts, batch), self._local(goals, batch),
            self._local(bounds, batch), self._local(oracle_params, batch),
            trajectory=None if trajectories is None else self._local(trajectories, batch),
        )

    def init_batch_grouped(
        self,
        generator: torch.Generator,
        starts,
        goals,
        bounds,
        oracle_params: Any,
        group_size: int,
    ) -> Any:
        """A batch where each group of `group_size` consecutive problems
        shares one field init: the entry point for shared-field solving
        (`init_state(..., group_size=...)`). B must divide into groups and a
        group must share one map (checked on the global inputs); a group may
        span ranks (its pretraining needs no collective, so it captures with
        `aot_prefix` too). Returns this rank's rows."""
        from ..solver.constrained import _check_groups

        if not hasattr(self.solver, "run_grouped"):
            raise NotImplementedError("solver has no shared-field mode")
        batch = len(starts)
        _check_groups(RowLayout.alone(self.device), batch, group_size, self._put(bounds),
                      self._put(oracle_params))
        return self.solver.init_state(
            generator, self._local(starts, batch), self._local(goals, batch),
            self._local(bounds, batch), self._local(oracle_params, batch), group_size=group_size,
        )

    def run(self, states: Any, oracle_params: Any, num_steps: int, noise):
        """Advance every problem `num_steps` steps; returns this rank's
        (states, aux)."""
        return self.solver.run(states, self._oracle_rows(oracle_params, states), num_steps, noise)

    def run_grouped(self, states: Any, oracle_params: Any, num_steps: int, group_size: int,
                    noise):
        """Advance with one shared field per problem group (see
        ConstrainedSolver.run_grouped); a group may span ranks. Returns this
        rank's (states, aux)."""
        if not hasattr(self.solver, "run_grouped"):
            raise NotImplementedError("solver has no shared-field mode")
        return self.solver.run_grouped(states, self._oracle_rows(oracle_params, states),
                                       num_steps, group_size, noise)

    def solve(
        self,
        states: Any,
        oracle_params: Any,
        noise,
        max_iterations: int = 1000,
        min_iterations: int = 200,
        check_freq: int = 50,
        samples_per_segment: int = 5,
        stop_on_plateau: bool = True,
    ) -> TrackingResult:
        """Benchmark-mode solve with per-problem best-path tracking and early
        stop (scripts/run_bench_mr.py semantics, batched). stop_on_plateau=
        False spends the whole budget refining (see run_with_tracking)."""
        return self._gather(run_with_tracking(
            self.solver, states, self._oracle_rows(oracle_params, states), noise,
            max_iterations, min_iterations, check_freq, samples_per_segment, stop_on_plateau,
        ))

    def paths(self, states: Any) -> torch.Tensor:
        """[B, N+2, d] full trajectories of the global batch with pinned
        endpoints."""
        return self._gather(self.solver.full_trajectory(states))

    def _write_checkpoint(self, carry, path: pathlib.Path, generator) -> None:
        """Rank 0 writes the gathered carry and the generator's state (atomic
        rename); then every rank waits for the file."""
        full = self._gather(carry)
        if self.mesh.rank == 0:
            tmp = path.with_name("tmp-" + path.name)
            save_state(full, tmp, generator=generator)
            tmp.replace(path)
        barrier(self.mesh)

    def solve_checkpointed(
        self,
        states: Any,
        oracle_params: Any,
        generator: torch.Generator,
        checkpoint_path,
        max_iterations: int = 1000,
        min_iterations: int = 200,
        check_freq: int = 50,
        samples_per_segment: int = 5,
        stop_on_plateau: bool = True,
        checkpoint_every_chunks: int = 4,
        resume: bool = False,
    ) -> TrackingResult:
        """`solve` with mid-solve checkpoints, for recovery.

        The tracked solve runs as segments of `checkpoint_every_chunks`
        chunks; after each segment the TrackingCarry (solver states,
        best-path bookkeeping, chunk cursor) and the state of `generator`
        (which every step draws from) are written to `checkpoint_path`
        (atomic rename; on a mesh, rank 0 writes the gathered carry and every
        rank waits for it). With resume=True an existing checkpoint is
        loaded (each rank takes its rows), the generator set back, and the
        remaining segments run: a resumed solve is bit-identical to an
        uninterrupted one on the same mesh. Once every problem has stopped
        early (stop_on_plateau) the remaining segments are skipped. The file
        is NOT deleted on completion; callers own cleanup.
        """
        checkpoint_path = pathlib.Path(checkpoint_path)
        if checkpoint_path.suffix != ".npz":
            # np.savez appends .npz itself; keep names predictable
            checkpoint_path = checkpoint_path.with_suffix(checkpoint_path.suffix + ".npz")
        oracle_params = self._oracle_rows(oracle_params, states)
        num_chunks = -(-max_iterations // check_freq)
        carry = tracking_init(self.solver, states)
        start_chunk = 0
        if resume and checkpoint_path.exists():
            full = restore_state(self._gather(carry), checkpoint_path, generator=generator)
            start_chunk = int(full.chunk.max())
            carry = shard_batch(full, self.mesh)
        for end in range(start_chunk, num_chunks, checkpoint_every_chunks):
            # every problem stopped early: the remaining segments would be
            # no-ops, each with a checkpoint rewrite; skip them. Without
            # plateau-stop `done` never becomes True: don't pay the probe.
            if stop_on_plateau and all_over_problems(carry.done, self.mesh):
                break
            end_chunk = min(end + checkpoint_every_chunks, num_chunks)
            carry = run_tracking_segment(
                self.solver, carry, oracle_params, end_chunk, generator, min_iterations,
                check_freq, samples_per_segment, stop_on_plateau,
            )
            self._write_checkpoint(carry, checkpoint_path, generator)
        return self._gather(tracking_finalize(self.solver, carry, oracle_params,
                                              samples_per_segment, stop_on_plateau))

    def solve_grouped_tracked(
        self,
        states: Any,
        oracle_params: Any,
        group_size: int,
        noise,
        max_iterations: int = 1000,
        min_iterations: int = 200,
        check_freq: int = 50,
    ) -> TrackingResult:
        """Shared-field solve with best-path tracking: run_grouped has no
        per-problem early stop (the shared field keeps stepping for the whole
        group), so the full budget always runs; every check_freq steps past
        min_iterations each problem's path is evaluated and the shortest
        feasible one kept (`run_grouped_with_tracking`)."""
        if not hasattr(self.solver, "run_grouped"):
            raise NotImplementedError("solver has no shared-field mode")
        return self._gather(run_grouped_with_tracking(
            self.solver, states, self._oracle_rows(oracle_params, states), group_size, noise,
            max_iterations, min_iterations, check_freq, 5,
        ))

    def solve_multi_query(
        self,
        generator: torch.Generator,
        starts,
        goals,
        bounds,
        oracle_params: Any,
        restarts: int = 1,
        max_iterations: int = 1000,
        min_iterations: int = 200,
        check_freq: int = 50,
        shared_field: bool = True,
    ) -> TrackingResult:
        """Multi-query planning: K (start, goal) queries on ONE shared map
        (`starts`/`goals` [K, d]; `bounds` [4] and `oracle_params` with a
        leading axis of 1), solved at once as one batch; returns a
        TrackingResult batched over the K queries.

        shared_field=True trains ONE occupancy field for the whole batch
        (run_grouped, group = whole batch) and runs the full budget with
        best-path tracking (solve_grouped_tracked). restarts > 1 replicates
        each query (query-major layout) and returns the best feasible
        restart per query. The init and the solve draw from `generator`. The
        batch is padded to a multiple of the mesh size with more restarts of
        the last query (which join its shared field).
        """
        starts = self._put(starts).to(torch.float32)
        goals = self._put(goals).to(torch.float32)
        k = starts.shape[0]
        lanes = torch.arange(k, device=self.device).repeat_interleave(restarts)
        pad = (-len(lanes)) % self.mesh.size
        lanes = torch.cat([lanes, lanes[-1:].repeat(pad)])
        batch = len(lanes)
        starts_b, goals_b = starts[lanes], goals[lanes]
        bounds_b = self._put(bounds).to(torch.float32).reshape(1, -1).repeat(batch, 1)
        oracles = tree_map(lambda x: x.repeat((batch,) + (1,) * (x.ndim - 1)),
                           self._put(oracle_params))
        if shared_field:
            states = self.init_batch_grouped(generator, starts_b, goals_b, bounds_b, oracles,
                                             group_size=batch)
            result = self.solve_grouped_tracked(states, oracles, batch, generator,
                                                max_iterations, min_iterations, check_freq)
        else:
            states = self.init_batch(generator, starts_b, goals_b, bounds_b, oracles)
            result = self.solve(states, oracles, generator, max_iterations, min_iterations,
                                check_freq)
        result = tree_map(lambda x: x[:k * restarts], result)
        return _best_per_query(result, k, restarts)

    def solve_portfolio(
        self,
        generator: torch.Generator,
        start,
        goal,
        bounds,
        oracle_params: Any,
        restarts: int = 8,
        max_iterations: int = 1000,
        min_iterations: int = 200,
        check_freq: int = 50,
        shared_field: bool = False,
    ) -> TrackingResult:
        """Portfolio solving: one problem, `restarts` random restarts in one
        batch; returns the best feasible result (unbatched, as JAX's).

        shared_field=True trains ONE occupancy field from all restarts'
        samples (run_grouped), with the full budget and tracked paths.
        """
        result = self.solve_multi_query(
            generator,
            self._put(start).to(torch.float32)[None],
            self._put(goal).to(torch.float32)[None],
            bounds,
            oracle_params,
            restarts=restarts,
            max_iterations=max_iterations,
            min_iterations=min_iterations,
            check_freq=check_freq,
            shared_field=shared_field,
        )
        return tree_map(lambda x: x[0], result)
