"""Fleet replanning: batched anytime planning for N robots on ONE shared map
(port of `nfopp_tpu/service/fleet.py`).

The reference's ROS node serves one robot with one persistent planner
(ros/goal_planner_adapter.py); this service is its batched analog — the whole
fleet is one problem batch stepped together inside the time budget, and
(optionally) every robot's samples train ONE occupancy field per group
(`shared_field=True`, run_grouped): the map model is common, the queries are
not. Goal changes use `ConstrainedSolver.retarget`, which rebuilds the
query-specific state while keeping the learned field, so a new goal never
pays for relearning the world and never breaks the shared-field lockstep.

The port serves the fleet through `BatchPlanner` on a problem mesh of
processes, one per card (`mesh=`; by default the most ranks of the default
process group that divide the fleet, as JAX takes the most devices), or on
one device alone. Every rank receives the same calls; each steps its rows of
the fleet, rank 0's clock decides whether another chunk runs, and every rank
returns every robot's path. The batch init and every cycle's noise come from
one `torch.Generator` seeded with `seed` (JAX: a PRNG key) on every rank.

Middleware-neutral like `ReplanningService`: a ROS/gRPC node is a thin
adapter calling update_robot_pose / set_goal / replan_cycle.
"""
from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..ops.sampling import GeneratorNoise
from ..parallel.batch import BatchPlanner
from ..parallel.mesh import batch_sharding, problem_mesh, rank_zero_decides
from ..utils.tree import tree_map, tree_rows, tree_where
from .postprocessor import PathPostprocessor

__all__ = ["FleetReplanningService"]


def _tile(x: torch.Tensor, rows: int) -> torch.Tensor:
    """One world's oracle leaf (leading axis 1) as `rows` identical rows."""
    return x.repeat((rows,) + (1,) * (x.ndim - 1))


def _fleet_mesh(n_robots: int, device):
    """The mesh over the most ranks of the default process group that divide
    the fleet (`fleet.py:80-87`); a rank left out of it raises."""
    mesh = problem_mesh(device=device)
    if not mesh.distributed:
        return mesh
    n = mesh.size
    while n_robots % n != 0:
        n -= 1
    if n == mesh.size:
        return mesh
    group = dist.new_group(list(range(n)))  # every rank of the default group takes part
    if mesh.rank >= n:
        raise ValueError(f"rank {mesh.rank} is outside the fleet's mesh of {n} ranks "
                         f"({n_robots} robots)")
    return problem_mesh(device=device, group=group)


class FleetReplanningService:
    def __init__(
        self,
        solver,
        n_robots: int,
        bounds: np.ndarray,
        oracle_params: Any,
        device=None,
        planning_timeout: float = 0.1,
        steps_per_chunk: int | None = None,
        shared_field: bool = True,
        group_size: int | None = None,
        postprocessor: PathPostprocessor | None = None,
        seed: int = 0,
        mesh=None,
    ):
        """`oracle_params`: the port's oracle of one world (leading axis 1).
        `device` defaults to the solver's (which is CUDA unless the solver
        was made for the CPU). group_size (shared-field mode only) sets the
        field-sharing granularity: one occupancy field per `group_size`
        consecutive robots (default: the whole fleet, which then spans every
        rank); a robot's retarget stays within its group's lockstep either
        way. `mesh` shards the fleet (default: see the module)."""
        self.solver = solver
        self.n_robots = n_robots
        self.planning_timeout = planning_timeout
        if group_size is None:
            group_size = n_robots
        if shared_field and n_robots % group_size != 0:
            raise ValueError(
                f"n_robots {n_robots} not divisible by group_size {group_size}"
            )
        self.group_size = group_size
        freq = solver.config.reparametrize_trajectory_freq
        # grouped stepping needs whole reparametrization chunks
        self.steps_per_chunk = steps_per_chunk if steps_per_chunk is not None else freq
        if shared_field and self.steps_per_chunk % freq != 0:
            raise ValueError(
                f"steps_per_chunk ({self.steps_per_chunk}) must be a multiple "
                f"of reparametrize_trajectory_freq ({freq}) in shared-field mode"
            )
        self.shared_field = shared_field
        self.postprocessor = postprocessor
        self._mutex = threading.Lock()
        device = solver.device if device is None else device
        mesh = _fleet_mesh(n_robots, device) if mesh is None else mesh
        self._planner = BatchPlanner(solver, mesh, device=device)
        self.device = self._planner.device
        self.mesh = self._planner.mesh
        self._rows = batch_sharding(self.mesh, n_robots)  # this rank's robots
        self._bounds = torch.tensor(np.asarray(bounds, np.float32), device=self.device)
        self._active = np.zeros(n_robots, dtype=bool)
        self._poses = np.zeros((n_robots, 3), np.float32)
        self._has_pose = np.zeros(n_robots, dtype=bool)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._noise = GeneratorNoise(self._generator)
        self._states = None
        self._oracles = None
        self.update_world(oracle_params)

    # ------------------------------------------------------------- inputs

    def update_world(self, oracle_params: Any, group: int | None = None) -> None:
        """New map/sensor oracle (one world, leading axis 1) for the whole
        fleet, or — with `group` — for one field group's robots only
        (multi-tenant serving: one card serves sub-fleets on DIFFERENT maps,
        one shared field per map; `init_batch_grouped` checks world
        uniformity per group, not globally). Call before the first set_goal
        when maps differ, so field pretraining sees each group's own map."""
        with self._mutex:
            oracle_params = tree_map(lambda x: x.to(self.device), oracle_params)
            if group is None:
                self._oracles = tree_map(lambda x: _tile(x, self.n_robots), oracle_params)
                return
            if self._oracles is None:
                raise ValueError(
                    "set the fleet-wide world before per-group updates "
                    "(update_world(params) defines the oracle structure)"
                )
            lo = group * self.group_size
            hi = lo + self.group_size
            if not 0 <= lo < hi <= self.n_robots:
                raise ValueError(f"group {group} out of range")
            self._oracles = tree_map(
                lambda full, x: torch.cat([full[:lo], _tile(x, self.group_size), full[hi:]]),
                self._oracles, oracle_params,
            )

    def update_robot_pose(self, robot: int, pose: np.ndarray) -> None:
        with self._mutex:
            self._poses[robot] = np.asarray(pose, np.float32)
            self._has_pose[robot] = True

    def set_goal(self, robot: int, goal: np.ndarray) -> bool:
        """(Re)target one robot. The first call initializes the whole batch
        (all lanes share the same field pretraining schedule); later calls
        retarget only that robot's lane, keeping all field state."""
        with self._mutex:
            if not self._has_pose[robot]:
                return False
            if self._states is None:
                self._init_states()
            self._states = self._retarget_lane(robot, self._poses[robot],
                                               np.asarray(goal, np.float32))
            self._active[robot] = True
            return True

    def stop(self, robot: int) -> None:
        with self._mutex:
            self._active[robot] = False

    def _retarget_lane(self, robot: int, start: np.ndarray, goal: np.ndarray) -> Any:
        """Retarget the robot's lane, on the rank that holds it, and write
        every leaf of that lane back (the field leaves come back unchanged,
        so a group's replicas stay bit-identical)."""
        if not self._rows.start <= robot < self._rows.stop:
            return self._states
        i = robot - self._rows.start
        lane = self.solver.retarget(tree_rows(self._states, i, i + 1),
                                    start[None], goal[None])
        return tree_map(lambda full, one: torch.cat([full[:i], one, full[i + 1:]]),
                        self._states, lane)

    def _init_states(self) -> None:
        """First-goal batch init: every lane starts at its pose (goal=pose,
        a trivial query) so inactive lanes optimize no-ops while active
        lanes get retargeted."""
        poses = self._poses.copy()
        bounds = self._bounds[None].repeat(self.n_robots, 1)
        if self.shared_field:
            self._states = self._planner.init_batch_grouped(
                self._generator, poses, poses, bounds, self._oracles,
                group_size=self.group_size,
            )
        else:
            self._states = self._planner.init_batch(
                self._generator, poses, poses, bounds, self._oracles
            )

    # -------------------------------------------------------------- cycle

    def replan_cycle(self) -> dict[int, np.ndarray]:
        """One fleet cycle: track every robot's pose, optimize the whole
        batch within the time budget (at least one chunk; on a mesh rank 0's
        clock decides), return {robot: path} for active robots."""
        with self._mutex:
            if self._states is None or not self._active.any():
                return {}
            rows = self._rows
            mask = torch.tensor((self._active & self._has_pose)[rows], device=self.device)
            poses = torch.tensor(self._poses[rows], device=self.device)
            self._states = tree_where(mask, self.solver.update_start(self._states, poses),
                                      self._states)
            deadline = time.perf_counter() + self.planning_timeout
            while True:
                if self.shared_field:
                    self._states, aux = self._planner.run_grouped(
                        self._states, self._oracles, self.steps_per_chunk,
                        self.group_size, self._noise,
                    )
                else:
                    self._states, aux = self._planner.run(
                        self._states, self._oracles, self.steps_per_chunk, self._noise
                    )
                # wait for the chunk before re-checking the clock (CUDA
                # launches are asynchronous)
                float(torch.sum(aux.trajectory_loss[:, -1]))
                if rank_zero_decides(time.perf_counter() >= deadline, self.mesh):
                    break
            paths = self._planner.paths(self._states).cpu().numpy()
            active = [int(i) for i in np.nonzero(self._active)[0]]
        out = {}
        for i in active:
            path = paths[i]
            if self.postprocessor is not None:
                path = self.postprocessor.process(path)
            out[i] = path
        return out
