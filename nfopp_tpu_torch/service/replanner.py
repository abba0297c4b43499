"""Anytime replanning service — the ROS navigation-node capability as a pure
API, no middleware (port of `nfopp_tpu/service/replanner.py`).

Replaces the reference's `ros/goal_planner_adapter.py` wiring: a persistent
planner whose field keeps learning across replans, a robot pose that tracks the
start point, time-budgeted stepping per cycle (the reference runs `step()` in a
0.1 s loop at 10 Hz, goal_planner_adapter.py:44-63), postprocessing, and a
callback for publishing paths. Any middleware (ROS node, gRPC server, ...)
becomes a thin adapter over this class. The planner is the port's
`NFOPPlanner`, on its solver's device.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

import numpy as np

from ..solver.api import NFOPPlanner
from .postprocessor import PathPostprocessor

__all__ = ["ReplanningService"]


class ReplanningService:
    def __init__(
        self,
        planner: NFOPPlanner,
        planning_timeout: float = 0.1,
        steps_per_chunk: int = 10,
        postprocessor: PathPostprocessor | None = None,
        path_callback: Callable[[np.ndarray], None] | None = None,
    ):
        self.planner = planner
        self.planning_timeout = planning_timeout
        self.steps_per_chunk = steps_per_chunk
        self.postprocessor = postprocessor
        self.path_callback = path_callback
        self._mutex = threading.Lock()
        self._robot_pose: np.ndarray | None = None
        self._boundaries = None
        self._is_planning = False

    # ------------------------------------------------------------- inputs

    def update_robot_pose(self, pose: np.ndarray) -> None:
        """Feed the current robot pose (the reference's TF lookup)."""
        with self._mutex:
            self._robot_pose = np.asarray(pose, np.float32)

    def update_boundaries(self, boundaries) -> None:
        with self._mutex:
            self._boundaries = boundaries

    def update_world(self, oracle_params: Any) -> None:
        """Live obstacle updates (the reference's point-cloud/map callbacks);
        `oracle_params` is the port's oracle with a leading axis of 1."""
        with self._mutex:
            self.planner.update_oracle(oracle_params)

    def set_goal(self, goal: np.ndarray) -> bool:
        """New navigation goal: re-init the planner from the current robot pose
        (ref goal callback :27-37). Returns False if prerequisites missing."""
        with self._mutex:
            if self._robot_pose is None or self._boundaries is None:
                return False
            self.planner.init(self._robot_pose, np.asarray(goal, np.float32), self._boundaries)
            self._is_planning = True
            return True

    def stop(self) -> None:
        with self._mutex:
            self._is_planning = False

    # -------------------------------------------------------------- cycle

    def replan_cycle(self) -> np.ndarray | None:
        """One replanning cycle (the reference's 10 Hz timer callback :44-63):
        track the robot pose, optimize within the time budget, publish.

        Chunks run while the budget lasts, so a positive budget runs at least
        one. Returns the (postprocessed) path, or None when idle.
        """
        with self._mutex:
            if not self._is_planning:
                return None
            if self._robot_pose is not None:
                self.planner.update_start_point(self._robot_pose)
            deadline = time.perf_counter() + self.planning_timeout
            steps = 0
            while time.perf_counter() < deadline:
                aux = self.planner.step(self.steps_per_chunk)
                # wait for the chunk before re-checking the clock: CUDA
                # launches are asynchronous, so without a sync the loop would
                # queue far more steps than the budget allows
                aux.trajectory_loss[0, -1].item()
                steps += self.steps_per_chunk
            path = self.planner.get_path()
        if self.postprocessor is not None:
            path = self.postprocessor.process(path)
        if self.path_callback is not None:
            self.path_callback(path)
        return path

    def run(self, rate_hz: float = 10.0, cycles: int | None = None) -> None:
        """Blocking replanning loop at `rate_hz` (None cycles = forever)."""
        period = 1.0 / rate_hz
        count = 0
        while cycles is None or count < cycles:
            started = time.perf_counter()
            self.replan_cycle()
            count += 1
            sleep = period - (time.perf_counter() - started)
            if sleep > 0:
                time.sleep(sleep)
