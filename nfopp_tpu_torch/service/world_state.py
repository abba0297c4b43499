"""Live world state for the replanning service (port of
`nfopp_tpu/service/world_state.py`).

Middleware-neutral equivalents of the reference's ROS adapters:
  * `WorldState` merges static map obstacles with streaming sensor points and
    produces updated oracle parameters (ros/map_adapter.py + grid_map.py +
    collision_checker_adapter.py: occupancy grid -> point cloud + boundaries,
    merged with live PointCloud2 points into the planner's checker).
  * `RobotStateProvider` is the TF-lookup stand-in (ros/robot_state.py,
    transform_receiver.py): any callable returning the current SE(2) pose.

The inputs stay on the host (numpy). The oracles come out on the device
given to the constructor, with the leading robot axis the port's solvers
take: `batch` rows of the same world (1 for `NFOPPlanner`).
"""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from ..utils.device import check_device
from ..worlds.oracle import CircleOracle, GridOracle, pad_obstacle_points
from ..worlds.scenarios import GridScenario, dilate

__all__ = ["WorldState", "RobotStateProvider"]

RobotStateProvider = Callable[[], np.ndarray]  # () -> [3] (x, y, theta)


class WorldState:
    def __init__(self, point_capacity: int = 4096, device="cuda"):
        self.point_capacity = point_capacity
        self.device = check_device(device, "WorldState")
        self._mutex = threading.Lock()
        self._map_points = np.zeros((0, 2), np.float32)
        self._sensor_points = np.zeros((0, 2), np.float32)
        self._scenario: GridScenario | None = None
        self._boundaries: tuple[float, float, float, float] | None = None

    # ------------------------------------------------------------- inputs

    def update_map(self, scenario: GridScenario) -> None:
        """Occupied cells -> obstacle point cloud + boundaries
        (ref grid_map.py:14-29)."""
        occupied = np.argwhere(scenario.blocked)
        ox, oy = scenario.origin
        points = np.stack(
            [
                ox + (occupied[:, 1] + 0.5) * scenario.resolution,
                oy + (occupied[:, 0] + 0.5) * scenario.resolution,
            ],
            axis=1,
        ).astype(np.float32) if len(occupied) else np.zeros((0, 2), np.float32)
        with self._mutex:
            self._scenario = scenario
            self._map_points = points
            self._boundaries = scenario.bounds

    def update_sensor_points(self, points: np.ndarray) -> None:
        """Streaming obstacle observations (ref collision_checker_adapter.py:17-27)."""
        with self._mutex:
            self._sensor_points = np.asarray(points, np.float32).reshape(-1, 2)

    # ------------------------------------------------------------ outputs

    @property
    def boundaries(self):
        with self._mutex:
            return self._boundaries

    def merged_points(self) -> np.ndarray:
        with self._mutex:
            return np.concatenate([self._map_points, self._sensor_points], axis=0)

    def _rows(self, value, dtype, batch: int) -> torch.Tensor:
        """`value` as `batch` identical rows on the device."""
        row = torch.tensor(np.asarray(value, dtype), device=self.device)[None]
        return row.repeat((batch,) + (1,) * (row.ndim - 1))

    def circle_oracle(self, radius: float, batch: int = 1) -> CircleOracle:
        """Point-cloud oracle over map + live points (the reference's circle
        checker wiring, goal_planner_adapter_factory.py:19-22), `batch` rows."""
        merged = self.merged_points()
        pts, mask = pad_obstacle_points(merged, self.point_capacity)
        bounds = self.boundaries or (0.0, 0.0, 0.0, 0.0)
        return CircleOracle(
            points=self._rows(pts, np.float32, batch),
            mask=self._rows(mask, bool, batch),
            radius=self._rows(radius, np.float32, batch),
            bounds=self._rows(bounds, np.float32, batch),
        )

    def grid_oracle(self, footprint_radius: float = 0.0, batch: int = 1) -> GridOracle:
        """Bitmap oracle: the static map plus sensor points rasterized in,
        `batch` rows."""
        with self._mutex:
            scenario = self._scenario
            sensor = self._sensor_points.copy()
        if scenario is None:
            raise ValueError("no map received yet")
        blocked = scenario.blocked.copy()
        if len(sensor):
            ox, oy = scenario.origin
            j = ((sensor[:, 0] - ox) / scenario.resolution).astype(int)
            i = ((sensor[:, 1] - oy) / scenario.resolution).astype(int)
            keep = (i >= 0) & (i < blocked.shape[0]) & (j >= 0) & (j < blocked.shape[1])
            blocked[i[keep], j[keep]] = True
        if footprint_radius > 0:
            blocked = dilate(blocked, int(np.ceil(footprint_radius / scenario.resolution)))
        return GridOracle(
            occupancy=self._rows(blocked, bool, batch),
            origin=self._rows(scenario.origin, np.float32, batch),
            resolution=self._rows(scenario.resolution, np.float32, batch),
            bounds=self._rows(scenario.bounds, np.float32, batch),
        )
