"""A* trajectory initialization (the reference's AstarTrajectoryInitializer,
astar/astar_trajectory_initializer.py:10-46; port of
`nfopp_tpu/astar/initializer.py`): rasterize the world through the collision
oracle on a grid, search, map back to world coordinates, resample to the
solver's trajectory length, and fill angles by interpolation.

Two backends:
  * host (numpy A*/JPS + scipy quadratic resample) — exact reference
    rasterization semantics, for single problems;
  * device (batched wavefront, see `wavefront.py`, plain PyTorch ops) — for
    initializing large problem batches on the card.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.math import linspace, wrap_angle
from ..utils.host_math import reparametrize_path, wrap_angles
from .grid_search import GridSearch
from .wavefront import wavefront_path

__all__ = ["AstarTrajectoryInitializer", "batched_wavefront_trajectories"]


class AstarTrajectoryInitializer:
    """Host-side initializer producing [N, 3] initial trajectories.

    `collision_fn`: [M, 3] poses -> [M] bool (any host-callable oracle; wrap a
    device oracle or use an analytic numpy checker).
    """

    def __init__(
        self,
        collision_fn: Callable[[np.ndarray], np.ndarray],
        bounds: tuple[float, float, float, float],
        resolution: float = 0.5,
        init_angles_with_trajectory: bool = False,
        use_jps: bool = False,
    ):
        self.collision_fn = collision_fn
        self.bounds = bounds
        self.resolution = resolution
        self.init_angles_with_trajectory = init_angles_with_trajectory
        self.use_jps = use_jps

    def rasterize(self) -> np.ndarray:
        """Query the oracle at cell centers (fixed probe angle 3pi/4, as the
        reference does, astar_trajectory_initializer.py:27-39) -> blocked[H, W]
        with rows = y cells, cols = x cells."""
        xmin, xmax, ymin, ymax = self.bounds
        res = self.resolution
        x_cells = int((xmax - xmin) // res) + 1
        y_cells = int((ymax - ymin) // res) + 1
        xs, ys = np.meshgrid(range(x_cells), range(y_cells))
        x = xs.reshape(-1) * res + res / 2 + xmin
        y = ys.reshape(-1) * res + res / 2 + ymin
        poses = np.stack([x, y, np.full_like(x, 3 * np.pi / 4)], axis=1).astype(np.float32)
        collisions = np.asarray(self.collision_fn(poses))
        # copy: oracle outputs may be read-only buffers (e.g. from jax arrays)
        return collisions.reshape(y_cells, x_cells).copy()

    def _cell(self, point: np.ndarray) -> tuple[int, int]:
        xmin, _, ymin, _ = self.bounds
        return (
            int((point[1] - ymin) // self.resolution),
            int((point[0] - xmin) // self.resolution),
        )

    def astar_world_path(self, start: np.ndarray, goal: np.ndarray) -> np.ndarray:
        """[L, 2] world-coordinate A* path between start/goal cells."""
        blocked = self.rasterize()
        start_cell = self._cell(start)
        goal_cell = self._cell(goal)
        # the reference force-clears the goal cell (:40)
        blocked[goal_cell] = False
        blocked[start_cell] = False
        search = GridSearch(blocked, jps=self.use_jps)
        cells = search.find_path(start_cell, goal_cell)
        xmin, _, ymin, _ = self.bounds
        world = np.zeros((len(cells), 2), np.float32)
        world[:, 0] = cells[:, 1] * self.resolution + self.resolution / 2 + xmin
        world[:, 1] = cells[:, 0] * self.resolution + self.resolution / 2 + ymin
        return world

    def initial_trajectory(self, start: np.ndarray, goal: np.ndarray, length: int) -> np.ndarray:
        """[length, 3] interior waypoints: A* xy + interpolated angles
        (reference initialize_trajectory + initialize_angle semantics)."""
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        path = self.astar_world_path(start, goal)
        full = np.concatenate([start[None, :2], path, goal[None, :2]], axis=0)
        xy = reparametrize_path(full, length + 2)[1:-1]

        delta_angle = wrap_angles(np.asarray([goal[2] - start[2]]))[0]
        angles = np.linspace(start[2], start[2] + delta_angle, length + 2)[1:-1]
        trajectory = np.concatenate([xy, angles[:, None]], axis=1).astype(np.float32)
        if self.init_angles_with_trajectory:
            trajectory = self._blend_angles(trajectory, start, goal, length)
        return trajectory

    def _blend_angles(self, trajectory, start, goal, length):
        """Triangular-weighted blend toward the path direction
        (trajectory_initializer.py:31-43)."""
        full = np.concatenate([start[None], trajectory, goal[None]], axis=0)
        dx = full[2:, 0] - full[:-2, 0]
        dy = full[2:, 1] - full[:-2, 1]
        headings = np.arctan2(dy, dx)
        weights = np.concatenate(
            [np.linspace(0.0, 1.0, length // 2), np.linspace(1.0, 0.0, (length + 1) // 2)]
        )
        trajectory[:, 2] += wrap_angles(headings - trajectory[:, 2]) * weights
        return trajectory


def batched_wavefront_trajectories(
    blocked: torch.Tensor,  # [B, H, W] occupancy grids
    starts: torch.Tensor,  # [B, 3]
    goals: torch.Tensor,  # [B, 3]
    origin: torch.Tensor,  # [B, 2] world (x, y) corner of each grid
    resolution: torch.Tensor,  # [B]
    length: int,
) -> torch.Tensor:
    """[B, length, 3] initial trajectories for a whole batch, on the grids'
    device.

    xy from the wavefront geodesic path; angles linearly interpolated with the
    wrapped endpoint delta (the straight-line initializer's angle rule). Cell
    indices are floor divisions, as JAX's `//`.
    """
    device = blocked.device
    starts, goals, origin, resolution = (
        x.to(device=device, dtype=torch.float32) for x in (starts, goals, origin, resolution))

    def cell(pose):
        # grids index (row=y, col=x); origin is the (x, y) world corner
        return torch.stack([
            torch.div(pose[:, 1] - origin[:, 1], resolution, rounding_mode="floor"),
            torch.div(pose[:, 0] - origin[:, 0], resolution, rounding_mode="floor"),
        ], dim=1).to(torch.int32)

    origin_rc = torch.stack([origin[:, 1], origin[:, 0]], dim=1)
    path_rc = wavefront_path(blocked, cell(starts), cell(goals), length + 2, origin_rc,
                             resolution)
    xy = torch.stack([path_rc[..., 1], path_rc[..., 0]], dim=-1)
    # pin true endpoints (cell centres are quantized)
    xy[:, 0] = starts[:, :2]
    xy[:, -1] = goals[:, :2]
    goal_angle = starts[:, 2] + wrap_angle(goals[:, 2] - starts[:, 2])
    theta = linspace(starts[:, 2], goal_angle, length + 2)
    return torch.cat([xy, theta[..., None]], dim=-1)[:, 1:-1]
