"""Synthetic planning scenes — deterministic fixtures for tests and demos.

Numerically identical scenes to the reference's `test_environment_builder.py:7-53`
(two offset walls; car/parking scene), exposed as plain arrays plus ready-made
device oracles.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Environment", "two_walls_environment", "two_walls_se2_environment", "car_environment"]


@dataclass(frozen=True)
class Environment:
    """A planning problem: endpoints, world box, and point obstacles."""

    start: np.ndarray  # [2] or [3]
    goal: np.ndarray  # [2] or [3]
    bounds: tuple[float, float, float, float]  # (xmin, xmax, ymin, ymax)
    obstacle_points: np.ndarray  # [P, 2]


def _point_line(start, end, count: int) -> np.ndarray:
    x = np.linspace(start[0], end[0], count)
    y = np.linspace(start[1], end[1], count)
    return np.stack([x, y], axis=1)


def _two_walls_points() -> np.ndarray:
    """Two vertical walls with offset gaps (ref test_environment_builder.py:16-22)."""
    wall1 = np.stack([np.full(10, 1.15), np.linspace(0.0, 2.0, 10)], axis=1)
    wall2 = wall1.copy()
    wall2[:, 0] = 1.85
    wall2[:, 1] += 1.0
    return np.concatenate([wall1, wall2], axis=0)


def two_walls_environment() -> Environment:
    """Holonomic two-wall scene (ref :8-14)."""
    return Environment(
        start=np.array([0.5, 0.5], dtype=np.float32),
        goal=np.array([2.5, 2.5], dtype=np.float32),
        bounds=(-0.1, 3.1, -0.1, 3.1),
        obstacle_points=_two_walls_points(),
    )


def two_walls_se2_environment() -> Environment:
    """SE(2) two-wall scene (ref :31-37)."""
    return Environment(
        start=np.array([0.5, 0.5, 0.0], dtype=np.float32),
        goal=np.array([2.5, 1.5, 0.0], dtype=np.float32),
        bounds=(-0.1, 3.1, -0.1, 3.1),
        obstacle_points=_two_walls_points(),
    )


def car_environment() -> Environment:
    """Parallel-parking scene with a slot between two walls (ref :39-53)."""
    y1, x1 = 2.3, 1.6
    points = np.concatenate(
        [
            _point_line((0.0, y1), (x1, y1), 10),
            _point_line((x1, y1), (x1, 3.0), 10),
            _point_line((2.5, y1), (2.5, 3.0), 10),
            _point_line((2.5, y1), (3.0, y1), 10),
        ]
    )
    return Environment(
        start=np.array([0.5, 1.5, 0.0], dtype=np.float32),
        goal=np.array([2.0, 2.7, 0.0], dtype=np.float32),
        bounds=(-0.1, 3.1, -0.1, 3.1),
        obstacle_points=points,
    )
