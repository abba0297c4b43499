"""Device-side collision oracles on batched queries (port of the rectangle,
circle and boundary oracles of `nfopp_tpu/worlds/oracle.py`).

Every oracle leaf carries a leading problem axis ([B, ...], or 1 to share one
world across the batch); queries are [B, M, >=2] and answers [B, M] bool.
Variable obstacle counts are padded with far-away points plus a mask.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "CircleOracle",
    "RectangleOracle",
    "boundary_collision",
    "circle_collision",
    "rectangle_collision",
    "pad_obstacle_points",
]

# far-away sentinel for padded obstacle slots (`worlds/oracle.py:44`)
_PAD_VALUE = 1e9


class CircleOracle(NamedTuple):
    """Disc robot of `radius` against point obstacles + boundary box."""

    points: torch.Tensor  # [B, P, 2] padded obstacle points
    mask: torch.Tensor  # [B, P] bool, True for real obstacles
    radius: torch.Tensor  # [B]
    bounds: torch.Tensor  # [B, 4] = (xmin, xmax, ymin, ymax)


class RectangleOracle(NamedTuple):
    """Rectangle footprint `box` = (xmin, xmax, ymin, ymax) in the robot frame."""

    points: torch.Tensor  # [B, P, 2]
    mask: torch.Tensor  # [B, P]
    box: torch.Tensor  # [B, 4]
    bounds: torch.Tensor  # [B, 4]


def pad_obstacle_points(points: np.ndarray, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad a [P, 2] obstacle array to `capacity` rows; returns (points, mask)."""
    count = points.shape[0]
    if count > capacity:
        raise ValueError(f"{count} obstacle points exceed capacity {capacity}")
    padded = np.full((capacity, 2), _PAD_VALUE, dtype=np.float32)
    padded[:count] = points
    mask = np.zeros(capacity, dtype=bool)
    mask[:count] = True
    return padded, mask


def boundary_collision(bounds: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """True where xy [B, M, 2] lies outside bounds [B, 4]."""
    x, y = xy[..., 0], xy[..., 1]
    b = bounds[:, None, :]
    return (x > b[..., 1]) | (x < b[..., 0]) | (y > b[..., 3]) | (y < b[..., 2])


def circle_collision(oracle: CircleOracle, positions: torch.Tensor) -> torch.Tensor:
    """[B, M, >=2] poses -> [B, M] bool; the angle channel is ignored."""
    xy = positions[..., :2]
    diff = xy[:, :, None, :] - oracle.points[:, None, :, :]  # [B, M, P, 2]
    dist_sq = torch.sum(diff * diff, dim=-1)
    radius = oracle.radius.reshape(-1, 1, 1)
    hit = (dist_sq < radius**2) & oracle.mask[:, None, :]
    return torch.any(hit, dim=-1) | boundary_collision(oracle.bounds, xy)


def rectangle_collision(oracle: RectangleOracle, positions: torch.Tensor) -> torch.Tensor:
    """[B, M, 3] SE(2) poses -> [B, M] bool.

    Obstacle points are moved into each robot frame and box-tested with
    strict inequalities (`worlds/oracle.py:202-222`): a point exactly on the
    box edge does not collide.
    """
    px, py, theta = positions[..., 0], positions[..., 1], positions[..., 2]
    cos_t, sin_t = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    ox = oracle.points[:, None, :, 0] - px[..., None]  # [B, M, P]
    oy = oracle.points[:, None, :, 1] - py[..., None]
    local_x = cos_t * ox + sin_t * oy
    local_y = -sin_t * ox + cos_t * oy
    box = oracle.box[:, None, None, :]
    inside = (
        (local_x > box[..., 0])
        & (local_x < box[..., 1])
        & (local_y > box[..., 2])
        & (local_y < box[..., 3])
        & oracle.mask[:, None, :]
    )
    return torch.any(inside, dim=-1) | boundary_collision(oracle.bounds, positions[..., :2])
