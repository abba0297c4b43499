"""Device-side collision oracles on batched queries (port of
`nfopp_tpu/worlds/oracle.py`): boundary box, circle and rectangle footprints
against point obstacles, an occupancy grid, and exact polygons.

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
    "GridOracle",
    "PolygonOracle",
    "boundary_collision",
    "circle_collision",
    "rectangle_collision",
    "grid_collision",
    "polygon_collision",
    "polygon_clearance",
    "pad_obstacle_points",
    "pad_polygons",
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


class GridOracle(NamedTuple):
    """Occupancy-bitmap world: occupancy[b, i, j] covers the cell with x in
    [origin_x + j*res, origin_x + (j+1)*res), y likewise with row i."""

    occupancy: torch.Tensor  # [B, H, W] bool/float, True = collision
    origin: torch.Tensor  # [B, 2] world (x, y) of the grid's lower corner
    resolution: torch.Tensor  # [B] cell size
    bounds: torch.Tensor  # [B, 4]


class PolygonOracle(NamedTuple):
    """Exact polygonal obstacles: a pose collides iff its xy is inside a
    polygon (even-odd rule), within `radius` of a polygon edge (0 = point
    robot), or outside the boundary box. Loops are padded to [P, K, 2] by
    repeating their last vertex (inert zero-length edges); empty slots hold
    sentinel vertices and mask=False (`pad_polygons`)."""

    vertices: torch.Tensor  # [B, P, K, 2] padded vertex loops
    mask: torch.Tensor  # [B, P] bool, True for real polygons
    radius: torch.Tensor  # [B] footprint inflation (0 = point robot)
    bounds: torch.Tensor  # [B, 4]


def pad_polygons(
    polygons: list[np.ndarray], capacity: int | None = None,
    max_vertices: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of [K_i, 2] vertex loops to ([P, K, 2], mask [P])."""
    count = len(polygons)
    p = capacity if capacity is not None else count
    if count > p:
        raise ValueError(f"{count} polygons exceed capacity {p}")
    k = max_vertices if max_vertices is not None else max(
        (len(poly) for poly in polygons), default=1
    )
    vertices = np.full((p, k, 2), _PAD_VALUE, dtype=np.float32)
    mask = np.zeros(p, dtype=bool)
    for i, poly in enumerate(polygons):
        poly = np.asarray(poly, np.float32)
        if len(poly) > k:
            raise ValueError(f"polygon {i} has {len(poly)} > {k} vertices")
        vertices[i, : len(poly)] = poly
        vertices[i, len(poly) :] = poly[-1]  # zero-length edges: inert
        mask[i] = True
    return vertices, mask


def _polygon_inside(oracle: PolygonOracle, xy: torch.Tensor) -> torch.Tensor:
    """[B, M, 2] -> [B, M] bool: inside any (masked) polygon, even-odd rule."""
    v0 = oracle.vertices[:, None]  # [B, 1, P, K, 2]
    v1 = torch.roll(v0, -1, dims=3)
    x, y = xy[..., 0, None, None], xy[..., 1, None, None]  # [B, M, 1, 1]
    x0, y0, x1, y1 = v0[..., 0], v0[..., 1], v1[..., 0], v1[..., 1]
    straddles = (y0 > y) != (y1 > y)
    # x coordinate where the edge crosses the horizontal ray through y
    t = (y - y0) / (y1 - y0 + 1e-30)
    crosses = straddles & (x < x0 + t * (x1 - x0))
    parity = torch.sum(crosses, dim=3) % 2  # [B, M, P]
    return torch.any((parity == 1) & oracle.mask[:, None, :], dim=2)


def _polygon_edge_distance(oracle: PolygonOracle, xy: torch.Tensor) -> torch.Tensor:
    """[B, M, 2] -> [B, M] exact least distance to any (masked) polygon edge."""
    v0 = oracle.vertices[:, None]  # [B, 1, P, K, 2]
    d = torch.roll(v0, -1, dims=3) - v0
    w = xy[:, :, None, None, :] - v0  # [B, M, P, K, 2]
    denom = torch.clamp(torch.sum(d * d, dim=-1), min=1e-30)
    t = torch.clamp(torch.sum(w * d, dim=-1) / denom, 0.0, 1.0)
    diff = xy[:, :, None, None, :] - (v0 + t[..., None] * d)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [B, M, P, K]
    dist = torch.where(oracle.mask[:, None, :, None], dist, torch.inf)
    return torch.amin(dist, dim=(2, 3))


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


def grid_collision(oracle: GridOracle, positions: torch.Tensor) -> torch.Tensor:
    """[B, M, >=2] poses -> [B, M] bool: the occupancy of the cell each xy
    falls in (clamped to the grid), or outside the boundary box."""
    xy = positions[..., :2]
    h, w = oracle.occupancy.shape[-2:]
    res = oracle.resolution.reshape(-1, 1)
    j = torch.floor((xy[..., 0] - oracle.origin[:, None, 0]) / res).to(torch.int64)
    i = torch.floor((xy[..., 1] - oracle.origin[:, None, 1]) / res).to(torch.int64)
    cells = torch.clamp(i, 0, h - 1) * w + torch.clamp(j, 0, w - 1)
    flat = oracle.occupancy.reshape(oracle.occupancy.shape[0], h * w)
    occupied = torch.gather(flat.expand(cells.shape[0], -1), 1, cells).bool()
    return occupied | boundary_collision(oracle.bounds, xy)


def polygon_collision(oracle: PolygonOracle, positions: torch.Tensor) -> torch.Tensor:
    """[B, M, >=2] poses -> [B, M] bool against the exact polygons: inside
    one (even-odd) | edge distance < radius | outside the boundary box."""
    xy = positions[..., :2]
    radius = oracle.radius.reshape(-1, 1)
    near = (radius > 0) & (_polygon_edge_distance(oracle, xy) < radius)
    return _polygon_inside(oracle, xy) | near | boundary_collision(oracle.bounds, xy)


def polygon_clearance(oracle: PolygonOracle, xy: torch.Tensor) -> torch.Tensor:
    """[B, M, 2] -> [B, M] exact clearance: distance to the nearest polygon
    edge, 0 inside an obstacle."""
    dist = _polygon_edge_distance(oracle, xy)
    return torch.where(_polygon_inside(oracle, xy), torch.zeros_like(dist), dist)
