"""Path-quality metrics: the bench-mr PathStatistics suite (a copy of
`nfopp_tpu/bench/metrics.py`; numpy, no device work).

Python twin of the native evaluator (native/path_stats.cpp — formulas
documented there); `path_statistics` prefers the native library and falls back
to numpy. Reproduces the stats schema the reference serializes per run
(BenchmarkAdapter.cpp:68-135): path_found, path_collides, path_length,
max/normalized curvature, AOL, smoothness, clearing distance stats, cusps.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

from ..utils.host_math import wrap_angles
from . import native_binding

__all__ = [
    "PathStatistics",
    "active_evaluator",
    "path_statistics",
    "path_stats_numpy",
    "polygons_to_segments",
    "segment_clearance_numpy",
]


def polygons_to_segments(polygons: list[np.ndarray]) -> np.ndarray:
    """[K_i, 2] vertex loops -> [S, 4] closed-edge rows (x0, y0, x1, y1),
    the exact-geometry obstacle representation for clearance metrics."""
    rows = []
    for poly in polygons:
        poly = np.asarray(poly, np.float64)
        nxt = np.roll(poly, -1, axis=0)
        rows.append(np.concatenate([poly, nxt], axis=1))
    return np.concatenate(rows, axis=0) if rows else np.zeros((0, 4))


def segment_clearance_numpy(path: np.ndarray, segments: np.ndarray) -> np.ndarray:
    """numpy twin of the native segment-clearance: [4] = mean, median, min,
    max of per-waypoint exact min distance to any segment."""
    if len(path) < 1 or segments is None or len(segments) < 1:
        return np.full(4, -1.0)
    xy = np.asarray(path, np.float64)[:, :2]
    seg = np.asarray(segments, np.float64)
    a, d = seg[:, :2], seg[:, 2:] - seg[:, :2]
    denom = np.maximum((d * d).sum(axis=1), 1e-30)
    w = xy[:, None, :] - a[None]  # [N, S, 2]
    t = np.clip((w * d[None]).sum(axis=2) / denom[None], 0.0, 1.0)
    closest = a[None] + t[..., None] * d[None]
    dist = np.linalg.norm(xy[:, None, :] - closest, axis=2).min(axis=1)
    return np.array([dist.mean(), np.median(dist), dist.min(), dist.max()])


def active_evaluator() -> str:
    """Which implementation `path_statistics` will use: 'native' (C++ .so,
    built on demand) or 'numpy' (fallback twin). Recorded into every results
    JSON so committed artifacts carry their metric provenance."""
    return "native" if native_binding.available() else "numpy"


@dataclass
class PathStatistics:
    planner: str = "nfopp"
    path_found: bool = False
    path_collides: bool = True
    exact_goal_path: bool = True
    planning_time: float = 0.0
    collision_time: float = 0.0
    path_length: float = 0.0
    max_curvature: float = 0.0
    normalized_curvature: float = 0.0
    aol: float = 0.0
    smoothness: float = 0.0
    mean_clearing_distance: float | None = None
    median_clearing_distance: float | None = None
    min_clearing_distance: float | None = None
    max_clearing_distance: float | None = None
    cusps: int = 0

    def as_dict(self) -> dict:
        return asdict(self)


def path_stats_numpy(
    path: np.ndarray,
    obstacles: np.ndarray | None = None,
    angular_weight: float = 1.0,
    cusp_threshold: float = np.pi / 2,
) -> np.ndarray:
    """numpy implementation of the native [12]-vector (see path_stats.cpp)."""
    path = np.asarray(path, np.float64)
    out = np.zeros(12)
    n = len(path)
    if n < 2:
        out[6:10] = -1.0
        return out
    xy = path[:, :2]
    seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    out[0] = seg.sum()

    # Menger curvature
    if n >= 3:
        a, b, c = xy[:-2], xy[1:-1], xy[2:]
        ab = np.linalg.norm(b - a, axis=1)
        bc = np.linalg.norm(c - b, axis=1)
        ca = np.linalg.norm(c - a, axis=1)
        cross = np.abs(
            (b[:, 0] - a[:, 0]) * (c[:, 1] - b[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - b[:, 0])
        )
        valid = (ab > 1e-12) & (bc > 1e-12) & (ca > 1e-12)
        k = np.where(valid, 2.0 * cross / np.maximum(ab * bc * ca, 1e-300), 0.0)
        out[1] = k.max(initial=0.0)
        out[2] = float(np.sum(k * 0.5 * ca))

    # AOL (skip zero-length segments when accumulating heading changes)
    headings = []
    for i in range(n - 1):
        if seg[i] > 1e-12:
            headings.append(np.arctan2(xy[i + 1, 1] - xy[i, 1], xy[i + 1, 0] - xy[i, 0]))
    if len(headings) >= 2:
        hs = np.asarray(headings)
        out[10] = float(np.abs(wrap_angles(np.diff(hs))).sum())
    out[3] = out[10] / out[0] if out[0] > 1e-12 else 0.0

    # OMPL smoothness with SE(2) compound distance
    def se2_dist(i, j):
        d = np.linalg.norm(xy[j] - xy[i])
        dt = abs(wrap_angles(np.asarray([path[j, 2] - path[i, 2]]))[0])
        return d + angular_weight * dt

    smooth = 0.0
    if n > 2:
        a_len = se2_dist(0, 1)
        for i in range(2, n):
            b_len = se2_dist(i - 1, i)
            c_len = se2_dist(i - 2, i)
            if a_len > 1e-12 and b_len > 1e-12:
                acos_val = (a_len**2 + b_len**2 - c_len**2) / (2 * a_len * b_len)
                if -1.0 < acos_val < 1.0:
                    angle = np.pi - np.arccos(acos_val)
                    smooth += (2.0 * angle / (a_len + b_len)) ** 2
            a_len = b_len
    out[4] = smooth

    # cusps (duplicate-skipping walk, BenchmarkAdapter.cpp:104-133)
    cusps = 0
    prev = cur = nxt = 0
    while nxt < n:
        if np.linalg.norm(xy[cur] - xy[prev]) <= 0.0:
            cur += 1
            nxt += 1
        elif np.linalg.norm(xy[nxt] - xy[cur]) <= 0.0:
            nxt += 1
        else:
            yaw_prev = np.arctan2(xy[cur, 1] - xy[prev, 1], xy[cur, 0] - xy[prev, 0])
            yaw_next = np.arctan2(xy[nxt, 1] - xy[cur, 1], xy[nxt, 0] - xy[cur, 0])
            if abs(wrap_angles(np.asarray([yaw_next - yaw_prev]))[0]) > cusp_threshold:
                cusps += 1
            prev, cur, nxt = cur, nxt, nxt + 1
    out[5] = cusps

    if obstacles is not None and len(obstacles):
        obstacles = np.asarray(obstacles, np.float64)
        d = np.linalg.norm(xy[:, None, :] - obstacles[None, :, :], axis=2).min(axis=1)
        out[6], out[7], out[8], out[9] = d.mean(), np.median(d), d.min(), d.max()
    else:
        out[6:10] = -1.0
    return out


def path_statistics(
    path: np.ndarray,
    obstacles: np.ndarray | None = None,
    collides: bool | None = None,
    planner: str = "nfopp",
    planning_time: float = 0.0,
    goal: np.ndarray | None = None,
    exact_goal_radius: float = 1e-2,
    angular_weight: float = 1.0,
    cusp_threshold: float = np.pi / 2,
    use_native: bool = True,
    obstacle_segments: np.ndarray | None = None,
) -> PathStatistics:
    """Full PathStatistics for one [N, 3] path.

    obstacle_segments [S, 4] (rows x0, y0, x1, y1) switches the clearance
    stats to EXACT distances against polygon edges (the reference's clearance
    is vs the true environment, BenchmarkAdapter.cpp:106-135), overriding any
    point-cloud `obstacles` clearance."""
    path = np.asarray(path, np.float64)
    if len(path) < 2:
        return PathStatistics(planner=planner, path_found=False, planning_time=planning_time)
    if use_native and native_binding.available():
        raw = native_binding.path_stats_native(path, obstacles, angular_weight, cusp_threshold)
        if obstacle_segments is not None and len(obstacle_segments):
            raw[6:10] = native_binding.path_clearance_segments_native(
                path, obstacle_segments
            )
    else:
        raw = path_stats_numpy(path, obstacles, angular_weight, cusp_threshold)
        if obstacle_segments is not None and len(obstacle_segments):
            raw[6:10] = segment_clearance_numpy(path, obstacle_segments)
    stats = PathStatistics(
        planner=planner,
        path_found=True,
        path_collides=bool(collides) if collides is not None else False,
        planning_time=planning_time,
        path_length=float(raw[0]),
        max_curvature=float(raw[1]),
        normalized_curvature=float(raw[2]),
        aol=float(raw[3]),
        smoothness=float(raw[4]),
        cusps=int(raw[5]),
    )
    if raw[6] >= 0:
        stats.mean_clearing_distance = float(raw[6])
        stats.median_clearing_distance = float(raw[7])
        stats.min_clearing_distance = float(raw[8])
        stats.max_clearing_distance = float(raw[9])
    if goal is not None:
        stats.exact_goal_path = bool(
            np.linalg.norm(path[-1, :2] - np.asarray(goal)[:2]) <= exact_goal_radius
        )
    return stats
