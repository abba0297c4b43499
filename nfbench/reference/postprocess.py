"""Plain NumPy reference of the path postprocessing a controller receives
(the reference's ros/path_postprocessor.py:13-69): drop waypoints closer
than `minimal_distance` to the last one kept (walking from the goal, both
endpoints kept), resample at `distance_step` along the xy arc length with
quadratic interpolation of x, y and the unwrapped heading, and cut an
initial backwards-motion prefix when the direction flips within the first
six waypoints. It imports nothing of the program."""
from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d


def wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def unwrap(a):
    a = wrap(a)
    d = a[1:] - a[:-1]
    d = np.where(d > np.pi, d - 2 * np.pi, d)
    d = np.where(d < -np.pi, d + 2 * np.pi, d)
    return a[0] + np.concatenate([np.zeros(1), np.cumsum(d)])


def postprocess(path, minimal_distance: float = 0.001, distance_step: float = 0.05):
    """[N, 3] -> [M, 3] in float64."""
    path = np.asarray(path, dtype=np.float64)
    if len(path) < 3:
        return path
    kept, last = [path[-1]], path[-1]
    for point in path[-2:0:-1]:
        if np.linalg.norm(last[:2] - point[:2]) > minimal_distance:
            kept.append(point)
            last = point
    kept.append(path[0])
    path = np.asarray(kept[::-1])
    if len(path) < 3:
        return path
    seg = np.linalg.norm(np.diff(path[:, :2], axis=0), axis=1) + 1e-6
    cum = np.concatenate([np.zeros(1), np.cumsum(seg)])
    count = max(int(cum[-1] / distance_step), 2)
    path = path.copy()
    path[:, 2] = unwrap(path[:, 2])
    out = interp1d(cum / cum[-1], path, kind="quadratic", axis=0,
                   fill_value="extrapolate")(np.linspace(0, 1, count))
    delta = np.diff(out[:, :2], axis=0)
    mid = out[:-1, 2] + wrap(np.diff(out[:, 2])) / 2
    forward = np.cos(mid) * delta[:, 0] + np.sin(mid) * delta[:, 1] > 0
    first = 1
    flips = np.nonzero(forward != forward[0])[0] if len(forward) else []
    if len(flips) and flips[0] < 6:
        first = max(int(flips[0]), first)
    return out[first:]
