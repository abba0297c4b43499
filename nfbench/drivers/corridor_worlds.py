"""The benchmark's own corridor worlds, in NumPy and SciPy, so that a change
to the program cannot change the traffic.

The algorithm is Bench-MR's generated corridor world as the port builds it
(`corridor`: axis-aligned corridors of half-width `radius` carved out of
solid rock, each from a random anchor on the network so far) with its
endpoints resampled to a grid geodesic of at least `min_geodesic`
(`distant_endpoints`: a random free goal cell, the geodesic distance of
every free cell to it on the grid dilated by the clearance, and a random
start among the cells far enough; up to `goal_tries` goals, else the
farthest pair seen). Each world draws from two `np.random.RandomState`s of
its own, one for the walls and one for the endpoints, so a world does not
depend on the others. Given the seeds the port's generator takes, the
grids and poses are the port's (the tier-1 tests hold them equal).

The geodesic distance is the 8-connected min-plus relaxation (1 per
orthogonal step, 1.4142135 per diagonal, in float32, a finite sentinel for
unreachable cells) run for H + W sweeps, or until it stops changing; the
worlds of one try are relaxed together, a few at a time.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

UNREACHED = np.float32(3.0e38 / 4)
_STEPS = [(-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
          (-1, -1, 1.4142135), (-1, 1, 1.4142135), (1, -1, 1.4142135), (1, 1, 1.4142135)]


def corridor_grid(rng: np.random.RandomState, size: int, branches: int,
                  radius: int) -> np.ndarray:
    """[size, size] bool, True = rock: a seed corridor cell in the middle,
    then `branches` axis-aligned segments of random length carved from a
    random earlier anchor, each leaving a new anchor at its end."""
    blocked = np.ones((size, size), bool)

    def carve(i0, j0, i1, j1):
        lo_i, hi_i = sorted((i0, i1))
        lo_j, hi_j = sorted((j0, j1))
        blocked[max(0, lo_i - radius):min(size, hi_i + radius + 1),
                max(0, lo_j - radius):min(size, hi_j + radius + 1)] = False

    anchors = [(size // 2, size // 2)]
    carve(size // 2, size // 2, size // 2, size // 2)
    for _ in range(branches):
        ai, aj = anchors[rng.randint(len(anchors))]
        length = rng.randint(size // 8, size // 2)
        if rng.rand() < 0.5:
            ni = int(np.clip(ai + rng.choice([-1, 1]) * length, radius, size - radius - 1))
            carve(ai, aj, ni, aj)
            anchors.append((ni, aj))
        else:
            nj = int(np.clip(aj + rng.choice([-1, 1]) * length, radius, size - radius - 1))
            carve(ai, aj, ai, nj)
            anchors.append((ai, nj))
    return blocked


def dilate(blocked: np.ndarray, radius_cells: int) -> np.ndarray:
    """Binary dilation by a disc of `radius_cells` (cells with di^2 + dj^2
    <= r^2); nothing enters from beyond the grid's edge."""
    if radius_cells <= 0:
        return blocked
    r = radius_cells
    di, dj = np.mgrid[-r:r + 1, -r:r + 1]
    return ndimage.binary_dilation(blocked, structure=di * di + dj * dj <= r * r)


def distance_fields(blocked: np.ndarray, goals: np.ndarray, block: int = 8) -> np.ndarray:
    """[B, H, W] float32 geodesic distance of every cell of grids `blocked`
    [B, H, W] to the cells `goals` [B, 2] (row, col); `UNREACHED` where no
    path leads (test `> 1e30`). Relaxed `block` worlds at a time, which
    keeps the arrays in the host's cache."""
    batch, h, w = blocked.shape
    out = np.empty((batch, h, w), np.float32)
    for lo in range(0, batch, block):
        part, cells = blocked[lo:lo + block], goals[lo:lo + block]
        rows = len(part)
        wall = np.where(part, UNREACHED, np.float32(0.0)).astype(np.float32)
        dist = np.full((rows, h, w), UNREACHED, np.float32)
        dist[np.arange(rows), cells[:, 0], cells[:, 1]] = 0.0
        padded = np.full((rows, h + 2, w + 2), UNREACHED, np.float32)
        shifted = np.empty_like(dist)
        for _ in range(h + w):
            padded[:, 1:-1, 1:-1] = dist
            best = dist.copy()
            for di, dj, cost in _STEPS:
                np.add(padded[:, 1 - di:1 - di + h, 1 - dj:1 - dj + w], np.float32(cost),
                       out=shifted)
                np.minimum(best, shifted, out=best)
            best += wall
            np.minimum(dist, best, out=best)
            if np.array_equal(best, dist):
                break
            dist = best
        out[lo:lo + block] = dist
    return out


def distant_endpoints(rngs: list, grids: list, min_geodesic: float, resolution: float = 1.0,
                      clearance_cells: int = 2, margin_cells: int = 2,
                      goal_tries: int = 8) -> list:
    """[(start [3], goal [3])] float32 poses for each grid, each world's draws
    from its own generator in `rngs`: cell centres at least `min_geodesic`
    apart along the geodesic on the grid dilated by `clearance_cells`, at
    least `margin_cells` from the edge, headings uniform in [-pi, pi)."""
    worlds = []
    for grid in grids:
        blocked = dilate(grid, clearance_cells)
        free_i, free_j = np.where(~blocked)
        keep = ((free_i >= margin_cells) & (free_i < blocked.shape[0] - margin_cells)
                & (free_j >= margin_cells) & (free_j < blocked.shape[1] - margin_cells))
        worlds.append((blocked, free_i[keep], free_j[keep]))

    def pose(rng, i, j):
        return np.array([(j + 0.5) * resolution, (i + 0.5) * resolution,
                         rng.uniform(-math.pi, math.pi)], np.float32)

    out: list = [None] * len(grids)
    best: list = [None] * len(grids)  # (distance, start cell, goal cell)
    pending = list(range(len(grids)))
    for _ in range(goal_tries):
        if not pending:
            break
        goals = []
        for w in pending:
            _, free_i, free_j = worlds[w]
            g = rngs[w].randint(len(free_i))
            goals.append((int(free_i[g]), int(free_j[g])))
        fields = distance_fields(np.stack([worlds[w][0] for w in pending]), np.array(goals))
        still = []
        for k, w in enumerate(pending):
            _, free_i, free_j = worlds[w]
            cand = fields[k][free_i, free_j] * np.float32(resolution)
            reachable = np.isfinite(cand) & (cand < 1e30)
            far = reachable & (cand >= min_geodesic)
            gi, gj = goals[k]
            if far.any():
                s = rngs[w].choice(np.where(far)[0])
                out[w] = (pose(rngs[w], int(free_i[s]), int(free_j[s])), pose(rngs[w], gi, gj))
                continue
            if reachable.any():
                s = int(np.argmax(np.where(reachable, cand, -np.inf)))
                d = float(cand[s])
                if best[w] is None or d > best[w][0]:
                    best[w] = (d, (int(free_i[s]), int(free_j[s])), (gi, gj))
            still.append(w)
        pending = still
    for w in pending:
        if best[w] is None:
            raise ValueError(f"world {w}: no reachable endpoint pair")
        (si, sj), (gi, gj) = best[w][1], best[w][2]
        out[w] = (pose(rngs[w], si, sj), pose(rngs[w], gi, gj))
    return out


def build(wall_seeds: list, pose_seeds: list, size: int, branches: int, radius: int,
          min_geodesic: float, resolution: float = 1.0, clearance_cells: int = 2) -> list:
    """[(blocked [size, size] bool, start [3], goal [3])], world i from
    `wall_seeds[i]` and `pose_seeds[i]` (each below 2**32)."""
    grids = [corridor_grid(np.random.RandomState(s), size, branches, radius)
             for s in wall_seeds]
    poses = distant_endpoints([np.random.RandomState(s) for s in pose_seeds], grids,
                              min_geodesic, resolution, clearance_cells)
    return [(grid, start, goal) for grid, (start, goal) in zip(grids, poses)]
