"""Plain PyTorch and NumPy reference of the benchmark suite on grid worlds
(NFOMP on Bench-MR's corridor worlds, as the reference's
scripts/run_bench_mr.py solves them, batched).

It computes, given the worlds and what the program drew:

- grid labels: the cell each xy falls in, clamped into the grid, on the
  grid dilated by the footprint, or a pose outside the world's bounds;
- the wavefront initial paths: the geodesic distance field to the goal
  cell on the dilated grid, the steepest-descent walk from the start cell
  (the first of the eight neighbours with the least distance, in the
  order up, down, left, right and then the diagonals; the walk stops at
  the goal or where no neighbour is nearer), its cell centres resampled
  to N + 2 points evenly in arc length (float64 here), the endpoints
  pinned, the headings interpolated from the start's to the goal's along
  the shorter arc;
- `init_state` with its pretraining, and the constrained step, by
  `planner_se2`'s functions with the grid labels in place of the
  rectangle footprint;
- the tracked loop's decision at each check and its final selection;
- the shortcut pass on given (i, j) pairs;
- the restart selection: the shortest feasible lane of each failed
  problem, the first of equals.

Departures from the reference planner, each also the program's:

- the initial path is the wavefront's geodesic on the dilated grid (the
  role of the reference's AstarTrajectoryInitializer in benchmark mode),
  not its straight line;
- the field is pretrained on uniform points before the solve
  (`init_collision_iteration`, which the reference's configs disable);
- the footprint is a disc folded into the grid by dilation, not a box
  tested against obstacle points;
- the loop checks every `check_freq` steps, keeps the shortest feasible
  path, and stops a problem at its first feasible check past
  `min_iterations` that does not improve (the reference's benchmark
  loop); frozen problems keep their state;
- the shortcut pass and the restart round are the port's additions.

Every tensor function takes a leading problem axis. It imports nothing of
the program, no kernel and no capture.
"""
from __future__ import annotations

import importlib.util
import math
import pathlib

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

_spec = importlib.util.spec_from_file_location(
    "grid_suite_planner_se2", pathlib.Path(__file__).with_name("planner_se2.py"))
se2 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(se2)

UNREACHED = np.float32(3.0e38 / 4)
NEIGHBOURS = [(-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
              (-1, -1, 1.4142135), (-1, 1, 1.4142135), (1, -1, 1.4142135), (1, 1, 1.4142135)]


# -------------------------------------------------------------- the world

def dilate(blocked: np.ndarray, radius_cells: int) -> np.ndarray:
    """Binary dilation by a disc (cells with di^2 + dj^2 <= r^2)."""
    if radius_cells <= 0:
        return blocked
    di, dj = np.mgrid[-radius_cells:radius_cells + 1, -radius_cells:radius_cells + 1]
    return ndimage.binary_dilation(blocked, structure=di * di + dj * dj <= radius_cells ** 2)


def grid_world(grids: list, resolution: float, footprint_radius: float, device) -> dict:
    """The worlds [B] as tensors: `occupancy` [B, H, W] (the grids dilated
    by ceil(radius / resolution) cells), `origin` [B, 2] (0, 0),
    `resolution` [B] and `bounds` [B, 4] (xmin, xmax, ymin, ymax)."""
    cells = int(math.ceil(footprint_radius / resolution)) if footprint_radius > 0 else 0
    occupancy = np.stack([dilate(np.asarray(g, bool), cells) for g in grids])
    batch, h, w = occupancy.shape
    bounds = np.array([0.0, w * resolution, 0.0, h * resolution], np.float32)
    return {"occupancy": torch.as_tensor(occupancy, device=device),
            "origin": torch.zeros((batch, 2), device=device),
            "resolution": torch.full((batch,), resolution, device=device),
            "bounds": torch.as_tensor(np.tile(bounds, (batch, 1)), device=device)}


def rows(world: dict, index) -> dict:
    return {k: v[index] for k, v in world.items()}


def grid_labels(world: dict, poses: torch.Tensor) -> torch.Tensor:
    """[B, M, >=2] poses -> [B, M] bool: the occupancy of the cell each xy
    falls in (clamped into the grid), or outside the bounds."""
    x, y = poses[..., 0], poses[..., 1]
    h, w = world["occupancy"].shape[-2:]
    res = world["resolution"].reshape(-1, 1)
    j = torch.floor((x - world["origin"][:, None, 0]) / res).to(torch.int64)
    i = torch.floor((y - world["origin"][:, None, 1]) / res).to(torch.int64)
    cells = torch.clamp(i, 0, h - 1) * w + torch.clamp(j, 0, w - 1)
    flat = world["occupancy"].reshape(world["occupancy"].shape[0], h * w)
    occupied = torch.gather(flat, 1, cells).bool()
    b = world["bounds"][:, None, :]
    return occupied | (x > b[..., 1]) | (x < b[..., 0]) | (y > b[..., 3]) | (y < b[..., 2])


def collides_and_length(world: dict, full: torch.Tensor, samples: int = 5):
    """([B] bool, [B]) of paths [B, M, 3]: any of `samples` poses per
    segment on an occupied cell, and the xy length."""
    collides = torch.any(grid_labels(world, se2.dense_path(full, samples)), dim=1)
    seg = full[:, 1:, :2] - full[:, :-1, :2]
    return collides, torch.sum(torch.sqrt(torch.sum(seg * seg, dim=-1)), dim=1)


# ---------------------------------------------------------- the wavefront

def distance_field(occupancy: np.ndarray, goal: tuple) -> np.ndarray:
    """[H, W] float32 geodesic distance to the cell `goal` (row, col): the
    8-connected min-plus relaxation (1 orthogonal, 1.4142135 diagonal) for
    H + W sweeps or until it stops changing; UNREACHED where no path
    leads."""
    h, w = occupancy.shape
    wall = np.where(occupancy, UNREACHED, np.float32(0.0)).astype(np.float32)
    dist = np.full((h, w), UNREACHED, np.float32)
    dist[goal] = 0.0
    for _ in range(h + w):
        padded = np.pad(dist, 1, constant_values=UNREACHED)
        best = dist.copy()
        for di, dj, cost in NEIGHBOURS:
            best = np.minimum(best, padded[1 - di:1 - di + h, 1 - dj:1 - dj + w]
                              + np.float32(cost))
        new = np.minimum(dist, best + wall)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def descent(dist: np.ndarray, start: tuple) -> list:
    """The steepest-descent walk's cells from `start` to the goal."""
    h, w = dist.shape
    cell, cells = start, [start]
    for _ in range(h + w):
        if dist[cell] <= 0.0:
            break
        near = [(min(max(cell[0] + di, 0), h - 1), min(max(cell[1] + dj, 0), w - 1))
                for di, dj, _ in NEIGHBOURS]
        values = [dist[c] for c in near]
        k = int(np.argmin(values))
        if not values[k] < dist[cell]:
            break
        cell = near[k]
        cells.append(cell)
    return cells


def wavefront(occupancy: np.ndarray, start: np.ndarray, goal: np.ndarray, resolution: float,
              length: int) -> np.ndarray:
    """[length, 3] float64 initial path of one problem on its dilated grid
    (origin 0, 0), without its endpoints."""
    def cell(pose):
        return int(math.floor(pose[1] / resolution)), int(math.floor(pose[0] / resolution))

    cells = np.array(descent(distance_field(occupancy, cell(goal)), cell(start)), np.float64)
    xy = (cells[:, ::-1] + 0.5) * resolution
    if len(xy) == 1:
        xy = np.concatenate([xy, xy])
    cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(xy, axis=0), axis=1))])
    targets = np.linspace(0.0, 1.0, length + 2) * max(cum[-1], 1e-6)
    idx = np.clip(np.searchsorted(cum, targets) - 1, 0, len(cum) - 2)
    t = np.clip((targets - cum[idx]) / np.maximum(cum[idx + 1] - cum[idx], 1e-6), 0.0, 1.0)
    out = xy[idx] * (1.0 - t[:, None]) + xy[idx + 1] * t[:, None]
    out[0], out[-1] = start[:2], goal[:2]
    s0 = float(start[2])
    turn = (float(goal[2]) - s0 + math.pi) % (2 * math.pi) - math.pi
    theta = np.linspace(s0, s0 + turn, length + 2)
    return np.concatenate([out, theta[:, None]], axis=1)[1:-1]


# ------------------------------------------------------------ the planner

class GridPlanner(se2.Planner):
    """`planner_se2.Planner` on grid worlds: the field is pretrained and
    trained on the grid labels, and a problem starts from a given path."""

    def init_state(self, g, start, goal, bounds, world, trajectory=None) -> dict:
        cfg = self.cfg
        batch, n, k = start.shape[0], cfg["trajectory_length"], cfg["collision_point_count"]
        traj = self.initial_trajectory(start, goal) if trajectory is None else trajectory
        params = se2.init_field(g, self.onf, batch)
        u = torch.rand((batch, k, 3), generator=g, device=g.device)
        state = {
            "trajectory": traj, "params": params,
            "fopt": se2.adam_init(params, batch, self.device),
            "topt": se2.adam_init(traj, batch, self.device),
            "cmult": torch.zeros((batch, n + 1), device=self.device),
            "kmult": torch.zeros((batch, n), device=self.device),
            "buf": se2.uniform_box(u, bounds), "ages": torch.zeros((batch, k), device=self.device),
            "prev": traj, "start": start, "goal": goal, "bounds": bounds,
            "count": torch.zeros((batch,), dtype=torch.int32, device=self.device),
        }
        params, opt = self.pretrain_steps(state["params"], state["fopt"], bounds, world, g,
                                          cfg["init_collision_iteration"])
        return {**state, "params": params, "fopt": opt}

    def pretrain_steps(self, params, opt, bounds, world, g, iterations: int):
        """(params, opt) after `iterations` pretraining steps: Adam on the
        mean BCE of the field against the grid labels of
        `init_collision_points` uniform poses in the bounds each."""
        for _ in range(iterations):
            u = torch.rand((bounds.shape[0], self.cfg["init_collision_points"], 3), generator=g,
                           device=g.device)
            points = se2.uniform_box(u, bounds)
            _, grads = se2.field_grads(params, points, grid_labels(world, points), self.onf,
                                       self.precision)
            params, opt = self.field_adam(grads, opt, params)
        return params, opt

    def field_update(self, s, g, world, group_size=1):
        """`planner_se2.Planner.field_update` with the grid labels."""
        cfg = self.cfg
        prev, bounds = s["prev"], s["bounds"]
        batch, n, _ = prev.shape
        k, r = cfg["collision_point_count"], cfg["random_field_points"]
        cand = k + n - 1
        u = torch.rand((batch, (n - 1) + cand + 3 * r), generator=g, device=g.device)
        t = u[:, : n - 1, None]
        gumbel = -torch.log(-torch.log(torch.clamp(u[:, n - 1: n - 1 + cand], min=1e-20) + 1e-20))
        random_points = se2.uniform_box(u[:, n - 1 + cand:].reshape(batch, r, 3), bounds)
        positions = prev[:, 1:] * (1.0 - t) + prev[:, :-1] * t
        normal = torch.randn((batch, 2, n - 1, 3), generator=g, device=g.device)
        coarse = positions + normal[:, 0] * torch.tensor(
            [cfg["course_random_offset"]] * 2 + [cfg["angle_offset"]], device=self.device)
        fine = positions + normal[:, 1] * torch.tensor(
            [cfg["trajectory_random_offset"]] * 2 + [cfg["angle_offset"]], device=self.device)
        candidates = torch.cat([s["buf"], fine], dim=1)
        ages = torch.cat([s["ages"], torch.zeros_like(fine[..., 0])], dim=1)
        logits = se2.field(s["params"], candidates, self.onf, self.precision)
        log_w = F.logsigmoid(logits) - ages * cfg["buffer_age_decay"]
        floor = float(torch.log(torch.tensor(cfg["buffer_weight_floor"], dtype=torch.float32)))
        log_w = torch.logaddexp(log_w, torch.tensor(floor, device=self.device))
        idx = torch.topk(log_w + gumbel, k, dim=-1).indices
        buf = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, 3))
        new_ages = torch.gather(ages, 1, idx) + 1.0
        points = torch.cat([coarse, buf, random_points], dim=1)
        loss, grads = se2.field_grads(s["params"], points, grid_labels(world, points),
                                      self.onf, self.precision)
        params, fopt = self.field_adam(grads, s["fopt"], s["params"])
        return {**s, "params": params, "fopt": fopt, "buf": buf, "ages": new_ages,
                "prev": s["trajectory"]}, loss

    def probability(self, params: dict, poses: torch.Tensor) -> torch.Tensor:
        """[B, M] the field's occupancy probability at poses [B, M, 3]."""
        return torch.sigmoid(se2.field(params, poses, self.onf, self.precision))


# ------------------------------------------------------- the tracked loop

def check(carry: dict, path: torch.Tensor, world: dict, end_chunk: int, check_freq: int,
          min_iterations: int, samples: int = 5, stop_on_plateau: bool = True) -> dict:
    """One check of the tracked loop: from the carry before a chunk
    (best_length [B], done [B], iterations [B], chunk [B]) and the paths
    after it [B, M, 3], which problems were active, the paths' collisions
    and lengths, which improve on the best, and the carry after."""
    active = ~carry["done"] & (carry["chunk"] < end_chunk)
    iterations = torch.where(active, carry["iterations"] + check_freq, carry["iterations"])
    collides, length = collides_and_length(world, path, samples)
    feasible = active & (iterations > min_iterations) & ~collides
    improves = feasible & (length < carry["best_length"])
    done = carry["done"] | (feasible & ~improves) if stop_on_plateau else carry["done"]
    return {"active": active, "collides": collides, "length": length, "improves": improves,
            "done": done, "iterations": iterations,
            "best_length": torch.where(improves, length, carry["best_length"]),
            "chunk": torch.where(active, carry["chunk"] + 1, carry["chunk"])}


def final_selection(best_path, best_length, final_path, world, samples: int = 5,
                    stop_on_plateau: bool = True):
    """(path [B, M, 3], length [B], feasible [B]) the loop returns: the final
    path unless it collides and a feasible best exists (with the full
    budget, also where the best is shorter)."""
    collides, length = collides_and_length(world, final_path, samples)
    has_best = torch.isfinite(best_length)
    use_best = collides & has_best
    if not stop_on_plateau:
        use_best = has_best & (collides | (best_length < length))
    return (torch.where(use_best[:, None, None], best_path, final_path),
            torch.where(use_best, best_length, length), ~collides | has_best)


# --------------------------------------------------- shortcut and restarts

def shortcut(world: dict, paths: torch.Tensor, pairs: torch.Tensor, samples: int = 5):
    """Paths [B, M, 3] after the trials `pairs` [T, B, 2]: each trial puts the
    chord path[i] -> path[j] (xy lerp, shorter-arc heading) in place of the
    points strictly between, where the whole candidate is collision-free."""
    m = paths.shape[1]
    idx = torch.arange(m, device=paths.device)[None, :]
    rows_ = torch.arange(paths.shape[0], device=paths.device)
    for pair in pairs:
        i, j = pair[:, :1], pair[:, 1:]
        a, b = paths[rows_, pair[:, 0]], paths[rows_, pair[:, 1]]
        delta = b - a
        delta = torch.cat([delta[:, :2], se2.wrap_angle(delta[:, 2:])], dim=1)
        t = torch.clamp((idx - i) / (j - i), 0.0, 1.0).to(paths.dtype)[..., None]
        chord = a[:, None] + t * delta[:, None]
        candidate = torch.where(((idx > i) & (idx < j))[..., None], chord, paths)
        collides = torch.any(grid_labels(world, se2.dense_path(candidate, samples)), dim=1)
        paths = torch.where(collides[:, None, None], paths, candidate)
    return paths


def shortcut_pass(world: dict, paths: np.ndarray, lengths: np.ndarray, feasible: np.ndarray,
                  pairs: torch.Tensor, samples: int = 5):
    """(paths, lengths, feasible) after the pass: a path is replaced by its
    shortcut result wherever that is collision-free, which may repair an
    infeasible one."""
    device = world["occupancy"].device
    short = shortcut(world, torch.as_tensor(paths, device=device), pairs.to(device), samples)
    collides, length = collides_and_length(world, short, samples)
    take = ~collides.cpu().numpy()
    paths, lengths = paths.copy(), lengths.copy()
    paths[take] = short.cpu().numpy()[take]
    lengths[take] = length.cpu().numpy()[take]
    return paths, lengths, feasible | take


def restart_choice(feasible: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[F] the lane kept for each failed problem from its lanes' results
    [F, R]: the shortest feasible, the first of equals; -1 where none is."""
    score = np.where(feasible, lengths, np.inf)
    best = np.argmin(score, axis=1)
    return np.where(feasible.any(axis=1), best, -1)
