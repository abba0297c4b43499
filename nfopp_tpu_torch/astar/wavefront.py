"""Batched grid shortest paths on the device: min-plus wavefront relaxation
(port of `nfopp_tpu/astar/wavefront.py`).

A Dijkstra distance field is computed by iterating the 8-neighbour min-plus
relaxation

    dist <- min(dist, shift_k(dist) + cost_k)        (k over 8 directions)

on a batch of occupancy grids [B, H, W] at once (JAX vmaps an unbatched
function; here every function takes the leading problem axis). The path is
then extracted by greedy steepest descent from the start cell and resampled
to the solver's trajectory length by arc-length interpolation.

This is plain PyTorch, as the JAX version is plain XLA (no Pallas kernel):
each sweep is about 20 elementwise launches, H + W sweeps per field. The
arithmetic is the JAX version's, so results agree bit for bit: the same
finite sentinel `_INF` (not inf, so `_INF + _INF` stays finite), the same
neighbour order and the same f32 sums; `jnp.roll` plus an edge mask becomes
slicing of an `_INF`-padded copy, which gives every cell the same minimum
(a wrapped or padded neighbour never wins). Only exact operations (adds,
mins, IEEE division and square root, comparisons) and a sequential cumulative
sum are used, so a CUDA run equals a CPU run bit for bit.

Cost model matches the host A* (`grid_search.py`): 1 per orthogonal step,
sqrt(2) per diagonal, obstacles impassable.
"""
from __future__ import annotations

import torch

from ..ops.math import linspace

__all__ = ["distance_field", "extract_path", "wavefront_path"]

_INF = 3.0e38 / 4

# (di, dj, cost) for the 8-connected neighbourhood, in the JAX version's order
_STEPS = [
    (-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
    (-1, -1, 1.4142135), (-1, 1, 1.4142135), (1, -1, 1.4142135), (1, 1, 1.4142135),
]


def _cells(cells: torch.Tensor, h: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, col) int64 index tensors of cells [..., 2], clamped into the grid
    (JAX's gathers clamp out-of-range indices)."""
    cells = cells.to(torch.int64)
    return torch.clamp(cells[..., 0], 0, h - 1), torch.clamp(cells[..., 1], 0, w - 1)


def distance_field(
    blocked: torch.Tensor, goal_cell: torch.Tensor, num_iterations: int | None = None
) -> torch.Tensor:
    """[B, H, W] geodesic distance of every cell of grids `blocked` [B, H, W]
    to `goal_cell` [B, 2] (row, col); the finite sentinel `_INF` (~7.5e37)
    marks unreachable cells: test `d > 1e30`, not `isfinite`.

    num_iterations bounds the propagation front; default H + W covers any
    simple path's relaxation count. A goal cell outside the grid sets no
    zero (JAX drops the out-of-range scatter): the field stays `_INF`.
    """
    batch, h, w = blocked.shape
    if num_iterations is None:
        num_iterations = h + w
    device = blocked.device
    blocked_f = torch.where(blocked.bool(), _INF, 0.0).to(torch.float32)
    dist = torch.full((batch, h, w), _INF, dtype=torch.float32, device=device)
    goal_cell = goal_cell.to(device=device, dtype=torch.int64)
    inside = ((goal_cell[:, 0] >= 0) & (goal_cell[:, 0] < h)
              & (goal_cell[:, 1] >= 0) & (goal_cell[:, 1] < w))
    gi, gj = _cells(goal_cell, h, w)
    rows = torch.arange(batch, device=device)
    dist[rows, gi, gj] = torch.where(inside, 0.0, _INF)

    padded = torch.full((batch, h + 2, w + 2), _INF, dtype=torch.float32, device=device)
    shifted = torch.empty_like(dist)
    for _ in range(num_iterations):
        padded[:, 1:-1, 1:-1] = dist
        best = dist.clone()
        for di, dj, cost in _STEPS:
            # jnp.roll(dist, (di, dj))[i, j] = dist[i - di, j - dj]
            torch.add(padded[:, 1 - di:1 - di + h, 1 - dj:1 - dj + w], cost, out=shifted)
            torch.minimum(best, shifted, out=best)
        # obstacles stay unreachable
        dist = torch.minimum(dist, best.add_(blocked_f))
    return dist


def extract_path(
    dist: torch.Tensor, start_cell: torch.Tensor, max_steps: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy steepest-descent walks start -> goal on distance fields
    [B, H, W] from `start_cell` [B, 2].

    Returns (cells [B, max_steps+1, 2] int32, valid [B, max_steps+1] bool).
    Each step moves to the first of the 8 neighbours (in `_STEPS` order) with
    the least distance, if it is less than the current cell's; once the goal
    (dist == 0) is reached, or no neighbour is better, the walk stays put and
    further entries are flagged invalid.
    """
    batch, h, w = dist.shape
    if max_steps is None:
        max_steps = h + w
    device = dist.device
    steps = torch.tensor([(di, dj) for di, dj, _ in _STEPS], dtype=torch.int64, device=device)
    flat = dist.reshape(batch, h * w)

    def at(cells):
        i, j = _cells(cells, h, w)
        return torch.gather(flat, 1, (i * w + j).reshape(batch, -1)).reshape(i.shape)

    cell = start_cell.to(device=device, dtype=torch.int64)
    arrived = torch.zeros(batch, dtype=torch.bool, device=device)
    cells, valid = [cell], [torch.ones(batch, dtype=torch.bool, device=device)]
    for _ in range(max_steps):
        ni, nj = _cells(cell[:, None, :] + steps, h, w)  # [B, 8]
        nd = at(torch.stack([ni, nj], dim=-1))
        k = torch.argmin(nd, dim=1, keepdim=True)  # the first least neighbour
        better = torch.gather(nd, 1, k)[:, 0] < at(cell)
        move = better & ~arrived
        chosen = torch.cat([torch.gather(ni, 1, k), torch.gather(nj, 1, k)], dim=1)
        cell = torch.where(move[:, None], chosen, cell)
        arrived = arrived | (at(cell) <= 0.0) | ~better
        cells.append(cell)
        valid.append(move)
    return torch.stack(cells, dim=1).to(torch.int32), torch.stack(valid, dim=1)


def wavefront_path(
    blocked: torch.Tensor,
    start_cell: torch.Tensor,
    goal_cell: torch.Tensor,
    num_points: int,
    origin: torch.Tensor,
    resolution: torch.Tensor,
    num_iterations: int | None = None,
) -> torch.Tensor:
    """End to end on a batch: distance field -> greedy path -> world coords
    -> [B, num_points, 2] arc-length resample. `origin` [B, 2] and the cell
    coordinates share one (row, col) order; `resolution` [B]."""
    dist = distance_field(blocked, goal_cell, num_iterations)
    cells, _ = extract_path(dist, start_cell)
    # world coordinates of cell centres; repeated trailing cells (post-arrival)
    # become zero-length segments and vanish under arc-length resampling
    res = resolution.to(torch.float32).reshape(-1, 1, 1)
    world = origin.to(torch.float32)[:, None, :] + (cells.to(torch.float32) + 0.5) * res
    diff = world[:, 1:] - world[:, :-1]
    seg = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    # a sequential sum, the same on every device
    running = [torch.zeros_like(seg[:, 0])]
    for k in range(seg.shape[1]):
        running.append(running[-1] + seg[:, k])
    cum = torch.stack(running, dim=1)
    total = torch.clamp(cum[:, -1], min=1e-6)
    zero = torch.zeros_like(total)
    targets = linspace(zero, torch.ones_like(total), num_points) * total[:, None]
    idx = torch.clamp(torch.searchsorted(cum, targets) - 1, 0, cum.shape[1] - 2)
    lo, hi = torch.gather(cum, 1, idx), torch.gather(cum, 1, idx + 1)
    denom = torch.clamp(hi - lo, min=1e-6)
    t = torch.clamp((targets - lo) / denom, 0.0, 1.0)[..., None]
    index = idx[..., None].expand(-1, -1, 2)
    a, b = torch.gather(world, 1, index), torch.gather(world, 1, index + 1)
    return a * (1.0 - t) + b * t
