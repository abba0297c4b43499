"""Grid shortest-path search on occupancy matrices (host-side, numpy + heapq).

Covers the reference's `astar/jps.py` capability (A* and jump-point search on
an 8-connected grid, euclidean/manhattan heuristics, sqrt(2) diagonal cost)
with a flat-array design instead of per-cell Python objects. Runs once per
problem at initialization time — the batched device-side counterpart is
`nfopp_tpu_torch.astar.wavefront`. A copy of `nfopp_tpu/astar/grid_search.py`.

Grid convention: `blocked[i, j]` is True for obstacles; paths are sequences of
(row, col) cells.
"""
from __future__ import annotations

import heapq
import math

import numpy as np

__all__ = ["astar", "jump_point_search", "GridSearch"]

_ORTHO = ((-1, 0), (1, 0), (0, -1), (0, 1))
_DIAG = ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _heuristic(name: str):
    if name == "euclidean":
        return lambda a, b: math.hypot(a[0] - b[0], a[1] - b[1])
    if name == "manhattan":
        return lambda a, b: abs(a[0] - b[0]) + abs(a[1] - b[1])
    raise ValueError(f"unknown heuristic {name!r}")


class GridSearch:
    """A*/JPS over a boolean occupancy grid."""

    def __init__(
        self,
        blocked: np.ndarray,
        use_diagonals: bool = True,
        diagonal_cost: float = math.sqrt(2.0),
        jps: bool = False,
        heuristic: str = "euclidean",
    ):
        self.blocked = np.asarray(blocked, dtype=bool)
        self.use_diagonals = use_diagonals
        self.diagonal_cost = diagonal_cost
        self.jps = jps
        self.h = _heuristic(heuristic)
        self.expanded = 0

    # ------------------------------------------------------------ basics

    def _free(self, i: int, j: int) -> bool:
        h, w = self.blocked.shape
        return 0 <= i < h and 0 <= j < w and not self.blocked[i, j]

    def find_path(self, start: tuple[int, int], goal: tuple[int, int]) -> np.ndarray:
        """[L, 2] array of (row, col) cells from start to goal (inclusive).

        Raises ValueError when no path exists or endpoints are blocked.
        """
        start, goal = tuple(start), tuple(goal)
        if not self._free(*start):
            raise ValueError(f"start cell {start} is blocked or out of bounds")
        if not self._free(*goal):
            raise ValueError(f"goal cell {goal} is blocked or out of bounds")
        came_from = self._jps_search(start, goal) if self.jps else self._astar_search(start, goal)
        if came_from is None:
            raise ValueError(f"no path from {start} to {goal}")
        # walk back, expanding JPS jumps into unit steps via line segments
        cells = [goal]
        node = goal
        while node != start:
            node = came_from[node]
            cells.append(node)
        cells.reverse()
        return self._densify(cells)

    def _densify(self, cells: list[tuple[int, int]]) -> np.ndarray:
        """JPS parents can be several cells apart along a straight/diagonal
        line; expand to unit steps so downstream resampling sees the geometry."""
        out = [cells[0]]
        for a, b in zip(cells[:-1], cells[1:]):
            di = np.sign(b[0] - a[0])
            dj = np.sign(b[1] - a[1])
            i, j = a
            while (i, j) != b:
                i += di
                j += dj
                out.append((i, j))
        return np.asarray(out, dtype=np.int64)

    # --------------------------------------------------------------- A*

    def _neighbors(self, i: int, j: int):
        for di, dj in _ORTHO:
            if self._free(i + di, j + dj):
                yield (i + di, j + dj), 1.0
        if self.use_diagonals:
            for di, dj in _DIAG:
                if self._free(i + di, j + dj):
                    yield (i + di, j + dj), self.diagonal_cost

    def _astar_search(self, start, goal):
        g = {start: 0.0}
        came_from: dict = {}
        counter = 0
        heap = [(self.h(start, goal), counter, start)]
        closed = set()
        while heap:
            _, _, node = heapq.heappop(heap)
            if node in closed:
                continue
            closed.add(node)
            self.expanded += 1
            if node == goal:
                return came_from
            for nbr, cost in self._neighbors(*node):
                tentative = g[node] + cost
                if tentative < g.get(nbr, math.inf):
                    g[nbr] = tentative
                    came_from[nbr] = node
                    counter += 1
                    heapq.heappush(heap, (tentative + self.h(nbr, goal), counter, nbr))
        return None

    # -------------------------------------------------------------- JPS

    def _jps_search(self, start, goal):
        """Jump point search: A* where successors are jump points."""
        g = {start: 0.0}
        came_from: dict = {}
        counter = 0
        heap = [(self.h(start, goal), counter, start)]
        closed = set()
        while heap:
            _, _, node = heapq.heappop(heap)
            if node in closed:
                continue
            closed.add(node)
            self.expanded += 1
            if node == goal:
                return came_from
            parent = came_from.get(node)
            for direction in self._pruned_directions(node, parent):
                jp = self._jump(node, direction, goal)
                if jp is None:
                    continue
                dist = math.hypot(jp[0] - node[0], jp[1] - node[1])
                tentative = g[node] + dist
                if tentative < g.get(jp, math.inf):
                    g[jp] = tentative
                    came_from[jp] = node
                    counter += 1
                    heapq.heappush(heap, (tentative + self.h(jp, goal), counter, jp))
        return None

    def _pruned_directions(self, node, parent):
        """Natural + forced movement directions from `node` given its parent."""
        if parent is None:
            dirs = list(_ORTHO)
            if self.use_diagonals:
                dirs += list(_DIAG)
            return dirs
        di = int(np.sign(node[0] - parent[0]))
        dj = int(np.sign(node[1] - parent[1]))
        i, j = node
        dirs = []
        if di != 0 and dj != 0:  # diagonal move
            if self._free(i + di, j):
                dirs.append((di, 0))
            if self._free(i, j + dj):
                dirs.append((0, dj))
            if self._free(i + di, j + dj):
                dirs.append((di, dj))
            # forced neighbors
            if not self._free(i - di, j) and self._free(i - di, j + dj):
                dirs.append((-di, dj))
            if not self._free(i, j - dj) and self._free(i + di, j - dj):
                dirs.append((di, -dj))
        elif di != 0:  # vertical
            if self._free(i + di, j):
                dirs.append((di, 0))
            if not self._free(i, j + 1) and self._free(i + di, j + 1):
                dirs.append((di, 1))
            if not self._free(i, j - 1) and self._free(i + di, j - 1):
                dirs.append((di, -1))
        else:  # horizontal
            if self._free(i, j + dj):
                dirs.append((0, dj))
            if not self._free(i + 1, j) and self._free(i + 1, j + dj):
                dirs.append((1, dj))
            if not self._free(i - 1, j) and self._free(i - 1, j + dj):
                dirs.append((-1, dj))
        return dirs

    def _jump(self, node, direction, goal):
        """Follow `direction` until a jump point, the goal, or a wall.

        Iterative (no recursion) so arbitrarily large maps can't blow the
        Python stack; diagonal motion probes its straight components, which
        are themselves iterative — max nesting depth 2.
        """
        di, dj = direction
        i, j = node
        while True:
            i += di
            j += dj
            if not self._free(i, j):
                return None
            if (i, j) == goal:
                return (i, j)
            if di != 0 and dj != 0:
                # forced neighbor for diagonal motion
                if (not self._free(i - di, j) and self._free(i - di, j + dj)) or (
                    not self._free(i, j - dj) and self._free(i + di, j - dj)
                ):
                    return (i, j)
                # a straight component reaching a jump point makes this one
                if self._jump((i, j), (di, 0), goal) is not None:
                    return (i, j)
                if self._jump((i, j), (0, dj), goal) is not None:
                    return (i, j)
            elif di != 0:
                if (not self._free(i, j + 1) and self._free(i + di, j + 1)) or (
                    not self._free(i, j - 1) and self._free(i + di, j - 1)
                ):
                    return (i, j)
            else:
                if (not self._free(i + 1, j) and self._free(i + 1, j + dj)) or (
                    not self._free(i - 1, j) and self._free(i - 1, j + dj)
                ):
                    return (i, j)


def astar(blocked: np.ndarray, start, goal, **kwargs) -> np.ndarray:
    """Plain 8-connected A* path of (row, col) cells."""
    return GridSearch(blocked, jps=False, **kwargs).find_path(start, goal)


def jump_point_search(blocked: np.ndarray, start, goal, **kwargs) -> np.ndarray:
    """Jump-point-search path (same result geometry as A*, fewer expansions)."""
    return GridSearch(blocked, jps=True, **kwargs).find_path(start, goal)
