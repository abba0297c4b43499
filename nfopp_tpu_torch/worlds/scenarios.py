"""Benchmark scenario worlds: generators + MovingAI map loading (port of
`nfopp_tpu/worlds/scenarios.py`).

Pure-array replacements for the bench-mr C++ environment generators the reference
binds to (BenchmarkAdapter.cpp:27-40: MovingAI scenario loader, generated
corridor / random grids). Each scenario yields an occupancy grid + bounds +
start/goal, convertible to a device `GridOracle`. Robot footprints are folded
into the grid by binary dilation (host-side, once per scenario), so the hot
loop stays a pure bitmap lookup.

The generators are numpy and draw from `np.random.RandomState` exactly as the
JAX version does, so the same seeds give the same worlds and poses. Only
`distant_endpoints` touches a device: its wavefront distance fields run on
the `device` the caller names (`distance_field` matches JAX's bit for bit on
any device, so the poses do not depend on it). A suite's preparation is
host work, so the callers in this repository build on the CPU.

Suites mirror the reference experiments (SURVEY.md §6): corridor 100x100
(branches=100, radius=3), random grid 100x100 (obstacle_ratio=0.03), MovingAI
maps (e.g. Berlin_0_256).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import check_device
from .oracle import GridOracle

__all__ = [
    "GridScenario",
    "random_forest",
    "corridor",
    "polygon_world",
    "warehouse",
    "warehouse_polygons",
    "parse_movingai_map",
    "parse_movingai_scen",
    "dilate",
    "random_free_pose",
    "distant_endpoints",
    "with_endpoints",
    "resample_distant_endpoints",
]


@dataclass(frozen=True)
class GridScenario:
    """An occupancy-grid world. blocked[i, j]: row i = y cell, col j = x cell."""

    blocked: np.ndarray  # [H, W] bool
    resolution: float  # world units per cell
    origin: tuple[float, float] = (0.0, 0.0)  # world coords of cell (0, 0) corner
    start: np.ndarray | None = None  # [3] optional suggested endpoints
    goal: np.ndarray | None = None

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        h, w = self.blocked.shape
        ox, oy = self.origin
        return (ox, ox + w * self.resolution, oy, oy + h * self.resolution)

    def oracle(self, footprint_radius: float = 0.0, device="cuda") -> GridOracle:
        """Device oracle of this one world (leaves with a leading axis of 1);
        a disc footprint is folded in by grid dilation."""
        device = check_device(device, "GridScenario.oracle")
        blocked = self.blocked
        if footprint_radius > 0:
            blocked = dilate(blocked, int(np.ceil(footprint_radius / self.resolution)))

        def f32(value):
            return torch.tensor(np.asarray(value, np.float32), device=device)[None]

        return GridOracle(
            occupancy=torch.tensor(np.asarray(blocked, bool), device=device)[None],
            origin=f32(self.origin),  # world (x, y) corner
            resolution=f32(self.resolution),
            bounds=f32(self.bounds),
        )


def dilate(blocked: np.ndarray, radius_cells: int) -> np.ndarray:
    """Binary dilation with a disc structuring element (numpy shifts only)."""
    if radius_cells <= 0:
        return blocked
    out = blocked.copy()
    r = radius_cells
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            if di * di + dj * dj > r * r or (di == 0 and dj == 0):
                continue
            shifted = np.zeros_like(blocked)
            src_i = slice(max(0, -di), blocked.shape[0] - max(0, di))
            dst_i = slice(max(0, di), blocked.shape[0] - max(0, -di))
            src_j = slice(max(0, -dj), blocked.shape[1] - max(0, dj))
            dst_j = slice(max(0, dj), blocked.shape[1] - max(0, -dj))
            shifted[dst_i, dst_j] = blocked[src_i, src_j]
            out |= shifted
    return out


def random_free_pose(rng: np.random.RandomState, scenario: GridScenario,
                     margin_cells: int = 2, clearance_cells: int = 2) -> np.ndarray:
    """[3] pose at a uniformly random free cell center with random heading.

    clearance_cells dilates obstacles before sampling so the pose stays valid
    for robots with a footprint up to that radius (endpoints inside the
    dilated zone would make the problem unsolvable — the reference's exit-3/4
    situation)."""
    blocked = dilate(scenario.blocked, clearance_cells)
    free_i, free_j = np.where(~blocked)
    keep = (
        (free_i >= margin_cells)
        & (free_i < blocked.shape[0] - margin_cells)
        & (free_j >= margin_cells)
        & (free_j < blocked.shape[1] - margin_cells)
    )
    free_i, free_j = free_i[keep], free_j[keep]
    k = rng.randint(len(free_i))
    ox, oy = scenario.origin
    x = ox + (free_j[k] + 0.5) * scenario.resolution
    y = oy + (free_i[k] + 0.5) * scenario.resolution
    return np.array([x, y, rng.uniform(-np.pi, np.pi)], np.float32)


def distant_endpoints(
    rng: np.random.RandomState,
    scenario: GridScenario,
    min_geodesic: float,
    clearance_cells: int = 2,
    margin_cells: int = 2,
    goal_tries: int = 8,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """(start, goal) poses at least min_geodesic apart along the grid geodesic.

    bench-mr's generated corridor/grid experiments put endpoints far apart in
    the network (the reference's recorded corridor runs have path lengths
    ~170 on 100x100 worlds); plain uniform free-cell draws mostly produce
    nearby pairs. One wavefront distance field per candidate goal scores every
    start cell at once; distances are measured on the clearance-dilated grid
    so a connected path with that clearance exists. The fields run on
    `device`, one per candidate goal, between the draws from `rng` (whose
    order decides the poses).
    """
    from ..astar.wavefront import distance_field

    device = check_device(device, "distant_endpoints")
    blocked = dilate(scenario.blocked, clearance_cells)
    grid = torch.tensor(blocked, device=device)[None]
    free_i, free_j = np.where(~blocked)
    keep = (
        (free_i >= margin_cells)
        & (free_i < blocked.shape[0] - margin_cells)
        & (free_j >= margin_cells)
        & (free_j < blocked.shape[1] - margin_cells)
    )
    free_i, free_j = free_i[keep], free_j[keep]
    ox, oy = scenario.origin

    def pose(i: int, j: int) -> np.ndarray:
        return np.array(
            [
                ox + (j + 0.5) * scenario.resolution,
                oy + (i + 0.5) * scenario.resolution,
                rng.uniform(-np.pi, np.pi),
            ],
            np.float32,
        )

    best = None  # (distance, start_cell, goal_cell) fallback if min not met
    for _ in range(goal_tries):
        g = rng.randint(len(free_i))
        gi, gj = int(free_i[g]), int(free_j[g])
        dist = distance_field(grid, torch.tensor([[gi, gj]]))[0].cpu().numpy()
        cand = dist[free_i, free_j] * scenario.resolution
        reachable = np.isfinite(cand) & (cand < 1e30)
        far = reachable & (cand >= min_geodesic)
        if far.any():
            s = rng.choice(np.where(far)[0])
            return pose(int(free_i[s]), int(free_j[s])), pose(gi, gj)
        if reachable.any():
            s = int(np.argmax(np.where(reachable, cand, -np.inf)))
            d = float(cand[s])
            if best is None or d > best[0]:
                best = (d, (int(free_i[s]), int(free_j[s])), (gi, gj))
    if best is None:
        raise ValueError("no reachable endpoint pair found")
    (si, sj), (gi, gj) = best[1], best[2]
    return pose(si, sj), pose(gi, gj)


def with_endpoints(scenario: GridScenario, start: np.ndarray,
                   goal: np.ndarray) -> GridScenario:
    """Copy of a scenario with replaced suggested endpoints."""
    return GridScenario(
        scenario.blocked, scenario.resolution, scenario.origin, start, goal
    )


def resample_distant_endpoints(
    scenarios: list[GridScenario], min_geodesic: float, device="cuda",
) -> list[GridScenario]:
    """Endpoint pairs at least min_geodesic apart for a whole suite.

    THE canonical resampling for every suite script (run_benchmark.py,
    run_gpmp2.py, compare_suites.py): the per-scenario RNG is seeded
    1000 + index, so two scripts given the same scenario list and the same
    min_geodesic plan the exact same problems — cross-script parity claims
    depend on this staying in one place. The port's resampling gives the
    JAX version's poses bit for bit, on any `device`.
    """
    if min_geodesic <= 0:
        return scenarios
    return [
        with_endpoints(
            sc, *distant_endpoints(
                np.random.RandomState(1000 + s), sc, min_geodesic, device=device
            )
        )
        for s, sc in enumerate(scenarios)
    ]


def random_forest(
    seed: int, size: tuple[int, int] = (100, 100), obstacle_ratio: float = 0.03,
    resolution: float = 1.0,
) -> GridScenario:
    """Uniform random single-cell obstacles (bench-mr 'random grid' world)."""
    rng = np.random.RandomState(seed)
    blocked = rng.rand(*size) < obstacle_ratio
    scenario = GridScenario(blocked=blocked, resolution=resolution)
    rng2 = np.random.RandomState(seed + 1)
    start = random_free_pose(rng2, scenario)
    goal = random_free_pose(rng2, scenario)
    return GridScenario(blocked, resolution, scenario.origin, start, goal)


def corridor(
    seed: int, size: int = 100, branches: int = 100, radius: int = 3,
    resolution: float = 1.0,
) -> GridScenario:
    """Random connected corridor network carved from solid rock (bench-mr
    'corridor' world style): from random points on the existing corridor, carve
    axis-aligned segments of width 2*radius."""
    rng = np.random.RandomState(seed)
    blocked = np.ones((size, size), bool)

    def carve(i0, j0, i1, j1):
        lo_i, hi_i = sorted((i0, i1))
        lo_j, hi_j = sorted((j0, j1))
        blocked[
            max(0, lo_i - radius) : min(size, hi_i + radius + 1),
            max(0, lo_j - radius) : min(size, hi_j + radius + 1),
        ] = False

    # seed corridor in the middle
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

    scenario = GridScenario(blocked=blocked, resolution=resolution)
    rng2 = np.random.RandomState(seed + 1)
    start = random_free_pose(rng2, scenario)
    goal = random_free_pose(rng2, scenario)
    return GridScenario(blocked, resolution, scenario.origin, start, goal)


def polygon_world(
    polygons: list[np.ndarray],
    bounds: tuple[float, float, float, float],
    resolution: float = 0.5,
    start: np.ndarray | None = None,
    goal: np.ndarray | None = None,
    mode: str = "union",
) -> GridScenario:
    """Rasterize polygonal obstacles into a grid world (the bench-mr polygon/
    'warehouse' environment family). Each polygon is a [K, 2] vertex loop;
    cells whose centers fall inside (even-odd per loop) are blocked.
    mode='union' ORs the loops (separate obstacles); mode='evenodd' XORs them
    (a loop inside another cuts a hole).
    """
    if mode not in ("union", "evenodd"):
        raise ValueError(f"unknown mode {mode!r}")
    xmin, xmax, ymin, ymax = bounds
    w = int(round((xmax - xmin) / resolution))
    h = int(round((ymax - ymin) / resolution))
    xs = xmin + (np.arange(w) + 0.5) * resolution
    ys = ymin + (np.arange(h) + 0.5) * resolution
    gx, gy = np.meshgrid(xs, ys)  # [h, w]
    blocked = np.zeros((h, w), bool)
    for poly in polygons:
        poly = np.asarray(poly, np.float64)
        inside = np.zeros((h, w), bool)
        x0, y0 = poly[-1]
        for x1, y1 in poly:
            # even-odd ray cast along +x
            crosses = ((y0 > gy) != (y1 > gy)) & (
                gx < (x1 - x0) * (gy - y0) / (y1 - y0 + 1e-30) + x0
            )
            inside ^= crosses
            x0, y0 = x1, y1
        if mode == "union":
            blocked |= inside
        else:
            blocked ^= inside
    return GridScenario(
        blocked=blocked, resolution=resolution, origin=(xmin, ymin),
        start=None if start is None else np.asarray(start, np.float32),
        goal=None if goal is None else np.asarray(goal, np.float32),
    )


def warehouse_polygons(
    seed: int,
    width: float = 120.0,
    height: float = 80.0,
) -> list[np.ndarray]:
    """The warehouse world's TRUE polygon geometry ([K, 2] vertex loops) —
    exposed so exact-geometry oracles (worlds.oracle.PolygonOracle) can check
    against the real obstacles, not a rasterization (the reference's polygon
    worlds are evaluated exactly, BenchmarkAdapter.cpp:175-187)."""
    rng = np.random.RandomState(seed)
    polys: list[np.ndarray] = []
    perimeter = 6.0  # free aisle along the walls
    rack_depth = 3.0

    def rect(x0, y0, x1, y1):
        return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)

    y = perimeter + rng.uniform(0.0, 2.0)
    while y + rack_depth <= height - perimeter:
        x = perimeter
        while x < width - perimeter - 6.0:
            seg = rng.uniform(12.0, 26.0)
            x1 = min(x + seg, width - perimeter)
            if x1 - x >= 4.0:
                polys.append(rect(x, y, x1, y + rack_depth))
            x = x1 + rng.uniform(4.0, 7.0)  # cross-aisle gap
        y += rack_depth + rng.uniform(4.0, 6.0)  # main aisle

    # a few freestanding pallet stacks dropped in the aisles
    shelves = list(polys)
    for _ in range(rng.randint(3, 7)):
        px = rng.uniform(perimeter, width - perimeter - 2.0)
        py = rng.uniform(perimeter, height - perimeter - 2.0)
        pallet = rect(px, py, px + rng.uniform(1.0, 2.0), py + rng.uniform(1.0, 2.0))
        if not any(
            (pallet[0, 0] < s[1, 0] + 2.0 and pallet[1, 0] > s[0, 0] - 2.0
             and pallet[0, 1] < s[2, 1] + 2.0 and pallet[2, 1] > s[0, 1] - 2.0)
            for s in shelves
        ):
            polys.append(pallet)
    return polys


def warehouse(
    seed: int,
    width: float = 120.0,
    height: float = 80.0,
    resolution: float = 0.5,
) -> GridScenario:
    """Warehouse shelving world built from polygonal obstacles — the bench-mr
    polygon world class (the reference's only checked-in benchmark fixture:
    'warehouse2.svg', BenchmarkAdapter.cpp:37-40,
    test/test_benchmark/2022-01-14_17-19-42_config.json). The svg lives in a
    non-vendored submodule, so this generates the same structure class at the
    same scale (that config's start (7.5,-10) -> goal (116,-70) spans a
    ~120x80 floor): parallel rack rows with randomized aisle widths, rack
    segments split by cross-aisles, and freestanding pallet blocks — long
    narrow corridors with junctions, rasterized through `polygon_world` (the
    polygon path end-to-end, not a direct grid paint). The true geometry is
    available via `warehouse_polygons(seed, ...)` for exact-oracle solves.
    """
    polys = warehouse_polygons(seed, width, height)
    scenario = polygon_world(polys, (0.0, width, 0.0, height), resolution)
    rng2 = np.random.RandomState(seed + 1)
    start = random_free_pose(rng2, scenario, clearance_cells=3)
    goal = random_free_pose(rng2, scenario, clearance_cells=3)
    return GridScenario(scenario.blocked, resolution, scenario.origin, start, goal)


def parse_movingai_map(text: str, resolution: float = 1.0) -> GridScenario:
    """Parse a MovingAI .map file ('type octile / height / width / map' header;
    '.', 'G', 'S' passable; '@', 'O', 'T', 'W' blocked)."""
    lines = text.strip().splitlines()
    header = {}
    idx = 0
    while idx < len(lines) and lines[idx].strip().lower() != "map":
        parts = lines[idx].split()
        if len(parts) == 2:
            header[parts[0].lower()] = parts[1]
        idx += 1
    height = int(header["height"])
    width = int(header["width"])
    grid_lines = lines[idx + 1 : idx + 1 + height]
    blocked = np.ones((height, width), bool)
    passable = {".", "G", "S"}
    for i, line in enumerate(grid_lines):
        row = np.array([c not in passable for c in line[:width]])
        blocked[i, : len(row)] = row
    return GridScenario(blocked=blocked, resolution=resolution)


def parse_movingai_scen(text: str) -> list[dict]:
    """Parse a MovingAI .scen file into dicts with map name, start, goal cells."""
    entries = []
    for line in text.strip().splitlines():
        if line.lower().startswith("version"):
            continue
        parts = line.split()
        if len(parts) < 9:
            continue
        entries.append(
            {
                "bucket": int(parts[0]),
                "map": parts[1],
                "width": int(parts[2]),
                "height": int(parts[3]),
                "start_x": int(parts[4]),
                "start_y": int(parts[5]),
                "goal_x": int(parts[6]),
                "goal_y": int(parts[7]),
                "optimal_length": float(parts[8]),
            }
        )
    return entries
