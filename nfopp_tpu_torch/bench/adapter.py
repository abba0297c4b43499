"""BenchmarkAdapter — API-parity facade over scenario worlds + metrics
(port of `nfopp_tpu/bench/adapter.py`).

Mirrors the surface of the reference's Python benchmark adapter
(benchmark_adapter/benchmark_adapter.py:6-33 wrapping the C++ pybind11 module):
start/goal/bounds accessors, pose collision queries, path evaluation, and
evaluate-and-save in the reference results schema — but backed by the
array scenario stack (GridScenario + device oracle + native metrics) instead
of OMPL. The oracle lives on `device` ("cuda" unless the caller asks for the
CPU); the queries take and return numpy.
"""
from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

from ..solver.tracking import evaluate_path as device_eval
from ..utils.position2 import Position2
from ..worlds.oracle import grid_collision
from ..worlds.scenarios import GridScenario
from .metrics import path_statistics
from .results import ResultsLog

__all__ = ["BenchmarkAdapter", "BenchmarkCollisionChecker"]


class BenchmarkAdapter:
    def __init__(
        self,
        scenario: GridScenario,
        footprint_radius: float = 0.0,
        log_file: str | pathlib.Path = "nfopp_benchmark_results.json",
        samples_per_segment: int = 5,
        device="cuda",
    ):
        self.scenario = scenario
        self.oracle = scenario.oracle(footprint_radius, device)
        self.device = self.oracle.occupancy.device
        self.log_file = pathlib.Path(log_file)
        self.samples_per_segment = samples_per_segment
        self._t_start = time.time()
        occupied = np.argwhere(scenario.blocked)
        ox, oy = scenario.origin
        self._obstacle_points = (
            np.stack(
                [
                    ox + (occupied[:, 1] + 0.5) * scenario.resolution,
                    oy + (occupied[:, 0] + 0.5) * scenario.resolution,
                ],
                axis=1,
            )
            if len(occupied)
            else np.zeros((0, 2))
        )
        self._log = ResultsLog(
            environment_info={
                "type": "grid",
                "shape": list(scenario.blocked.shape),
                "resolution": scenario.resolution,
            }
        )

    def _poses(self, positions) -> torch.Tensor:
        """[P, >=2] numpy poses -> [1, P, d] f32 on the oracle's device."""
        return torch.tensor(np.asarray(positions, np.float32), device=self.device)[None]

    # ------------------------------------------------- reference interface

    def start(self) -> Position2:
        return Position2.from_vec(self.scenario.start)

    def goal(self) -> Position2:
        return Position2.from_vec(self.scenario.goal)

    def bounds(self) -> tuple[float, float, float, float]:
        return self.scenario.bounds

    def is_collision(self, position: Position2) -> bool:
        vec = np.atleast_2d(position.as_vec())
        return bool(grid_collision(self.oracle, self._poses(vec)).any())

    def collides_positions(self, positions: np.ndarray) -> np.ndarray:
        return grid_collision(self.oracle, self._poses(positions))[0].cpu().numpy()

    def evaluate_path(self, path: np.ndarray) -> tuple[bool, float]:
        """(collides, xy length) of the densely interpolated path
        (ref BenchmarkAdapter.cpp evaluatePath:201-208)."""
        collides, length = device_eval(grid_collision, self.oracle, self._poses(path),
                                       self.samples_per_segment)
        return bool(collides[0]), float(length[0])

    def evaluate_and_save_results(self, path: np.ndarray, name: str) -> pathlib.Path:
        """Full PathStatistics + reference-schema JSON (ref
        evaluateAndSaveResult, BenchmarkAdapter.cpp:137-149)."""
        collides, _ = self.evaluate_path(path)
        stats = path_statistics(
            path,
            obstacles=self._obstacle_points,
            collides=collides,
            planner=name,
            planning_time=time.time() - self._t_start,
            goal=self.scenario.goal,
        )
        self._log.log_run(name, np.asarray(path), stats)
        return self._log.save(self.log_file)


class BenchmarkCollisionChecker:
    """Oracle facade matching the reference's BenchmarkCollisionChecker
    (benchmark_adapter/benchmark_collision_checker.py:6-12): a CollisionChecker
    backed by the benchmark environment."""

    def __init__(self, benchmark: BenchmarkAdapter):
        self.benchmark = benchmark

    def check_collision(self, positions) -> np.ndarray:
        if isinstance(positions, Position2):
            positions = np.atleast_2d(positions.as_vec())
        return self.benchmark.collides_positions(np.asarray(positions, np.float32))

    def get_boundaries(self):
        return self.benchmark.bounds()
