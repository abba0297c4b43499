"""Results serialization in the reference's JSON schema (a copy of
`nfopp_tpu/bench/results.py`, so the port writes the same documents).

The reference writes, per run, a JSON document with environment info, settings,
and `plans[name] = {trajectory, path, stats}` (BenchmarkAdapter.cpp
evaluateAndSaveResult:137-149 via bench-mr's Log::log/save), which the
experiment notebooks then merge and plot. This module reproduces that layout so
the notebook-style analysis carries over.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any

import numpy as np

from .metrics import PathStatistics

__all__ = [
    "ResultsLog",
    "serialize_trajectory",
    "encode_grid_rle",
    "decode_grid_rle",
    "grid_environment_info",
]


def serialize_trajectory(path: np.ndarray) -> list[list[float]]:
    """[N, 3] -> [[x, y, theta], ...] (Log::serializeTrajectory shape)."""
    return [[float(x), float(y), float(t)] for x, y, t in np.asarray(path)]


def encode_grid_rle(blocked: np.ndarray) -> dict:
    """Run-length encode a boolean occupancy grid for compact JSON embedding.

    Runs alternate free/occupied over the row-major flattened grid, starting
    with a free run (possibly length 0).
    """
    flat = np.asarray(blocked, bool).ravel()
    # boundaries where the value changes
    change = np.flatnonzero(np.diff(flat.astype(np.int8))) + 1
    edges = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(edges).tolist()
    if flat.size and flat[0]:
        runs = [0] + runs
    return {"shape": list(blocked.shape), "runs": runs}


def decode_grid_rle(encoded: dict) -> np.ndarray:
    """Inverse of encode_grid_rle -> bool[H, W]."""
    shape = tuple(encoded["shape"])
    runs = encoded["runs"]
    values = np.zeros(sum(runs), bool)
    pos, occupied = 0, False
    for r in runs:
        if occupied:
            values[pos : pos + r] = True
        pos += r
        occupied = not occupied
    return values.reshape(shape)


def grid_environment_info(blocked: np.ndarray, resolution: float,
                          origin, start, goal) -> dict:
    """Self-contained per-run environment record so analysis tooling can
    redraw the world without re-generating the scenario (the reference's
    notebooks re-run the bench-mr generator from settings instead)."""
    return {
        "type": "grid",
        "resolution": float(resolution),
        "origin": [float(origin[0]), float(origin[1])],
        "start": [float(v) for v in np.asarray(start)],
        "goal": [float(v) for v in np.asarray(goal)],
        "occupancy": encode_grid_rle(blocked),
    }


class ResultsLog:
    """Accumulates runs, then saves one JSON document per run list."""

    def __init__(self, environment_info: dict[str, Any] | None = None,
                 settings: dict[str, Any] | None = None):
        self.environment_info = environment_info or {}
        self.settings = settings or {}
        self.runs: list[dict] = []

    def log_run(self, name: str, path: np.ndarray, stats: PathStatistics,
                extra: dict | None = None,
                environment: dict | None = None) -> dict:
        entry = {
            "environment": environment if environment is not None else self.environment_info,
            "settings": self.settings,
            "plans": {
                name: {
                    "trajectory": serialize_trajectory(path),
                    "path": serialize_trajectory(path),
                    "stats": stats.as_dict(),
                }
            },
        }
        if extra:
            entry.update(extra)
        self.runs.append(entry)
        return entry

    def save(self, log_file: str | pathlib.Path) -> pathlib.Path:
        """Write `{"runs": [...]}` (+ timestamp) to log_file, mkdir as needed."""
        path = pathlib.Path(log_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        document = {"timestamp": time.time(), "runs": self.runs}
        path.write_text(json.dumps(document, indent=2))
        return path

    @staticmethod
    def load(log_file: str | pathlib.Path) -> dict:
        return json.loads(pathlib.Path(log_file).read_text())
