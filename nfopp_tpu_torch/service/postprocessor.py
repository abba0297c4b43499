"""Path postprocessing for execution by a controller (port of
`nfopp_tpu/service/postprocessor.py`, host numpy/scipy code).

Same pipeline as the reference's ros/path_postprocessor.py:13-69: drop
near-duplicate waypoints, resample at a fixed distance step with quadratic
interpolation and angle unfolding, and trim an initial direction flip (the
first few waypoints sometimes point backwards while the solver converges).
Operates on plain [N, 3] arrays host-side (runs once per published path).
"""
from __future__ import annotations

import numpy as np
import scipy.interpolate

from ..utils.host_math import unfold_angles, wrap_angles

__all__ = ["PathPostprocessor"]


class PathPostprocessor:
    def __init__(self, minimal_distance: float = 0.001, distance_step: float = 0.05):
        self.minimal_distance = minimal_distance
        self.distance_step = distance_step

    def process(self, trajectory: np.ndarray) -> np.ndarray:
        """[N, 3] -> [M, 3] resampled path (M ~ length / distance_step)."""
        trajectory = np.asarray(trajectory, dtype=np.float64)
        if len(trajectory) < 3:
            return trajectory
        trajectory = self._drop_duplicates(trajectory)
        if len(trajectory) < 3:
            # the whole path collapsed to (near-)coincident endpoints —
            # e.g. a fleet robot already at its goal; nothing to resample
            return trajectory
        seg = np.linalg.norm(np.diff(trajectory[:, :2], axis=0), axis=1) + 1e-6
        cum = np.concatenate([np.zeros(1), np.cumsum(seg)])
        parametrization = cum / cum[-1]
        point_count = max(int(cum[-1] / self.distance_step), 2)
        resampled = self._resample(trajectory, parametrization, np.linspace(0, 1, point_count))
        return resampled[self._direction_flip_index(resampled):]

    def _drop_duplicates(self, trajectory: np.ndarray) -> np.ndarray:
        """Walk from the goal backwards keeping points further apart than
        minimal_distance; endpoints always survive (ref :38-47)."""
        kept = [trajectory[-1]]
        previous = trajectory[-1]
        for point in reversed(trajectory[1:-1]):
            if np.linalg.norm(previous[:2] - point[:2]) > self.minimal_distance:
                kept.append(point)
                previous = point
        kept.append(trajectory[0])
        return np.asarray(kept[::-1])

    @staticmethod
    def _resample(trajectory, old_param, new_param) -> np.ndarray:
        trajectory = trajectory.copy()
        trajectory[:, 2] = unfold_angles(trajectory[:, 2])
        # quadratic needs >= 3 support points; degrade gracefully instead
        # of raising if a caller hands a 2-point path directly
        kind = "quadratic" if len(trajectory) >= 3 else "linear"
        interp = scipy.interpolate.interp1d(
            old_param, trajectory, kind=kind, axis=0, fill_value="extrapolate"
        )
        return interp(new_param)

    @staticmethod
    def _direction_flip_index(trajectory: np.ndarray) -> int:
        """First index after an initial backwards-motion prefix (ref :56-69):
        if the motion direction flips within the first 6 waypoints, start the
        path at the flip."""
        delta = np.diff(trajectory[:, :2], axis=0)
        mean_angle = trajectory[:-1, 2] + wrap_angles(np.diff(trajectory[:, 2])) / 2
        forward = np.cos(mean_angle) * delta[:, 0] + np.sin(mean_angle) * delta[:, 1] > 0
        index = 1
        if len(forward) > 0:
            flips = np.nonzero(forward != forward[0])[0]
            if len(flips) > 0 and flips[0] < 6:
                index = max(int(flips[0]), index)
        return index
