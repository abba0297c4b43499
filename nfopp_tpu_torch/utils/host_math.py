"""Host-side (numpy/scipy) path geometry used outside the solve loop: A*
initialization, path postprocessing, metrics (a copy of
`nfopp_tpu/utils/host_math.py`, which imports no JAX but sits in a package
that does). Mirrors the reference's `utils/math.py` function inventory; the
device-side torch twins live in `nfopp_tpu_torch.ops.math`."""
from __future__ import annotations

import numpy as np
import scipy.interpolate

__all__ = [
    "wrap_angles",
    "unfold_angles",
    "calculate_curvature",
    "calculate_tangent",
    "find_orthogonal_projection",
    "reparametrize_path",
]


def wrap_angles(angles: np.ndarray) -> np.ndarray:
    """(-pi, pi] wrap (ref utils/math.py:34-35)."""
    return (angles + np.pi) % (2 * np.pi) - np.pi


def unfold_angles(angles: np.ndarray) -> np.ndarray:
    """Remove 2pi jumps to make the sequence continuous (ref :38-43)."""
    angles = wrap_angles(angles)
    delta = angles[1:] - angles[:-1]
    delta = np.where(delta > np.pi, delta - 2 * np.pi, delta)
    delta = np.where(delta < -np.pi, delta + 2 * np.pi, delta)
    return angles[0] + np.concatenate([np.zeros(1), np.cumsum(delta)])


def calculate_curvature(x: np.ndarray, y: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Signed curvature via parametric derivatives (ref :5-10)."""
    dx = np.gradient(x, t)
    dy = np.gradient(y, t)
    d2x = np.gradient(dx, t)
    d2y = np.gradient(dy, t)
    return (dx * d2y - dy * d2x) / (dx**2 + dy**2) ** 1.5


def calculate_tangent(x: np.ndarray, y: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Unfolded tangent-direction angle along a path (ref :46-49)."""
    dx = np.gradient(x, t)
    dy = np.gradient(y, t)
    return unfold_angles(np.arctan2(dy, dx))


def find_orthogonal_projection(
    trajectory: np.ndarray, point: np.ndarray, parametrization: np.ndarray
) -> float:
    """Path parameter of the closest point on a polyline to `point` (ref :13-31):
    min over vertices and over valid orthogonal projections onto segments."""
    distances = np.linalg.norm(trajectory[:, :2] - point[:2], axis=1)
    vertex_index = int(np.argmin(distances))
    vertex_distance = float(distances[vertex_index])

    delta = trajectory[1:] - trajectory[:-1]
    rel = point[:2] - trajectory[:-1, :2]
    dots = rel[:, 0] * delta[:, 0] + rel[:, 1] * delta[:, 1]
    coeffs = dots / (np.linalg.norm(delta, axis=1) ** 2 + 1e-6)
    valid = (coeffs > 0) & (coeffs < 1)
    projections = trajectory[:-1] + coeffs[:, None] * delta
    proj_dist = np.linalg.norm(projections[:, :2] - point[:2], axis=1)
    proj_dist = np.where(valid, proj_dist, np.inf)
    proj_index = int(np.argmin(proj_dist))

    if vertex_distance < float(np.min(proj_dist)):
        return float(parametrization[vertex_index])
    step = parametrization[proj_index + 1] - parametrization[proj_index]
    return float(parametrization[proj_index] + coeffs[proj_index] * step)


def reparametrize_path(path: np.ndarray, point_count: int, kind: str = "quadratic") -> np.ndarray:
    """Resample a polyline to `point_count` points uniformly in arc length via
    scipy quadratic interpolation (ref :57-65). Used by the A* initializer and
    the path postprocessor (both host-side, once per problem)."""
    distances = np.linalg.norm(path[1:] - path[:-1], axis=1) + 1e-6
    cum = np.concatenate([np.zeros(1), np.cumsum(distances)])
    parametrization = cum / cum[-1]
    new_parametrization = np.linspace(0.0, 1.0, point_count)
    interpolator = scipy.interpolate.interp1d(
        parametrization, path, kind=kind, axis=0, fill_value="extrapolate"
    )
    return interpolator(new_parametrization)
