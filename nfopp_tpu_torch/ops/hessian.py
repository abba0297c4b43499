"""Smoothness (velocity) Hessian preconditioner.

The reference preconditions the trajectory gradient with the dense inverse of
H = w * tridiag(-2, 4, -2) + I (nerf_opt_planner.py:45-58, applied at :151).
H is symmetric positive definite and constant for a given trajectory length, so
we precompute H^-1 once at trace time (a host-side numpy solve) and apply it as a
single [N, N] @ [N, d] matmul on device — the same math, MXU-friendly.

For very long trajectories (N >> 1e3) a banded Cholesky solve would be cheaper,
but at the reference's N≈100 the dense matmul is faster on TPU than a sequential
tridiagonal sweep (the Thomas algorithm serializes on the VPU).
"""
from __future__ import annotations

import numpy as np

__all__ = ["velocity_hessian", "inverse_velocity_hessian"]


def velocity_hessian(point_count: int) -> np.ndarray:
    """Tridiagonal second-difference Hessian (ref: nerf_opt_planner.py:50-58)."""
    h = np.zeros((point_count, point_count), dtype=np.float64)
    idx = np.arange(point_count)
    h[idx, idx] = 4.0
    h[idx[1:], idx[:-1]] = -2.0
    h[idx[:-1], idx[1:]] = -2.0
    return h


def inverse_velocity_hessian(point_count: int, weight: float) -> np.ndarray:
    """float32 inverse of (weight * velocity_hessian + I) (ref: :45-48)."""
    h = weight * velocity_hessian(point_count) + np.eye(point_count)
    return np.linalg.inv(h).astype(np.float32)
