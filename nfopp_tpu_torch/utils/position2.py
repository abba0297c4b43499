"""Batched SE(2) pose container (the reference's utils/position2.py:9-100
capability, minus the ROS message types — quaternion conversion works on plain
arrays so any middleware adapter can use it). A copy of
`nfopp_tpu/utils/position2.py` (numpy only; importing it would run
`nfopp_tpu/__init__.py`, which imports JAX)."""
from __future__ import annotations

import numpy as np

__all__ = ["Position2"]


class Position2:
    """x, y, angle — scalars or equal-length arrays (a batch of poses)."""

    def __init__(self, x, y, angle):
        self._x = np.asarray(x)
        self._y = np.asarray(y)
        self._angle = np.asarray(angle)

    # ---------------------------------------------------------- properties

    @property
    def x(self):
        return self._x

    @property
    def y(self):
        return self._y

    @property
    def rotation(self):
        return self._angle

    @property
    def translation(self) -> np.ndarray:
        return np.stack([self._x, self._y], axis=-1)

    # -------------------------------------------------------- constructors

    @classmethod
    def from_vec(cls, vec) -> "Position2":
        vec = np.asarray(vec)
        if vec.ndim == 1:
            return cls(vec[0], vec[1], vec[2])
        return cls(vec[:, 0], vec[:, 1], vec[:, 2])

    def as_vec(self) -> np.ndarray:
        return np.stack([self._x, self._y, self._angle], axis=-1)

    @classmethod
    def from_array(cls, positions: list["Position2"]) -> "Position2":
        return cls(
            np.array([p.x for p in positions]),
            np.array([p.y for p in positions]),
            np.array([p.rotation for p in positions]),
        )

    def as_array(self) -> list["Position2"]:
        return [Position2(self._x[i], self._y[i], self._angle[i]) for i in range(len(self))]

    @classmethod
    def identity(cls) -> "Position2":
        return cls(0.0, 0.0, 0.0)

    # -------------------------------------------------- quaternion helpers

    @classmethod
    def from_quaternion(cls, x, y, qx, qy, qz, qw) -> "Position2":
        """Pose from translation + unit quaternion (yaw extraction)."""
        yaw = np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
        return cls(x, y, yaw)

    def as_quaternion(self) -> np.ndarray:
        """[..., 4] (qx, qy, qz, qw) for the planar rotation."""
        half = self._angle / 2.0
        zeros = np.zeros_like(self._angle)
        return np.stack([zeros, zeros, np.sin(half), np.cos(half)], axis=-1)

    # ------------------------------------------------------------- algebra

    def __len__(self) -> int:
        if self._x.ndim == 0:
            return 1
        return self._x.shape[0]

    def __mul__(self, other: "Position2") -> "Position2":
        """Pose composition self ∘ other (ref :85-89)."""
        cos_t, sin_t = np.cos(self._angle), np.sin(self._angle)
        x = other.x * cos_t - other.y * sin_t + self._x
        y = other.x * sin_t + other.y * cos_t + self._y
        angle = (other.rotation + self._angle + np.pi) % (2 * np.pi) - np.pi
        return Position2(x, y, angle)

    def inv(self) -> "Position2":
        """Inverse pose (ref :91-94)."""
        cos_t, sin_t = np.cos(self._angle), np.sin(self._angle)
        return Position2(
            -self._x * cos_t - self._y * sin_t,
            self._x * sin_t - self._y * cos_t,
            -self._angle,
        )

    def apply(self, points: np.ndarray) -> np.ndarray:
        """Transform [P, 2] points by this (scalar) pose (ref :96-100)."""
        x, y = points.T
        cos_t, sin_t = np.cos(self._angle), np.sin(self._angle)
        return np.stack(
            [x * cos_t - y * sin_t + self._x, x * sin_t + y * cos_t + self._y], axis=1
        )

    @classmethod
    def global_from_local(cls, source: "Position2", local: "Position2") -> "Position2":
        return source * local

    def __repr__(self) -> str:
        return f"Position2(x={self._x}, y={self._y}, angle={self._angle})"
