"""Geometry and angle math on batched tensors (port of `nfopp_tpu/ops/math.py`).

Paths are [..., M, d] with the sequence on the second-to-last axis.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "wrap_angle", "unfold_angles", "sinc", "linspace", "segment_lengths", "arc_length_cdf",
    "dense_path",
]


def wrap_angle(angles: torch.Tensor) -> torch.Tensor:
    """Wrap angles into [-pi, pi). A floor-mod, like jnp's `%`: `torch.remainder`
    takes the divisor's sign, where `fmod` would keep the dividend's."""
    return torch.remainder(angles + math.pi, 2.0 * math.pi) - math.pi


def unfold_angles(angles: torch.Tensor) -> torch.Tensor:
    """Make angle sequences [..., M] continuous by unwrapping +-2pi jumps
    along the last axis (`ops/math.py:27-37`, which takes one sequence)."""
    angles = wrap_angle(angles)
    delta = angles[..., 1:] - angles[..., :-1]
    delta = torch.where(delta > math.pi, delta - 2.0 * math.pi, delta)
    delta = torch.where(delta < -math.pi, delta + 2.0 * math.pi, delta)
    steps = torch.cat([torch.zeros_like(angles[..., :1]), torch.cumsum(delta, dim=-1)], dim=-1)
    return angles[..., :1] + steps


def sinc(x: torch.Tensor, epsilon: float = 1e-4) -> torch.Tensor:
    """sin(x)/x with |x| clamped to at least epsilon; zero clamps to
    +epsilon, so sinc(0) is ~1 (`ops/math.py:40-49`)."""
    sign = torch.where(x >= 0, 1.0, -1.0)
    x = torch.where(torch.abs(x) > epsilon, x, sign * epsilon)
    return torch.sin(x) / x


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """[B] endpoints -> [B, num], with jnp.linspace's arithmetic
    (start * (1 - s) + stop * s, s = i / (num - 1) in f32, exact endpoint).
    s is divided on the CPU: CUDA's division by a scalar multiplies by its
    reciprocal, which can round differently, so s is the same on every
    device."""
    start = torch.as_tensor(start, dtype=torch.float32)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=start.device)
    if num == 1:
        return start[..., None]
    div = num - 1
    step = (torch.arange(div, dtype=torch.float32) / div).to(start.device)
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def dense_path(full_path: torch.Tensor, samples_per_segment: int) -> torch.Tensor:
    """[B, M, d] -> [B, (M-1)*S + 1, d]: xy lerp + shortest-arc angle."""
    a = full_path[:, :-1]
    b = full_path[:, 1:]
    fractions = (
        torch.arange(samples_per_segment, dtype=full_path.dtype, device=full_path.device)
        / samples_per_segment
    )
    delta = b - a
    if full_path.shape[-1] == 3:
        delta = torch.cat([delta[..., :2], wrap_angle(delta[..., 2:])], dim=-1)
    dense = a[:, :, None, :] + fractions[None, None, :, None] * delta[:, :, None, :]
    dense = dense.reshape(full_path.shape[0], -1, full_path.shape[-1])
    return torch.cat([dense, full_path[:, -1:]], dim=1)


def segment_lengths(points: torch.Tensor) -> torch.Tensor:
    """Lengths of consecutive segments of [..., N, d] polylines -> [..., N-1]."""
    delta = points[..., 1:, :] - points[..., :-1, :]
    return torch.sqrt(torch.sum(delta * delta, dim=-1))


def arc_length_cdf(points: torch.Tensor) -> torch.Tensor:
    """Normalised cumulative arc length of [..., N, d] polylines -> [..., N].

    The total length is floored at 1e-12 (`ops/math.py:87-93`): a fully
    collapsed path gives an all-zero CDF instead of 0/0 NaN.
    """
    dists = segment_lengths(points)
    total = torch.clamp(torch.sum(dists, dim=-1, keepdim=True), min=1e-12)
    cdf = torch.cumsum(dists / total, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
