"""Loss terms of the NFOPP objective on batched tensors (port of
`nfopp_tpu/ops/losses.py`). Each returns one value per problem (leading axis
B); `.detach()` sits where the JAX version calls `stop_gradient`."""
from __future__ import annotations

import torch

from .math import wrap_angle

__all__ = [
    "bce_with_logits",
    "softplus_beta",
    "distance_loss_se2",
    "boundary_loss",
    "non_holonomic_constraint_deltas",
    "direction_constraint_deltas",
]


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy on logits over every axis but the first."""
    loss = (
        torch.clamp(logits, min=0.0)
        - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    return loss.reshape(loss.shape[0], -1).mean(dim=1)


def softplus_beta(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """softplus(x, beta), the identity where beta * x > 20 (torch's threshold)."""
    scaled = beta * x
    linear = scaled > 20.0
    soft = torch.log1p(torch.exp(torch.where(linear, torch.zeros_like(scaled), scaled))) / beta
    return torch.where(linear, x, soft)


def distance_loss_se2(full_trajectory: torch.Tensor, angle_weight: float) -> torch.Tensor:
    """Angle-weighted CHOMP distance term with the angle-sum closure
    correction, [B, M, 3] -> [B]. Only the closure sum uses wrapped deltas,
    and that sum is detached (`ops/losses.py:60-65`)."""
    delta = full_trajectory[:, 1:] - full_trajectory[:, :-1]
    delta_angles = wrap_angle(delta[..., 2])
    angle_sum = (
        torch.sum(delta_angles, dim=-1).detach()
        - full_trajectory[:, -1, 2]
        + full_trajectory[:, 0, 2]
    )
    raw = delta[..., 2]
    corrected = torch.cat([raw[:, :-1], (raw[:, -1] + angle_sum)[:, None]], dim=1) * angle_weight
    delta = torch.cat([delta[..., :2], corrected[..., None]], dim=-1)
    return torch.sum(delta * delta, dim=(1, 2))


def boundary_loss(trajectory: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Quadratic penalty outside bounds [B, 4] = (xmin, xmax, ymin, ymax)."""
    x, y = trajectory[..., 0], trajectory[..., 1]
    b = bounds[:, :, None]
    loss = (
        torch.clamp(b[:, 0] - x, min=0.0) ** 2
        + torch.clamp(x - b[:, 1], min=0.0) ** 2
        + torch.clamp(b[:, 2] - y, min=0.0) ** 2
        + torch.clamp(y - b[:, 3], min=0.0) ** 2
    )
    return torch.sum(loss, dim=-1)


def non_holonomic_constraint_deltas(full_trajectory: torch.Tensor) -> torch.Tensor:
    """Per-segment lateral slip dx*sin(mid) - dy*cos(mid) -> [B, M-1]."""
    dx = full_trajectory[:, 1:, 0] - full_trajectory[:, :-1, 0]
    dy = full_trajectory[:, 1:, 1] - full_trajectory[:, :-1, 1]
    angles = full_trajectory[..., 2]
    delta_angles = wrap_angle(angles[:, 1:] - angles[:, :-1])
    mean_angles = angles[:, :-1] + delta_angles / 2.0
    return dx * torch.sin(mean_angles) - dy * torch.cos(mean_angles)


def direction_constraint_deltas(full_trajectory: torch.Tensor) -> torch.Tensor:
    """Per-segment backward motion -(cos(mid)*dx + sin(mid)*dy) -> [B, M-1];
    the mid heading uses the wrapped BACKWARD difference, as the reference."""
    dx = full_trajectory[:, 1:, 0] - full_trajectory[:, :-1, 0]
    dy = full_trajectory[:, 1:, 1] - full_trajectory[:, :-1, 1]
    angles = full_trajectory[..., 2]
    delta_angles = wrap_angle(angles[:, :-1] - angles[:, 1:])
    mean_angles = angles[:, :-1] + delta_angles / 2.0
    return -(torch.cos(mean_angles) * dx + torch.sin(mean_angles) * dy)
