"""Online occupancy-field training, the first half of every solver step
(port of `nfopp_tpu/solver/field.py`), on a batch of problems.

Segment jitter, a replay buffer resampled by Gumbel top-k over the field's
scores, uniform field points, and the BCE loss with its parameter gradients.
On CUDA the candidate scoring runs the `onf_forward` kernel and the loss and
gradients the `field_grad` kernel; on the CPU their plain versions.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import field_grad, onf_forward
from ..ops.sampling import gumbel_noise, gumbel_topk_log_indices, uniform_box_points
from ..utils.device import device_constant
from .config import SolverConfig

__all__ = [
    "FieldSample",
    "FieldSamplePre",
    "field_sample_pre",
    "field_sample_post",
    "sample_field_points",
    "field_loss_and_grad",
]


class FieldSample(NamedTuple):
    train_points: torch.Tensor  # [B, (N-1) + K + R, dim]
    buffer_points: torch.Tensor  # [B, K, dim]
    buffer_ages: torch.Tensor  # [B, K]


class FieldSamplePre(NamedTuple):
    coarse: torch.Tensor  # [B, N-1, dim] coarse-jittered segment samples
    fine: torch.Tensor  # [B, N-1, dim] fine-jittered samples (buffer candidates)
    gumbel: torch.Tensor  # [B, K + N-1] Gumbel noise for the resampling top-k
    random_points: torch.Tensor  # [B, R, dim] uniform field points


def field_sample_pre(
    config: SolverConfig, noise, prev_trajectory: torch.Tensor, bounds: torch.Tensor
) -> FieldSamplePre:
    """Draw all of a field step's noise as two blocks, as the JAX version
    does (`field.py:74-87`): uniforms [B, (N-1) + (K+N-1) + R*dim] and
    normals [B, 2, N-1, dim], both from `noise`."""
    batch, n, dim = prev_trajectory.shape
    device = prev_trajectory.device
    cand = config.collision_point_count + (n - 1)
    r = config.random_field_points
    u = noise.uniform((batch, (n - 1) + cand + r * dim), device)
    t = u[:, : n - 1, None]
    gumbel = gumbel_noise(u[:, n - 1 : n - 1 + cand])
    ur = u[:, n - 1 + cand :].reshape(batch, r, dim)
    random_points = uniform_box_points(ur, bounds, with_angle=dim == 3)

    positions = prev_trajectory[:, 1:] * (1.0 - t) + prev_trajectory[:, :-1] * t
    normal = noise.normal((batch, 2, n - 1, dim), device)
    if dim == 3:
        coarse_scale = device_constant(
            (config.course_random_offset,) * 2 + (config.angle_offset,), device)
        fine_scale = device_constant(
            (config.trajectory_random_offset,) * 2 + (config.angle_offset,), device)
    else:
        coarse_scale = config.course_random_offset
        fine_scale = config.trajectory_random_offset
    coarse = positions + normal[:, 0] * coarse_scale
    fine = positions + normal[:, 1] * fine_scale
    return FieldSamplePre(coarse, fine, gumbel, random_points)


def buffer_log_weights(
    config: SolverConfig, logits: torch.Tensor, ages: torch.Tensor, floor: bool = True
) -> torch.Tensor:
    """Log resampling weight of each replay-buffer candidate [B, M]:
    log(sigmoid(z) * exp(-decay * age)), plus buffer_weight_floor inside the
    log when `floor` (the default and Jacobi orders; the merged step resamples
    without it)."""
    log_w = F.logsigmoid(logits) - ages * config.buffer_age_decay
    if floor and config.buffer_weight_floor > 0:
        # log(floor) as the CPU computes it in float32
        floor_w = float(torch.log(torch.tensor(config.buffer_weight_floor, dtype=torch.float32)))
        log_w = torch.logaddexp(log_w, device_constant(floor_w, log_w.device))
    return log_w


def field_sample_post(
    config: SolverConfig,
    pre: FieldSamplePre,
    logits: torch.Tensor,
    candidates: torch.Tensor,
    candidate_ages: torch.Tensor,
) -> FieldSample:
    """Resample the replay buffer from scored candidates (weight
    sigmoid(z) * exp(-decay * age) + floor, in log space) and assemble the
    training batch [coarse, buffer, random]."""
    log_w = buffer_log_weights(config, logits, candidate_ages)
    idx = gumbel_topk_log_indices(log_w, pre.gumbel, config.collision_point_count)
    new_buffer = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, candidates.shape[-1]))
    new_ages = torch.gather(candidate_ages, 1, idx) + 1.0
    train_points = torch.cat([pre.coarse, new_buffer, pre.random_points], dim=1)
    return FieldSample(train_points, new_buffer, new_ages)


def sample_field_points(
    config: SolverConfig,
    noise,
    prev_trajectory: torch.Tensor,
    buffer_points: torch.Tensor,
    buffer_ages: torch.Tensor,
    field_params: dict,
    bounds: torch.Tensor,
    score_fn: Callable[[dict, torch.Tensor], torch.Tensor] | None = None,
    live: torch.Tensor | None = None,
) -> FieldSample:
    """Training points of one field step and the advanced replay buffer; the
    candidates [B, M, dim] are scored by score_fn(params, candidates) -> [B,
    M] logits, by default the field's forward (the `onf_forward` kernel on
    CUDA, on the live rows `live`)."""
    pre = field_sample_pre(config, noise, prev_trajectory, bounds)
    candidates = torch.cat([buffer_points, pre.fine], dim=1)
    candidate_ages = torch.cat([buffer_ages, torch.zeros_like(pre.fine[..., 0])], dim=1)
    if score_fn is None:
        logits = onf_forward(field_params, candidates, config.onf, live)[..., 0]
    else:
        logits = score_fn(field_params, candidates)
    return field_sample_post(config, pre, logits, candidates, candidate_ages)


def field_loss_and_grad(
    config: SolverConfig, field_params: dict, points: torch.Tensor, truth: torch.Tensor,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Per-problem BCE-with-logits loss of the field against oracle labels,
    and its parameter gradients (the `field_grad` kernel on CUDA, on the
    live rows `live`)."""
    return field_grad(field_params, points, truth, config.onf, live)
