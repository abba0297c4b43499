"""Path evaluation (port of `nfopp_tpu/solver/tracking.py::evaluate_path`)."""
from __future__ import annotations

from typing import Any

import torch

from ..ops.math import dense_path

__all__ = ["evaluate_path"]


def evaluate_path(
    oracle_fn, oracle_params: Any, full_path: torch.Tensor, samples_per_segment: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(collides [B], xy length [B]) of paths [B, M, d]: interpolate
    `samples_per_segment` poses per segment, ask the oracle, measure."""
    dense = dense_path(full_path, samples_per_segment)
    collides = torch.any(oracle_fn(oracle_params, dense), dim=1)
    seg = full_path[:, 1:, :2] - full_path[:, :-1, :2]
    length = torch.sum(torch.sqrt(torch.sum(seg * seg, dim=-1)), dim=1)
    return collides, length
