"""Arc-length reparametrization of batched SE(2) paths (port of
`nfopp_tpu/ops/reparametrize.py`): trajectory plus both multiplier vectors,
resampled with one shared set of indices and lerp coordinates."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math import arc_length_cdf, wrap_angle

__all__ = [
    "ArcLengthInterp",
    "arc_length_interp",
    "reparametrize_se2",
    "reparametrize_collision_multipliers",
    "reparametrize_constraint_multipliers",
]


class ArcLengthInterp(NamedTuple):
    """index_above / index_below: [B, N] indices into the (N+2)-point path;
    t: [B, N] lerp coordinates."""

    index_above: torch.Tensor
    index_below: torch.Tensor
    t: torch.Tensor


def arc_length_interp(full_trajectory: torch.Tensor, distance_dims: int) -> ArcLengthInterp:
    """Uniform-arc-length resample indices for [B, M, d] paths.

    searchsorted(side='left') is a comparison count (`:53`); the lerp
    denominator is floored at 1e-5 and t clamped to [0, 1] (`:59-64`), which
    binds only on collapsed paths.
    """
    m = full_trajectory.shape[1]
    cdf = arc_length_cdf(full_trajectory[..., :distance_dims])  # [B, M]
    uniform = (
        torch.arange(m - 1, dtype=cdf.dtype, device=cdf.device) / (m - 1)
    )[1:]  # jnp.linspace(0, 1, m)[1:-1]
    indices = torch.sum(cdf[:, None, :] < uniform[None, :, None], dim=-1)
    index_above = torch.clamp(indices, max=m - 1)
    index_below = torch.clamp(indices - 1, min=0)
    cdf_above = torch.gather(cdf, 1, index_above)
    cdf_below = torch.gather(cdf, 1, index_below)
    denominator = cdf_above - cdf_below
    denominator = torch.where(
        denominator < 1e-5, torch.full_like(denominator, 1e-5), denominator
    )
    t = torch.clamp((uniform - cdf_below) / denominator, 0.0, 1.0)
    return ArcLengthInterp(index_above, index_below, t)


def _rows(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values [B, M, d] gathered at index [B, N] -> [B, N, d]."""
    return torch.gather(values, 1, index[..., None].expand(-1, -1, values.shape[-1]))


def reparametrize_se2(full_trajectory: torch.Tensor) -> tuple[torch.Tensor, ArcLengthInterp]:
    """SE(2) resample of [B, N+2, 3] paths: xy lerp + wrapped-angle lerp.
    Returns (new interior waypoints [B, N, 3], interp data)."""
    interp = arc_length_interp(full_trajectory, 2)
    t = interp.t[..., None]
    below = _rows(full_trajectory, interp.index_below)
    above = _rows(full_trajectory, interp.index_above)
    xy = (1.0 - t) * below[..., :2] + t * above[..., :2]
    theta = below[..., 2] + interp.t * wrap_angle(above[..., 2] - below[..., 2])
    return torch.cat([xy, theta[..., None]], dim=-1), interp


def _lerp(values: torch.Tensor, interp: ArcLengthInterp) -> torch.Tensor:
    below = torch.gather(values, 1, interp.index_below)
    above = torch.gather(values, 1, interp.index_above)
    return (1.0 - interp.t) * below + interp.t * above


def reparametrize_collision_multipliers(
    multipliers: torch.Tensor, interp: ArcLengthInterp
) -> torch.Tensor:
    """Re-interpolate the [B, N] per-waypoint collision multipliers,
    zero-padded to the N+2 node grid."""
    zero = torch.zeros_like(multipliers[:, :1])
    return _lerp(torch.cat([zero, multipliers, zero], dim=1), interp)


def reparametrize_constraint_multipliers(
    multipliers: torch.Tensor, interp: ArcLengthInterp
) -> torch.Tensor:
    """Re-interpolate the [B, N+1] per-segment multipliers: averaged onto the
    nodes, lerped, averaged back onto the new segments (ends replicated)."""
    nodes = torch.cat(
        [multipliers[:, :1], 0.5 * (multipliers[:, :-1] + multipliers[:, 1:]), multipliers[:, -1:]],
        dim=1,
    )
    values = _lerp(nodes, interp)
    return torch.cat(
        [values[:, :1], 0.5 * (values[:, :-1] + values[:, 1:]), values[:, -1:]], dim=1
    )
