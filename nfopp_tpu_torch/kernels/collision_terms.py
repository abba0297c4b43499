"""Collision terms of the trajectory loss, with a gradient to the query poses
and the multipliers (the field is frozen during the trajectory update).

CUDA counterpart of `nfopp_tpu/experimental/pallas/collision_terms.py`:
`_fwd_kernel` and `_bwd_kernel` behind `make_collision_terms`' custom VJP
become two kernels behind one `torch.autograd.Function`; source in
`csrc/collision_terms.cu`.

Under compute_dtype="bfloat16" the kernels compute what the solver's plain
path computes, `onf_apply`'s casts and their autograd (xy and the encoding
weights rounded too, each cotangent rounded where it passes back through a
cast); their launches count under "collision_fwd_bf16" / "collision_bwd_bf16".
"""
from __future__ import annotations

import ctypes

import torch

from ..models.onf import ONFConfig, onf_apply
from ..ops.losses import softplus_beta
from . import build
from .common import LAUNCHES, check_points, check_tensor, is_bf16, net_args, stream, use_plain

__all__ = ["collision_terms", "collision_terms_plain", "collision_fwd", "collision_bwd"]


def collision_terms_plain(
    params: dict, positions: torch.Tensor, multipliers: torch.Tensor, config: ONFConfig,
    beta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, differentiable by autograd:
    (sum_m softplus_beta(z), sum_m mu * tanh(z)) per problem, each [B]. Under
    bf16 its autograd is the bf16 kernels' yardstick."""
    logits = onf_apply(params, positions, config)[..., 0]
    return (
        torch.sum(softplus_beta(logits, beta), dim=1),
        torch.sum(multipliers * torch.tanh(logits), dim=1),
    )


def collision_fwd(params, positions, multipliers, config: ONFConfig, beta: float) -> torch.Tensor:
    """Forward kernel on checked CUDA tensors: [B, 2] = (sum softplus, sum mu * tanh)."""
    batch, m, dim = positions.shape
    net = net_args(params, config, batch, positions.device)
    bf16 = is_bf16(config)
    name = "collision_fwd_bf16" if bf16 else "collision_fwd"
    out = torch.empty((batch, 2), dtype=torch.float32, device=positions.device)
    build.check(
        build.load_library().nf_collision_fwd(
            ctypes.byref(net), positions.data_ptr(), multipliers.data_ptr(), batch, m, dim,
            float(beta), int(bf16), out.data_ptr(), stream()),
        name,
    )
    LAUNCHES[name] += 1
    return out


def collision_bwd(params, positions, multipliers, g, config: ONFConfig, beta: float):
    """Backward kernel on checked CUDA tensors: cotangents g [B, 2] ->
    (d positions [B, M, dim], d multipliers [B, M])."""
    batch, m, dim = positions.shape
    net = net_args(params, config, batch, positions.device)
    check_tensor("cotangents", g, (batch, 2), positions.device)
    bf16 = is_bf16(config)
    name = "collision_bwd_bf16" if bf16 else "collision_bwd"
    d_positions = torch.empty_like(positions)
    d_multipliers = torch.empty_like(multipliers)
    build.check(
        build.load_library().nf_collision_bwd(
            ctypes.byref(net), positions.data_ptr(), multipliers.data_ptr(), g.data_ptr(),
            batch, m, dim, float(beta), int(bf16), d_positions.data_ptr(),
            d_multipliers.data_ptr(), stream()),
        name,
    )
    LAUNCHES[name] += 1
    return d_positions, d_multipliers


class _CollisionTerms(torch.autograd.Function):
    """Forward: one `collision_fwd` launch. Backward: one `collision_bwd`
    launch, which recomputes the forward."""

    @staticmethod
    def forward(ctx, positions, multipliers, params, config, beta):
        out = collision_fwd(params, positions, multipliers, config, beta)
        ctx.save_for_backward(positions, multipliers)
        ctx.params, ctx.config, ctx.beta = params, config, beta
        return out[:, 0], out[:, 1]

    @staticmethod
    def backward(ctx, g_soft, g_tanh):
        positions, multipliers = ctx.saved_tensors
        zeros = torch.zeros(positions.shape[:1], dtype=torch.float32, device=positions.device)
        g = torch.stack([
            zeros if g_soft is None else g_soft, zeros if g_tanh is None else g_tanh,
        ], dim=1).to(torch.float32).contiguous()
        d_positions, d_multipliers = collision_bwd(
            ctx.params, positions, multipliers, g, ctx.config, ctx.beta)
        return d_positions, d_multipliers, None, None, None


def collision_terms(
    params: dict, positions: torch.Tensor, multipliers: torch.Tensor, config: ONFConfig,
    beta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum softplus_beta(z), sum mu * tanh(z)) per problem for poses
    [B, M, dim] and multipliers [B, M]; differentiable w.r.t. both (never
    w.r.t. the field parameters)."""
    if use_plain(positions, config, "collision_terms"):
        return collision_terms_plain(params, positions, multipliers, config, beta)
    batch, m, _ = check_points(positions, config, "collision_terms")
    check_tensor("multipliers", multipliers, (batch, m), positions.device)
    return _CollisionTerms.apply(positions, multipliers, params, config, beta)
