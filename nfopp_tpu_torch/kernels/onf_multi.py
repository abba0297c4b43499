"""ONF forward with the products in compute_dtype: logits of a batch of
fields at their query points.

CUDA counterpart of `nfopp_tpu/experimental/pallas/onf_multi.py::_kernel`
(via `onf_apply_fused_multi`); source in `csrc/onf_multi.cu`. On the
batch-explicit solve it scores the replay-buffer candidates of every field
update.

Its casts are the TPU kernel's, not `onf_apply`'s: the encoding layer and the
angle features in f32 (`onf_multi.py:40-56`), then both operands of every MLP
and head product rounded to compute_dtype with f32 accumulation (`:60-70`).
In f32 it is `onf_forward`'s function. The TPU kernel's P problems per
program are checked (B % P == 0) and do not change the result.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..models.onf import ONFConfig
from . import build
from .common import (
    LAUNCHES,
    check_points,
    check_problems_per_program,
    is_bf16,
    net_args,
    stream,
    use_plain,
)

__all__ = ["onf_multi", "onf_multi_plain", "multi_forward", "MultiForward", "rounding"]


class MultiForward(NamedTuple):
    """The forward's intermediates, as the backward of `field_grad_multi_plain`
    needs them; `features`, `h1` and `h2` are rounded (product operands)."""

    xn: torch.Tensor  # [B, M, 1] normalised x
    yn: torch.Tensor  # [B, M, 1] normalised y
    enc: torch.Tensor  # [B, M, F] encoding pre-activations (f32)
    phase: torch.Tensor | None  # [B, M, A] angle phases (f32)
    freq: torch.Tensor | None  # [A] angle frequencies
    features: torch.Tensor  # [B, M, F + A]
    pre1: torch.Tensor  # [B, M, hidden]
    h1: torch.Tensor
    pre2: torch.Tensor
    h2: torch.Tensor
    logits: torch.Tensor  # [B, M, 1]


def rounding(config: ONFConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The cast of a product operand: to bf16 and back under 'bfloat16'."""
    if is_bf16(config):
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def multi_forward(params: dict, x: torch.Tensor, config: ONFConfig) -> MultiForward:
    """The TPU multi-problem kernels' forward, in plain PyTorch."""
    r = rounding(config)
    f = config.fourier_features
    xn = (x[..., 0:1] - config.mean) / config.sigma
    yn = (x[..., 1:2] - config.mean) / config.sigma
    w = params["encoding"]["w"]
    enc = xn * w[:, None, 0] + yn * w[:, None, 1]
    if config.bias:
        enc = enc + params["encoding"]["b"][:, None]
    if config.use_cos:
        feats = torch.cat([torch.sin(enc[..., : f // 2]), torch.cos(enc[..., f // 2:])], dim=-1)
    else:
        feats = torch.sin(enc)
    phase = freq = None
    if config.angle_encoding:
        h = config.angle_harmonics
        ramp = torch.arange(1, h + 1, dtype=torch.float32, device=x.device)
        freq = torch.cat([ramp, ramp])
        phase = (x[..., 2:3] + params["angle_biases"][:, None]) * freq
        feats = torch.cat([feats, torch.sin(phase[..., :h]), torch.cos(phase[..., h:])], dim=-1)
    features = r(feats)
    pre1 = features @ r(params["mlp1"]["w"]) + params["mlp1"]["b"][:, None]
    h1 = r(torch.relu(pre1))
    pre2 = h1 @ r(params["mlp2"]["w"]) + params["mlp2"]["b"][:, None]
    h2 = r(torch.relu(pre2))
    logits = torch.cat([h2, features], dim=-1) @ r(params["out"]["w"]) + params["out"]["b"][:, None]
    return MultiForward(xn, yn, enc, phase, freq, features, pre1, h1, pre2, h2, logits)


def onf_multi_plain(params: dict, x: torch.Tensor, config: ONFConfig) -> torch.Tensor:
    """Plain PyTorch version: [B, M, dim] -> [B, M, 1] logits."""
    return multi_forward(params, x, config).logits


def onf_multi(
    params: dict, x: torch.Tensor, config: ONFConfig, problems_per_program: int = 8
) -> torch.Tensor:
    """[B, M, dim] query poses -> [B, M, 1] logits of each problem's field,
    the products in config.compute_dtype; B must be divisible by
    problems_per_program."""
    check_problems_per_program(x.shape[0], problems_per_program)
    if use_plain(x, config, "onf_multi"):
        return onf_multi_plain(params, x, config)
    batch, m, dim = check_points(x, config, "onf_multi")
    net = net_args(params, config, batch, x.device)
    out = torch.empty((batch, m, 1), dtype=torch.float32, device=x.device)
    build.check(
        build.load_library().nf_onf_multi(
            ctypes.byref(net), x.data_ptr(), batch, m, dim, int(is_bf16(config)),
            out.data_ptr(), stream()),
        "onf_multi",
    )
    LAUNCHES["onf_multi"] += 1
    return out
