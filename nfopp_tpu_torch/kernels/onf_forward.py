"""ONF forward kernel: logits of a batch of fields at their query points.

CUDA counterpart of `nfopp_tpu/experimental/pallas/onf_fused.py::_onf_kernel`
(via `onf_apply_fused`); source in `csrc/onf_forward.cu`. On the main path it
scores the replay-buffer candidates of every field update.

Under compute_dtype="bfloat16" the kernel computes `onf_apply`'s casts (xy
and the encoding weights rounded too), as the solver's plain path does; its
launches count under "onf_forward_bf16".
"""
from __future__ import annotations

import ctypes

import torch

from ..models.onf import ONFConfig, onf_apply
from . import build
from .common import (
    FORWARD_LIMITS, LAUNCHES, check_fits, check_points, is_bf16, net_args, skip_rows,
    stream, use_plain,
)

__all__ = ["onf_forward", "onf_forward_plain"]


def onf_forward_plain(params: dict, x: torch.Tensor, config: ONFConfig,
                      live: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: `onf_apply`, [B, M, dim] -> [B, M, 1] (zeros
    for a problem that is not live)."""
    return skip_rows(onf_apply(params, x, config), live)


def onf_forward(params: dict, x: torch.Tensor, config: ONFConfig,
                live: torch.Tensor | None = None) -> torch.Tensor:
    """[B, M, dim] query poses -> [B, M, 1] logits of each problem's field;
    with live rows `live` (bool [B]) a problem that is not live gets zeros
    and its CTA is skipped."""
    if use_plain(x, config, "onf_forward"):
        return onf_forward_plain(params, x, config, live)
    batch, m, dim = check_points(x, config, "onf_forward")
    net = net_args(params, config, batch, x.device, live)
    bf16 = is_bf16(config)
    name = "onf_forward_bf16" if bf16 else "onf_forward"
    out = torch.empty((batch, m, 1), dtype=torch.float32, device=x.device)
    code = build.load_library().nf_onf_forward(
        ctypes.byref(net), x.data_ptr(), batch, m, dim, int(bf16), out.data_ptr(), stream())
    check_fits(code, name, config, FORWARD_LIMITS)
    build.check(code, name)
    LAUNCHES[name] += 1
    return out
