"""ONF forward kernel: logits of a batch of fields at their query points.

CUDA counterpart of `nfopp_tpu/experimental/pallas/onf_fused.py::_onf_kernel`
(via `onf_apply_fused`); source in `csrc/onf_forward.cu`. On the main path it
scores the replay-buffer candidates of every field update.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.onf import ONFConfig, onf_apply
from . import build
from .common import LAUNCHES, check_points, net_args, stream, use_plain

__all__ = ["onf_forward", "onf_forward_plain"]


def onf_forward_plain(params: dict, x: torch.Tensor, config: ONFConfig) -> torch.Tensor:
    """Plain PyTorch version: `onf_apply`, [B, M, dim] -> [B, M, 1]."""
    return onf_apply(params, x, config)


def onf_forward(params: dict, x: torch.Tensor, config: ONFConfig) -> torch.Tensor:
    """[B, M, dim] query poses -> [B, M, 1] logits of each problem's field."""
    if use_plain(x, config, "onf_forward"):
        return onf_forward_plain(params, x, config)
    batch, m, dim = check_points(x, config, "onf_forward")
    net = net_args(params, config, batch, x.device)
    out = torch.empty((batch, m, 1), dtype=torch.float32, device=x.device)
    build.check(
        build.load_library().nf_onf_forward(
            ctypes.byref(net), x.data_ptr(), batch, m, dim, out.data_ptr(), stream()),
        "onf_forward",
    )
    LAUNCHES["onf_forward"] += 1
    return out
