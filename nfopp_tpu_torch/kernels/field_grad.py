"""Field-training kernel: mean BCE loss and every parameter gradient.

CUDA counterpart of `nfopp_tpu/experimental/pallas/field_grad.py::_kernel`
(via `field_loss_and_grad_fused`); source in `csrc/field_grad.cu`. On the main
path it is the loss and gradient of every field update.

Under compute_dtype="bfloat16" the kernel computes autograd of `onf_apply`'s
casts, as the solver's plain path does: each gradient of a cast weight
(encoding, mlp1, mlp2 and out weights) is its f32 sum over the points rounded
once to bf16, the bias gradients stay f32; its launches count under
"field_grad_bf16".
"""
from __future__ import annotations

import ctypes

import torch

from ..models.onf import ONFConfig, onf_apply
from ..ops.losses import bce_with_logits
from ..utils.tree import tree_leaves, tree_map
from . import build
from .common import (
    LAUNCHES, TOO_LARGE, check_points, check_tensor, is_bf16, net_args, skip_rows,
    stream, use_plain,
)

__all__ = ["field_grad", "field_grad_plain", "launch_field_grad"]


class _Grads(ctypes.Structure):
    """Mirror of `struct Grads` in csrc/field_grad.cu."""

    _fields_ = [(name, ctypes.c_void_p)
                for name in ("ew", "eb", "w1", "b1", "w2", "b2", "w3", "b3", "ab")]


def field_grad_plain(
    params: dict, points: torch.Tensor, truth: torch.Tensor, config: ONFConfig,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Plain PyTorch version: autograd of `onf_apply` + BCE. Returns per-problem
    losses [B] and gradients shaped like `params` (zeros for a problem that
    is not live)."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        logits = onf_apply(leaves, points, config)
        loss = bce_with_logits(logits[..., 0], truth.to(torch.float32))
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss.sum(), flat, allow_unused=True)
    # an unused leaf (the encoding bias under bias=False) gets a zero gradient
    grads = iter([skip_rows(torch.zeros_like(p) if g is None else g, live)
                  for p, g in zip(flat, grads)])
    return skip_rows(loss.detach(), live), tree_map(lambda _: next(grads), leaves)


def launch_field_grad(
    name: str, entry: str, params: dict, points: torch.Tensor, truth: torch.Tensor,
    config: ONFConfig, *flags: int, live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Check the inputs of a field-gradient kernel (this one or
    `field_grad_multi`), allocate its outputs, launch C entry point `entry`
    (with `flags` after the shapes, and live rows `live`) and count the
    launch under `name`."""
    batch, m, dim = check_points(points, config, name)
    y = truth.to(torch.float32).contiguous()
    check_tensor("truth", y, (batch, m), points.device)
    net = net_args(params, config, batch, points.device, live)
    loss = torch.empty((batch,), dtype=torch.float32, device=points.device)
    grads = tree_map(torch.empty_like, params)
    c = _Grads(
        grads["encoding"]["w"].data_ptr(), grads["encoding"]["b"].data_ptr(),
        grads["mlp1"]["w"].data_ptr(), grads["mlp1"]["b"].data_ptr(),
        grads["mlp2"]["w"].data_ptr(), grads["mlp2"]["b"].data_ptr(),
        grads["out"]["w"].data_ptr(), grads["out"]["b"].data_ptr(),
        grads["angle_biases"].data_ptr() if config.angle_encoding else None,
    )
    code = getattr(build.load_library(), entry)(
        ctypes.byref(net), points.data_ptr(), y.data_ptr(), batch, m, dim, *flags,
        loss.data_ptr(), ctypes.byref(c), stream())
    if code == TOO_LARGE:
        raise ValueError(
            f"{name}: a field of {config.feature_dim} features and hidden {config.hidden} does "
            "not fit one CTA of this kernel (its shared memory or the register tiles of its "
            "weight gradients); at 220 features the f32 kernel takes hidden <= 108 and the "
            "bf16 kernels hidden <= 104"
        )
    build.check(code, name)
    LAUNCHES[name] += 1
    return loss, grads


def field_grad(
    params: dict, points: torch.Tensor, truth: torch.Tensor, config: ONFConfig,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """(loss [B], gradients like `params`) of each field's mean BCE-with-logits
    on points [B, M, dim] against labels truth [B, M] (bool or float); with
    live rows `live` (bool [B]) a problem that is not live gets zeros and its
    CTA is skipped."""
    if use_plain(points, config, "field_grad"):
        return field_grad_plain(params, points, truth, config, live)
    bf16 = is_bf16(config)
    return launch_field_grad("field_grad_bf16" if bf16 else "field_grad", "nf_field_grad",
                             params, points, truth, config, int(bf16), live=live)
