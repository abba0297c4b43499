"""Field-training kernel with the products in compute_dtype: mean BCE loss
and every parameter gradient of a batch of fields.

CUDA counterpart of `nfopp_tpu/experimental/pallas/field_grad_multi.py::_kernel`
(via `field_loss_and_grad_multi`); source in `csrc/field_grad_multi.cu`. On
the batch-explicit solve it is the loss and gradient of every field update.

Its backward is written out as the TPU kernel writes it, not taken by
autograd: every product rounds both operands to compute_dtype, the
cotangents g, dh2 and dh1 included (`field_grad_multi.py:71-83`, `:100-122`);
the row sums take the f32 cotangents (d_b3 `:105`, d_b2 `:111`, d_b1 `:118`,
the encoding gradients `:128-130`, the angle biases `:140`); the ReLU masks
come from the f32 pre-activations (`:109`, `:115`). The encoding-bias
gradient is zero under bias=False (`:218-221`).
"""
from __future__ import annotations

import torch

from ..models.onf import ONFConfig
from .common import check_problems_per_program, is_bf16, use_plain
from .field_grad import launch_field_grad
from .onf_multi import multi_forward, rounding

__all__ = ["field_grad_multi", "field_grad_multi_plain"]


def field_grad_multi_plain(
    params: dict, points: torch.Tensor, truth: torch.Tensor, config: ONFConfig
) -> tuple[torch.Tensor, dict]:
    """Plain PyTorch version: per-problem losses [B] and gradients shaped
    like `params`."""
    r = rounding(config)
    f, hid = config.fourier_features, config.hidden
    fw = multi_forward(params, points, config)
    z = fw.logits[..., 0]
    y = truth.to(torch.float32)
    inv_n = 1.0 / z.shape[1]
    bce = torch.relu(z) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    loss = torch.sum(bce, dim=1) * inv_n
    g = (torch.sigmoid(z) - y) * inv_n
    gr = r(g)
    w1, w2 = r(params["mlp1"]["w"]), r(params["mlp2"]["w"])
    w3 = r(params["out"]["w"])[..., 0]

    d_w3 = torch.einsum("bmk,bm->bk", torch.cat([fw.h2, fw.features], dim=-1), gr)[..., None]
    dh2 = torch.where(fw.pre2 > 0, gr[..., None] * w3[:, None, :hid], 0.0)
    d_w2 = fw.h1.transpose(1, 2) @ r(dh2)
    dh1 = torch.where(fw.pre1 > 0, r(dh2) @ w2.transpose(1, 2), 0.0)
    d_w1 = fw.features.transpose(1, 2) @ r(dh1)
    dfeat = gr[..., None] * w3[:, None, hid:] + r(dh1) @ w1.transpose(1, 2)

    if config.use_cos:
        half = f // 2
        slope = torch.cat([torch.cos(fw.enc[..., :half]), -torch.sin(fw.enc[..., half:])], dim=-1)
    else:
        slope = torch.cos(fw.enc)
    denc = slope * dfeat[..., :f]
    grads = {
        "encoding": {
            "w": torch.stack([torch.sum(fw.xn * denc, dim=1), torch.sum(fw.yn * denc, dim=1)],
                             dim=1),
            "b": torch.sum(denc, dim=1) if config.bias
            else torch.zeros_like(params["encoding"]["b"]),
        },
        "mlp1": {"w": d_w1, "b": torch.sum(dh1, dim=1)},
        "mlp2": {"w": d_w2, "b": torch.sum(dh2, dim=1)},
        "out": {"w": d_w3, "b": torch.sum(g, dim=1, keepdim=True)},
    }
    if config.angle_encoding:
        h = config.angle_harmonics
        slope = torch.cat([torch.cos(fw.phase[..., :h]), -torch.sin(fw.phase[..., h:])], dim=-1)
        grads["angle_biases"] = torch.sum(slope * dfeat[..., f:] * fw.freq, dim=1)
    return loss, grads


def field_grad_multi(
    params: dict, points: torch.Tensor, truth: torch.Tensor, config: ONFConfig,
    problems_per_program: int = 8,
) -> tuple[torch.Tensor, dict]:
    """(loss [B], gradients like `params`) of each field's mean BCE-with-logits
    on points [B, M, dim] against labels truth [B, M] (bool or float), the
    products in config.compute_dtype; B must be divisible by
    problems_per_program."""
    check_problems_per_program(points.shape[0], problems_per_program)
    if use_plain(points, config, "field_grad_multi"):
        return field_grad_multi_plain(params, points, truth, config)
    return launch_field_grad("field_grad_multi", "nf_field_grad_multi", params, points, truth,
                             config, int(is_bf16(config)))
