"""ONF — the neural occupancy field, as batched functional PyTorch.

Port of `nfopp_tpu/models/onf.py`. Every tensor carries an explicit leading
problem axis B (each planning problem trains its own field), where the JAX
package vmaps an unbatched function:

    x[B, M, 3] --theta--> angle encoding sin/cos((theta + b_i) * f_i) -> [B, M, 2H]
    x[B, M, :2] --> (x - mean) / sigma --> Linear(2 -> F) --> sin | [sin|cos] -> [B, M, F]
    [fourier | angle] --> Linear(-> hidden) + ReLU --> Linear(-> hidden) + ReLU
    skip-concat [hidden | fourier | angle] --> Linear(-> 1) -> logits [B, M, 1]

Parameters are the JAX package's dict layout with the batch axis in front:
{"encoding": {"w": [B, 2, F], "b": [B, F]}, "mlp1": {"w": [B, F+2H, hid],
"b": [B, hid]}, "mlp2": {...}, "out": {"w": [B, hid+F+2H, 1], "b": [B, 1]},
"angle_biases": [B, 2H]}.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import check_device

__all__ = [
    "ONFConfig",
    "init_onf_params",
    "onf_apply",
    "angle_encode",
    "params_from_jax",
]


class ONFConfig(NamedTuple):
    """Static architecture configuration (copied from the JAX package).

    compute_dtype: 'float32' (reference parity) or 'bfloat16' (matmul inputs
    rounded to bf16, products accumulated in f32; parameters stay f32).
    """

    mean: float = 0.0
    sigma: float = 1.0
    use_cos: bool = True
    use_normal_init: bool = True
    bias: bool = True
    angle_encoding: bool = True
    angle_harmonics: int = 10
    hidden: int = 100
    compute_dtype: str = "float32"

    @property
    def fourier_features(self) -> int:
        return 200 if self.use_cos else 100

    @property
    def angle_features(self) -> int:
        return 2 * self.angle_harmonics if self.angle_encoding else 0

    @property
    def feature_dim(self) -> int:
        return self.fourier_features + self.angle_features


def _uniform(generator, shape, low, high, device):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (low + u * (high - low)).to(device)


def _linear_init(generator, batch, fan_in, fan_out, bias, device):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(float(fan_in))
    w = _uniform(generator, (batch, fan_in, fan_out), -bound, bound, device)
    if bias:
        b = _uniform(generator, (batch, fan_out), -bound, bound, device)
    else:
        b = torch.zeros((batch, fan_out), dtype=torch.float32, device=device)
    return {"w": w, "b": b}


def init_onf_params(
    generator: torch.Generator, config: ONFConfig, batch: int, device=None
) -> dict:
    """Initialise `batch` independent fields with the JAX package's
    distributions (`models/onf.py:60-91`), drawn from `generator`."""
    device = generator.device if device is None else device
    fourier = config.fourier_features
    encoding = _linear_init(generator, batch, 2, fourier, config.bias, device)
    if config.use_normal_init:
        encoding["w"] = torch.randn(
            (batch, 2, fourier), generator=generator, device=generator.device
        ).to(device)
    params = {
        "encoding": encoding,
        "mlp1": _linear_init(generator, batch, config.feature_dim, config.hidden, True, device),
        "mlp2": _linear_init(generator, batch, config.hidden, config.hidden, True, device),
        "out": _linear_init(generator, batch, config.hidden + config.feature_dim, 1, True, device),
    }
    if config.angle_encoding:
        params["angle_biases"] = _uniform(
            generator, (batch, 2 * config.angle_harmonics), -math.pi, math.pi, device
        )
    return params


def angle_encode(biases: torch.Tensor, theta: torch.Tensor, harmonics: int) -> torch.Tensor:
    """[B, M] angles -> [B, M, 2H] learned-phase Fourier features."""
    freqs = torch.arange(1, harmonics + 1, dtype=theta.dtype, device=theta.device)
    frequencies = torch.cat([freqs, freqs])
    x = (theta[..., None] + biases[:, None, :]) * frequencies
    return torch.cat([torch.sin(x[..., :harmonics]), torch.cos(x[..., harmonics:])], dim=-1)


def onf_apply(params: dict, x: torch.Tensor, config: ONFConfig = ONFConfig()) -> torch.Tensor:
    """Field forward pass: [B, M, 2|3] query poses -> [B, M, 1] logits.

    Like the JAX version, the skip concatenations are written as sliced
    weight products summed. Under compute_dtype='bfloat16' both operands of
    every product are rounded to bf16 and the product accumulates in f32
    (`models/onf.py:116-123`): bf16 x bf16 products are exact in f32, so an
    f32 matmul of the rounded operands is the same arithmetic.
    """
    low = config.compute_dtype != "float32"
    if low and config.compute_dtype != "bfloat16":
        raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}")

    def mm(a, w):
        if low:
            a = a.to(torch.bfloat16).float()
            w = w.to(torch.bfloat16).float()
        return torch.matmul(a, w)

    fourier = config.fourier_features
    hid = config.hidden
    xy = (x[..., :2] - config.mean) / config.sigma
    enc = mm(xy, params["encoding"]["w"])
    if config.bias:
        enc = enc + params["encoding"]["b"][:, None, :]
    if config.use_cos:
        h = fourier // 2
        enc = torch.cat([torch.sin(enc[..., :h]), torch.cos(enc[..., h:])], dim=-1)
    else:
        enc = torch.sin(enc)

    w1 = params["mlp1"]["w"]
    w3 = params["out"]["w"]
    if config.angle_encoding:
        angle = angle_encode(params["angle_biases"], x[..., 2], config.angle_harmonics)
        pre1 = mm(enc, w1[:, :fourier]) + mm(angle, w1[:, fourier:])
    else:
        angle = None
        pre1 = mm(enc, w1)
    hidden = torch.relu(pre1 + params["mlp1"]["b"][:, None, :])
    hidden = torch.relu(mm(hidden, params["mlp2"]["w"]) + params["mlp2"]["b"][:, None, :])
    logits = (
        mm(hidden, w3[:, :hid])
        + mm(enc, w3[:, hid : hid + fourier])
        + params["out"]["b"][:, None, :]
    )
    if angle is not None:
        logits = logits + mm(angle, w3[:, hid + fourier :])
    return logits


def params_from_jax(np_params: dict, device="cuda") -> dict:
    """JAX parameter dict (numpy arrays, batched or not) -> the port's
    batched f32 tensors on `device`. An unbatched dict gets a batch axis of 1."""
    device = check_device(device, "params_from_jax")
    batched = np.ndim(np_params["mlp1"]["w"]) == 3

    def convert(a):
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
        return t if batched else t[None]

    out = {
        name: {"w": convert(np_params[name]["w"]), "b": convert(np_params[name]["b"])}
        for name in ("encoding", "mlp1", "mlp2", "out")
    }
    if "angle_biases" in np_params:
        out["angle_biases"] = convert(np_params["angle_biases"])
    return out
