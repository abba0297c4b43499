"""Sampling primitives and the solver's noise source (port of
`nfopp_tpu/ops/sampling.py`).

The JAX package splits a PRNG key per problem and per step. The port draws
each step's noise as [B, ...] blocks from one `torch.Generator` for the whole
batch (`GeneratorNoise`), so problem i's stream depends on the batch it was
solved in. Any object with the same two methods can stand in for it: the
parity tests hand in JAX's own draws that way.
"""
from __future__ import annotations

import math

import torch

__all__ = ["GeneratorNoise", "gumbel_noise", "gumbel_topk_log_indices", "uniform_box_points"]


class GeneratorNoise:
    """Noise source drawing from one seeded `torch.Generator`.

    The draws are made on the generator's device and moved to `device`, so a
    CPU generator gives the same numbers to a CPU and a CUDA solve.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape, device) -> torch.Tensor:
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device).to(device)

    def normal(self, shape, device) -> torch.Tensor:
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device).to(device)


def gumbel_noise(uniform: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniform(0, 1) draws (clamps of `:30`)."""
    return -torch.log(-torch.log(torch.clamp(uniform, min=1e-20) + 1e-20))


def gumbel_topk_log_indices(
    log_weights: torch.Tensor, gumbel: torch.Tensor, k: int
) -> torch.Tensor:
    """Indices [B, k] of a weighted draw without replacement (Gumbel top-k),
    in descending score order like `jax.lax.top_k`."""
    return torch.topk(log_weights + gumbel, k, dim=-1).indices


def uniform_box_points(u: torch.Tensor, bounds: torch.Tensor, with_angle: bool = False) -> torch.Tensor:
    """Map uniform draws u [B, count, 2|3] into the boxes bounds [B, 4]
    (xmin, xmax, ymin, ymax); the third channel becomes an angle in [0, 2pi)."""
    b = bounds[:, None, :]
    x = b[..., 0] + u[..., 0] * (b[..., 1] - b[..., 0])
    y = b[..., 2] + u[..., 1] * (b[..., 3] - b[..., 2])
    if with_angle:
        return torch.stack([x, y, u[..., 2] * 2.0 * math.pi], dim=-1)
    return torch.stack([x, y], dim=-1)
