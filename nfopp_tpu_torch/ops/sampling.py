"""Sampling primitives and the solver's noise source (port of
`nfopp_tpu/ops/sampling.py`).

The JAX package splits a PRNG key per problem and per step. The port draws
each step's noise as [B, ...] blocks from one `torch.Generator` for the whole
batch (`GeneratorNoise`), so problem i's stream depends on the batch it was
solved in. Any object with the same two methods can stand in for it: the
parity tests hand in JAX's own draws that way. On a mesh of ranks,
`ShardNoise` draws the global block and keeps this rank's rows.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "GeneratorNoise",
    "ShardNoise",
    "gumbel_noise",
    "gumbel_topk_indices",
    "gumbel_topk_log_indices",
    "random_intermediate_positions",
    "uniform_box_points",
]


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


class ShardNoise:
    """Noise source of one rank's rows of a sharded batch: each [b, ...]
    block is drawn as the whole [total, ...] block from `source` (seeded the
    same on every rank) and cut to rows `rows`, so problem i's stream does
    not depend on how many ranks share the batch."""

    def __init__(self, source, rows: slice, total: int):
        self.source = GeneratorNoise(source) if isinstance(source, torch.Generator) else source
        self.rows = rows
        self.total = total

    def _rows(self, draw, shape, device) -> torch.Tensor:
        if shape[0] != len(range(self.total)[self.rows]):
            raise ValueError(f"a block of {shape[0]} rows drawn for rows {self.rows} of "
                             f"{self.total}")
        return draw((self.total,) + tuple(shape[1:]), device)[self.rows]

    def uniform(self, shape, device) -> torch.Tensor:
        return self._rows(self.source.uniform, shape, device)

    def normal(self, shape, device) -> torch.Tensor:
        return self._rows(self.source.normal, shape, device)


def gumbel_noise(uniform: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniform(0, 1) draws (clamps of `:30`)."""
    return -torch.log(-torch.log(torch.clamp(uniform, min=1e-20) + 1e-20))


def _uniform_draws(draws, shape, device) -> torch.Tensor:
    """`draws` itself (uniform(0, 1) draws of `shape`) or, for a noise
    source, a block drawn from it."""
    if torch.is_tensor(draws):
        if tuple(draws.shape) != tuple(shape):
            raise ValueError(f"expected uniform draws of shape {tuple(shape)}, "
                             f"got {tuple(draws.shape)}")
        return draws.to(device)
    return draws.uniform(tuple(shape), device)


def gumbel_topk_indices(draws, weights: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, k] of a weighted sample of size k without replacement
    from non-negative weights [B, M] (Gumbel top-k; weights <= 0 come last).
    `draws`: uniform(0, 1) draws shaped like `weights`, or a noise source
    to draw them from (the JAX version takes a key, `ops/sampling.py:33`)."""
    u = _uniform_draws(draws, weights.shape, weights.device)
    scores = torch.log(torch.clamp(weights, min=1e-30)) + gumbel_noise(u)
    return torch.topk(scores, k, dim=-1).indices


def gumbel_topk_log_indices(
    log_weights: torch.Tensor, gumbel: torch.Tensor, k: int
) -> torch.Tensor:
    """Indices [B, k] of a weighted draw without replacement (Gumbel top-k),
    in descending score order like `jax.lax.top_k`."""
    return torch.topk(log_weights + gumbel, k, dim=-1).indices


def random_intermediate_positions(draws, trajectory: torch.Tensor) -> torch.Tensor:
    """One uniform point per segment of trajectories [B, N, d] -> [B, N-1, d]:
    traj[1:] * (1 - t) + traj[:-1] * t, with t [B, N-1, 1] the uniform
    `draws` or drawn from a noise source (`ops/sampling.py:58-66`)."""
    batch, n = trajectory.shape[:2]
    t = _uniform_draws(draws, (batch, n - 1, 1), trajectory.device)
    return trajectory[:, 1:] * (1.0 - t) + trajectory[:, :-1] * t


def uniform_box_points(u: torch.Tensor, bounds: torch.Tensor, with_angle: bool = False) -> torch.Tensor:
    """Map uniform draws u [B, count, 2|3] into the boxes bounds [B, 4]
    (xmin, xmax, ymin, ymax); the third channel becomes an angle in [0, 2pi)."""
    b = bounds[:, None, :]
    x = b[..., 0] + u[..., 0] * (b[..., 1] - b[..., 0])
    y = b[..., 2] + u[..., 1] * (b[..., 3] - b[..., 2])
    if with_angle:
        return torch.stack([x, y, u[..., 2] * 2.0 * math.pi], dim=-1)
    return torch.stack([x, y], dim=-1)
