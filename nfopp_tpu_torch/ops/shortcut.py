"""Random-pair path shortcutting on a batch of paths (OMPL PathSimplifier
role; port of `nfopp_tpu/ops/shortcut.py`).

One trial: pick i < j per path, replace the points strictly between them
with samples of the straight chord path[i] -> path[j] (xy lerp; shortest-arc
angle lerp for SE(2) paths), accept iff the whole candidate is collision-free
at the same dense sampling the benchmark evaluator uses
(`solver.tracking.evaluate_path`). The chord can't be longer than the
polyline it replaces, so accepted trials shorten the path monotonically;
endpoints never move.

JAX scans the trials of one path and vmaps over paths, drawing each trial's
pair from a split key (`i ~ randint(0, M-2)`, `j ~ randint(i+2, M)`). The
port loops over the trials in Python on the whole batch (plain PyTorch ops,
as the JAX version is plain XLA: no hand-written kernel) and takes the pairs
[T, B, 2] themselves, or a noise source (`ops.sampling.GeneratorNoise`, a
`torch.Generator`) to draw them from; the parity tests hand in JAX's draws.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .math import dense_path, wrap_angle
from .sampling import GeneratorNoise

__all__ = ["shortcut_pairs", "shortcut_trial", "shortcut_batch", "shortcut_path"]

OracleFn = Callable[[Any, torch.Tensor], torch.Tensor]


def shortcut_pairs(noise, num_trials: int, batch: int, m: int, device) -> torch.Tensor:
    """[T, B, 2] int64 pairs (i, j), i uniform in [0, m-2), j uniform in
    [i+2, m), drawn from a noise source's uniform(0, 1) block."""
    if isinstance(noise, torch.Generator):
        noise = GeneratorNoise(noise)
    u = noise.uniform((num_trials, batch, 2), device)
    i = torch.clamp(torch.floor(u[..., 0] * (m - 2)), max=m - 3).to(torch.int64)
    span = m - i - 2  # choices of j
    j = i + 2 + torch.minimum(torch.floor(u[..., 1] * span).to(torch.int64), span - 1)
    return torch.stack([i, j], dim=-1)


def shortcut_trial(
    oracle_fn: OracleFn,
    oracle_params: Any,
    paths: torch.Tensor,
    pair: torch.Tensor,
    samples_per_segment: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One trial on paths [B, M, d] with pairs [B, 2] -> (paths, accepted [B]):
    each path takes its chord candidate iff the candidate is collision-free
    at the evaluator's density (`ops.math.dense_path`)."""
    m = paths.shape[1]
    idx = torch.arange(m, device=paths.device)[None, :]
    i, j = pair[:, :1], pair[:, 1:]
    rows = torch.arange(paths.shape[0], device=paths.device)
    a, b = paths[rows, pair[:, 0]], paths[rows, pair[:, 1]]
    delta = b - a
    if paths.shape[2] == 3:
        delta = torch.cat([delta[:, :2], wrap_angle(delta[:, 2:])], dim=1)
    t = torch.clamp((idx - i) / (j - i), 0.0, 1.0).to(paths.dtype)[..., None]
    chord = a[:, None] + t * delta[:, None]
    inside = ((idx > i) & (idx < j))[..., None]
    candidate = torch.where(inside, chord, paths)
    collides = torch.any(oracle_fn(oracle_params, dense_path(candidate, samples_per_segment)),
                         dim=1)
    return torch.where(collides[:, None, None], paths, candidate), ~collides


def shortcut_batch(
    oracle_fn: OracleFn,
    oracle_params: Any,
    paths: torch.Tensor,
    draws,
    num_trials: int = 64,
    samples_per_segment: int = 5,
) -> torch.Tensor:
    """Shorten paths [B, M, d] (d = 2 or 3) by `num_trials` shortcut
    attempts each. `draws`: the pairs [num_trials, B, 2], or a noise source
    / generator to draw them from (`shortcut_pairs`).

    Every ACCEPTED candidate is whole-path collision-free at the evaluator's
    density, so the output of a feasible input stays feasible. An infeasible
    input usually comes back unchanged, but a chord spanning its entire
    colliding region can REPAIR it: callers re-evaluate the output
    (`bench/runner.py` does).
    """
    batch, m = paths.shape[:2]
    if torch.is_tensor(draws):
        pairs = draws.to(device=paths.device, dtype=torch.int64)
        if tuple(pairs.shape) != (num_trials, batch, 2):
            raise ValueError(f"expected pairs of shape {(num_trials, batch, 2)}, "
                             f"got {tuple(pairs.shape)}")
    else:
        pairs = shortcut_pairs(draws, num_trials, batch, m, paths.device)
    for pair in pairs:
        paths, _ = shortcut_trial(oracle_fn, oracle_params, paths, pair, samples_per_segment)
    return paths


def shortcut_path(
    oracle_fn: OracleFn,
    oracle_params: Any,
    path: torch.Tensor,
    draws,
    num_trials: int = 64,
    samples_per_segment: int = 5,
) -> torch.Tensor:
    """`shortcut_batch` of one path [M, d] (oracle leaves with a leading
    axis of 1; pairs [num_trials, 1, 2] or a noise source)."""
    return shortcut_batch(oracle_fn, oracle_params, path[None], draws, num_trials,
                          samples_per_segment)[0]
