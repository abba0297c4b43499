"""Functional batched Adam, matching `optax.adam(lr, b1, b2, eps)`.

State is a NamedTuple of tensors (so a later caller can `tree_where` over it
or average gradients before the update); `count` is per problem [B].
update = -lr * mu_hat / (sqrt(nu_hat) + eps), with eps outside the square
root and both moments bias-corrected by the step count, as optax does. The
moments and parameters of every leaf move in `kernels.adam_leaves`: one
launch for the whole tree on the card, the plain formula on the CPU.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..kernels.adam import adam_leaves
from ..utils.device import device_constant
from ..utils.tree import tree_leaves, tree_map

__all__ = ["AdamState", "adam_init", "adam_update"]


class AdamState(NamedTuple):
    count: torch.Tensor  # [B] int32 steps taken
    mu: Any  # first moments, shaped like the parameters
    nu: Any  # second moments


def adam_init(params: Any) -> AdamState:
    batch = tree_leaves(params)[0].shape[0]
    device = tree_leaves(params)[0].device
    return AdamState(
        count=torch.zeros((batch,), dtype=torch.int32, device=device),
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
    )


def adam_update(
    grads: Any, state: AdamState, params: Any, lr: float, b1: float, b2: float, eps: float
) -> tuple[Any, AdamState]:
    """One Adam step for a batch of problems: (new params, new state)."""
    count = state.count + 1
    steps = count.to(torch.float32)
    bc1 = 1 - torch.pow(device_constant(b1, steps.device), steps)
    bc2 = 1 - torch.pow(device_constant(b2, steps.device), steps)
    params, mu, nu = adam_leaves(grads, state.mu, state.nu, params, bc1, bc2, lr, b1, b2, eps)
    return params, AdamState(count, mu, nu)
