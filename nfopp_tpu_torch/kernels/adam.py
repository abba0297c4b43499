"""Adam's update of every leaf of a tree of batched parameters in one launch.

Replaces no TPU kernel: on the TPU, XLA fuses optax's update. Source in
`csrc/adam.cu`. `solver/adam.py::adam_update` computes the step counts and
bias corrections and calls `adam_leaves` for the leaves: on the main path
once for the field and once for the trajectory of every step, and once per
pretraining iteration. Its launches count under "adam".

The kernel rounds once per PyTorch operation of `adam_leaves_plain`, in the
same order and with the same f32 scalars, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Any

import torch

from ..utils.tree import tree_leaves, tree_map
from . import build
from .common import LAUNCHES, check_tensor, stream

__all__ = ["adam_leaves", "adam_leaves_plain", "launch_adam", "MAX_LEAVES"]

MAX_LEAVES = 16  # leaves of one launch (csrc/adam.cu); a larger tree takes more launches


class _Leaf(ctypes.Structure):
    """Mirror of `struct AdamLeaf` in csrc/adam.cu."""

    _fields_ = [(name, ctypes.c_void_p)
                for name in ("g", "m", "v", "p", "m_out", "v_out", "p_out")] + [
        ("numel", ctypes.c_longlong), ("row_size", ctypes.c_longlong)]


def adam_leaves_plain(
    grads: Any, mu: Any, nu: Any, params: Any, bc1: torch.Tensor, bc2: torch.Tensor,
    lr: float, b1: float, b2: float, eps: float,
) -> tuple[Any, Any, Any]:
    """Plain PyTorch version: (new params, new mu, new nu) for trees whose
    leaves are [rows, ...], with the bias corrections bc1, bc2 [rows]."""
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, nu)

    def step(p, m, v):
        shape = (-1,) + (1,) * (p.ndim - 1)
        m_hat = m / bc1.reshape(shape)
        v_hat = v / bc2.reshape(shape)
        return p + (-lr) * (m_hat / (torch.sqrt(v_hat) + eps))

    return tree_map(step, params, mu, nu), mu, nu


def adam_leaves(
    grads: Any, mu: Any, nu: Any, params: Any, bc1: torch.Tensor, bc2: torch.Tensor,
    lr: float, b1: float, b2: float, eps: float,
) -> tuple[Any, Any, Any]:
    """(new params, new mu, new nu): Adam's update of every leaf [rows, ...]
    of `params` by the same leaf of `grads`, with moments `mu` and `nu` and
    each row's bias corrections bc1, bc2 [rows]. The results are new
    tensors; the inputs are not written. CPU tensors take the plain version;
    on CUDA every leaf must be contiguous float32 on bc1's device."""
    device = bc1.device
    if device.type == "cpu":
        return adam_leaves_plain(grads, mu, nu, params, bc1, bc2, lr, b1, b2, eps)
    if device.type != "cuda":
        raise ValueError(f"adam: unsupported device {device}")
    rows = bc1.shape[0]
    check_tensor("adam bc1", bc1, (rows,), device)
    check_tensor("adam bc2", bc2, (rows,), device)
    trees = [tree_leaves(tree) for tree in (grads, mu, nu, params)]
    if len({len(leaves) for leaves in trees}) != 1:
        raise ValueError(f"adam: trees of {[len(leaves) for leaves in trees]} leaves")
    leaves = list(zip(*trees))
    for i, leaf in enumerate(leaves):
        p = leaf[-1]
        if p.ndim < 1 or p.shape[0] != rows:
            raise ValueError(f"adam: a leaf {tuple(p.shape)} beside {rows} rows of count")
        for name, t in zip(("grads", "mu", "nu", "params"), leaf):
            check_tensor(f"adam {name} leaf {i}", t, tuple(p.shape), device)
    outs = launch_adam(build.load_library(), leaves, bc1, bc2, lr, b1, b2, eps, stream())

    def rebuild(k: int, tree: Any) -> Any:
        new = iter([out[k] for out in outs])
        return tree_map(lambda _: next(new), tree)

    return rebuild(2, params), rebuild(0, mu), rebuild(1, nu)


def launch_adam(lib, leaves: list, bc1: torch.Tensor, bc2: torch.Tensor, lr: float, b1: float,
                b2: float, eps: float, stream_handle) -> list:
    """`lib.nf_adam` over checked leaves (g, m, v, p), each [rows, ...]
    contiguous float32 with bc1, bc2 [rows], MAX_LEAVES to a launch, each
    launch counted under "adam". Returns each leaf's fresh (m', v', p')."""
    rows = bc1.shape[0]
    outs, entries = [], []
    for leaf in leaves:
        p = leaf[-1]
        out = tuple(torch.empty_like(p) for _ in range(3))
        outs.append(out)
        if p.numel():
            entries.append(_Leaf(*(t.data_ptr() for t in tuple(leaf) + out), p.numel(),
                                 p.numel() // rows))
    for lo in range(0, len(entries), MAX_LEAVES):
        chunk = entries[lo:lo + MAX_LEAVES]
        code = lib.nf_adam((_Leaf * len(chunk))(*chunk), len(chunk), bc1.data_ptr(),
                           bc2.data_ptr(), 1 - b1, b1, 1 - b2, b2, eps, -lr, stream_handle)
        build.check(code, "adam")
        LAUNCHES["adam"] += 1
    return outs
