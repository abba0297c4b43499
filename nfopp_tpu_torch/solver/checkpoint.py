"""Solver-state checkpointing (port of `nfopp_tpu/solver/checkpoint.py`).

Any state tree of the port (dicts, NamedTuples and tuples of tensors: a
solver state, a `TrackingCarry`) serializes to one .npz, each leaf named by
its path in the tree; `restore_state` rebuilds a template's structure from
it, on the template's devices. The port's state has no PRNG key (JAX carries
one in the state): `save_state` takes the noise generator and stores its
state, and `restore_state` sets it back, so a restored solve goes on drawing
the same noise and continues exactly as the uninterrupted one.
"""
from __future__ import annotations

import pathlib
from typing import Any

import numpy as np
import torch

from ..utils.tree import tree_map, tree_named_leaves

__all__ = ["save_state", "restore_state"]

_GENERATOR = "__generator__"


def save_state(state: Any, path: str | pathlib.Path,
               generator: torch.Generator | None = None) -> pathlib.Path:
    """Write a state tree (and the state of `generator`, if given) to
    `path` (.npz); device tensors are copied to the host."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    named = tree_named_leaves(state)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, (_, leaf) in enumerate(named)}
    arrays["__names__"] = np.asarray([name for name, _ in named])
    if generator is not None:
        arrays[_GENERATOR] = generator.get_state().numpy()
    np.savez_compressed(path, **arrays)
    return path


def restore_state(template: Any, path: str | pathlib.Path,
                  generator: torch.Generator | None = None) -> Any:
    """Rebuild a state tree with `template`'s structure, dtypes and devices
    from a checkpoint; sets `generator` to the saved generator state.

    Leaf names and shapes must match the template (same solver config and
    batch size): a mismatch raises with the leaf named.
    """
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        named = tree_named_leaves(template)
        names = [name for name, _ in named]
        saved_names = [str(n) for n in data["__names__"]]
        if saved_names != names:
            diff = next(((a, b) for a, b in zip(saved_names, names) if a != b),
                        (saved_names[len(names):len(names) + 1],
                         names[len(saved_names):len(saved_names) + 1]))
            raise ValueError(
                f"checkpoint structure mismatch: saved {len(saved_names)} leaves, "
                f"template has {len(names)}; first difference (saved, template): {diff}"
            )
        values = []
        for i, (name, leaf) in enumerate(named):
            value = data[f"leaf_{i}"]
            if value.shape != tuple(leaf.shape):
                raise ValueError(f"leaf {name}: checkpoint shape {value.shape} != template "
                                 f"{tuple(leaf.shape)}")
            values.append(torch.from_numpy(value).to(device=leaf.device, dtype=leaf.dtype))
        if generator is not None:
            if _GENERATOR not in data.files:
                raise ValueError("the checkpoint holds no generator state")
            generator.set_state(torch.from_numpy(data[_GENERATOR]))
    leaves = iter(values)
    return tree_map(lambda _: next(leaves), template)
