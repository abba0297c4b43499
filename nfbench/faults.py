"""Faults planted under the timed path, to show that the check refuses a
broken run: each breaks the program's solver (`ConstrainedSolver`) in one
way. A traffic mix lists the faults its cell can have under "small" ->
"faults" as {name: [fault, method]}; the tests plant each at a small size
on the CPU, and `readings.py --fault <name>` plants one at the cell's own
size on the card.

`plant(spec, patch)` installs a fault; `patch(owner, name, value)` is
pytest's `monkeypatch.setattr`, or plain `setattr` in a process that ends
with the readings.
"""
from __future__ import annotations

import torch


def stale(patch, cls, method):
    """A step that returns its state unchanged (and losses of zero)."""
    from nfopp_tpu_torch.solver import StepAux

    def broken(self, states, oracle, steps, *args, **kw):
        zero = torch.zeros((states.start.shape[0], steps), device=states.start.device)
        return states, StepAux(zero, zero)

    patch(cls, method, broken)


def left_out(share: float):
    """A share of the batch left out: its first rows keep their state."""

    def fault(patch, cls, method):
        from nfopp_tpu_torch.utils.tree import tree_where

        original = getattr(cls, method)

        def broken(self, states, *args, **kw):
            new, aux = original(self, states, *args, **kw)
            rows = states.start.shape[0]
            keep = torch.arange(rows, device=states.start.device) < int(rows * share)
            return tree_where(keep, states, new), aux

        patch(cls, method, broken)

    return fault


def altered(patch, cls, method):
    """The answers altered where they are produced: every path's middle
    waypoint 1 cm off in x."""
    original = getattr(cls, method)

    def broken(self, states, *args, **kw):
        new, aux = original(self, states, *args, **kw)
        trajectory = new.trajectory.clone()
        trajectory[:, trajectory.shape[1] // 2, 0] += 0.01
        return new._replace(trajectory=trajectory), aux

    patch(cls, method, broken)


def mean_of_half(patch, cls, method):
    """The shared field's group mean taken over half of each group."""
    from nfopp_tpu_torch.solver import constrained

    def broken(g, group_size):
        grouped = g.reshape((g.shape[0] // group_size, group_size) + tuple(g.shape[1:]))
        mean = grouped[:, : group_size // 2].mean(dim=1, keepdim=True)
        return mean.expand(grouped.shape).reshape(g.shape)

    patch(constrained, "_group_mean", broken)


FAULTS = {"stale": stale, "half": left_out(0.5), "quarter": left_out(0.25),
          "altered": altered, "mean_of_half": mean_of_half}


def plant(spec: list, patch=setattr) -> None:
    """Install the fault [name, method] on the program's solver."""
    from nfopp_tpu_torch.solver import ConstrainedSolver

    name, method = spec
    FAULTS[name](patch, ConstrainedSolver, method)
