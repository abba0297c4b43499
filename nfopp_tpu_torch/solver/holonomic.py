"""Holonomic (2-D) NFOPP solver on a batch of problems (port of
`nfopp_tpu/solver/holonomic.py`), the reference's base planner.

A [B, N, 2] trajectory per problem, optimized against sum-of-squared deltas
plus the field's collision energy sum softplus(z) at one uniform point per
segment; no multipliers, and a plain lerp reparametrization. The field
update, schedule and run loop are the constrained solver's
(`constrained._FieldSolver`), on 2-wide points: on CUDA the field passes run
the `onf_forward` and `field_grad` kernels, and the collision energy the
`collision_terms` kernels (with zero multipliers and beta = 1).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels import collision_terms
from ..models.onf import params_from_jax
from ..ops.losses import distance_loss
from ..ops.math import linspace
from ..ops.reparametrize import reparametrize_xy
from ..ops.sampling import random_intermediate_positions, uniform_box_points
from ..utils import profiling
from ..utils.device import check_device
from .adam import AdamState, adam_init
from .config import SolverConfig
from .constrained import OracleFn, _adam_from_jax, _FieldSolver

__all__ = ["HolonomicState", "HolonomicSolver", "holonomic_state_from_jax"]


class HolonomicState(NamedTuple):
    """Solver state of a batch of holonomic problems (every leaf [B, ...])."""

    trajectory: torch.Tensor  # [B, N, 2]
    field_params: dict
    field_opt_state: AdamState
    traj_opt_state: AdamState
    buffer_points: torch.Tensor  # [B, K, 2]
    buffer_ages: torch.Tensor  # [B, K]
    prev_trajectory: torch.Tensor  # [B, N, 2]
    start: torch.Tensor  # [B, 2]
    goal: torch.Tensor  # [B, 2]
    bounds: torch.Tensor  # [B, 4]
    step_count: torch.Tensor  # [B] int32


class HolonomicSolver(_FieldSolver):
    """See `ConstrainedSolver`; this is the 2-D unconstrained variant. The
    oracle is a callable `(oracle_params, points [B, M, 2]) -> bool [B, M]`."""

    _pose_dim = 2

    def __init__(self, config: SolverConfig, oracle_fn: OracleFn, device="cuda"):
        if config.onf.angle_encoding:
            raise ValueError("holonomic solver requires angle_encoding=False in ONFConfig")
        super().__init__(config, oracle_fn, device, "HolonomicSolver")

    def initial_trajectory(self, start: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """Straight lines between the endpoints, [B, N, 2]."""
        m = self.config.trajectory_length + 2
        start, goal = self._tensor(start), self._tensor(goal)
        x = linspace(start[:, 0], goal[:, 0], m)[:, 1:-1]
        y = linspace(start[:, 1], goal[:, 1], m)[:, 1:-1]
        return torch.stack([x, y], dim=-1)

    def init_state(
        self,
        generator: torch.Generator,
        start,
        goal,
        bounds,
        oracle_params: Any,
        trajectory: torch.Tensor | None = None,
    ) -> HolonomicState:
        """Fresh state for a batch of problems: start/goal [B, 2], bounds [B, 4];
        field init, the buffer's uniform pre-fill and any pretraining draw
        from `generator`, in that order. On a copy made by `with_aot` the
        pretraining replays its captured iteration (`_pretrain_field`). An
        `init` span, its pretraining a `pretrain` span."""
        with profiling.span("init", batch=len(start)):
            cfg = self.config
            start, goal, bounds = self._tensor(start), self._tensor(goal), self._tensor(bounds)
            batch = start.shape[0]
            trajectory = (self.initial_trajectory(start, goal) if trajectory is None
                          else self._tensor(trajectory))
            field_params = self._init_field(generator, batch)
            u = self._rand(generator, batch, (cfg.collision_point_count, 2))
            state = HolonomicState(
                trajectory=trajectory,
                field_params=field_params,
                field_opt_state=adam_init(field_params),
                traj_opt_state=adam_init(trajectory),
                buffer_points=uniform_box_points(u, bounds, with_angle=False),
                buffer_ages=torch.zeros((batch, cfg.collision_point_count), device=self.device),
                prev_trajectory=trajectory,
                start=start,
                goal=goal,
                bounds=bounds,
                step_count=torch.zeros((batch,), dtype=torch.int32, device=self.device),
            )
            if cfg.init_collision_iteration > 0:
                with profiling.span("pretrain"):
                    state = self._pretrain_field(state, oracle_params, generator)
            return state

    def trajectory_loss(self, trajectory, field_params, start, goal, t) -> torch.Tensor:
        """distance + collision_weight * sum softplus(field) at one point per
        segment, per problem [B]; `t` [B, N-1, 1] drawn outside. The sum goes
        through the `collision_terms` kernel on CUDA (multipliers 0, beta 1)."""
        cfg = self.config
        full = torch.cat([start[:, None], trajectory, goal[:, None]], dim=1)
        positions = random_intermediate_positions(t, trajectory)
        multipliers = torch.zeros(positions.shape[:2], device=positions.device)
        collision, _ = collision_terms(field_params, positions, multipliers, cfg.onf, 1.0)
        return distance_loss(full) + collision * cfg.collision_weight

    def _trajectory_step(self, state: HolonomicState, noise) -> tuple[HolonomicState, torch.Tensor]:
        """H^-1-preconditioned Adam step on the trajectory."""
        batch, n = state.trajectory.shape[:2]
        t = noise.uniform((batch, n - 1, 1), self.device)
        with torch.enable_grad():
            trajectory = state.trajectory.detach().requires_grad_(True)
            loss = self.trajectory_loss(trajectory, state.field_params, state.start,
                                        state.goal, t)
            (traj_grad,) = torch.autograd.grad(loss.sum(), [trajectory])
        traj_grad = torch.matmul(self._inv_hessian, traj_grad)
        trajectory, opt_state = self._traj_adam(traj_grad, state.traj_opt_state, state.trajectory)
        return state._replace(trajectory=trajectory, traj_opt_state=opt_state), loss.detach()

    def _reparametrize(self, state: HolonomicState) -> HolonomicState:
        return state._replace(trajectory=reparametrize_xy(self.full_trajectory(state)))

    def update_goal(self, state: HolonomicState, goal) -> HolonomicState:
        """Move the goals: every waypoint from the one closest to the new goal
        on becomes the goal (no +1 offset, unlike the constrained solver),
        then reparametrize and reset the schedule."""
        goal = self._tensor(goal)
        min_index = torch.argmin(torch.sum((state.trajectory - goal[:, None]) ** 2, dim=-1), dim=1)
        idx = torch.arange(state.trajectory.shape[1], device=self.device)
        tail = (idx[None, :] >= min_index[:, None])[..., None]
        state = state._replace(
            trajectory=torch.where(tail, goal[:, None, :], state.trajectory),
            goal=goal,
            step_count=torch.zeros_like(state.step_count),
        )
        return self._reparametrize(state)

    def update_start(self, state: HolonomicState, start) -> HolonomicState:
        """Move the starts: the waypoints before the one closest to the new
        start become the start (no +1 offset)."""
        start = self._tensor(start)
        min_index = torch.argmin(torch.sum((state.trajectory - start[:, None]) ** 2, dim=-1), dim=1)
        idx = torch.arange(state.trajectory.shape[1], device=self.device)
        head = (idx[None, :] < min_index[:, None])[..., None]
        state = state._replace(
            trajectory=torch.where(head, start[:, None, :], state.trajectory),
            start=start,
            step_count=torch.zeros_like(state.step_count),
        )
        return self._reparametrize(state)


def holonomic_state_from_jax(np_state, device="cuda") -> HolonomicState:
    """The JAX package's HolonomicState (numpy leaves, batched or not) -> the
    port's batched state on `device`; the PRNG key is dropped."""
    device = check_device(device, "holonomic_state_from_jax")
    batched = np.ndim(np_state.trajectory) == 3

    def convert(a, dtype=np.float32):
        t = torch.tensor(np.asarray(a, dtype), device=device)
        return t if batched else t[None]

    return HolonomicState(
        trajectory=convert(np_state.trajectory),
        field_params=params_from_jax(np_state.field_params, device),
        field_opt_state=_adam_from_jax(np_state.field_opt_state, batched, device),
        traj_opt_state=_adam_from_jax(np_state.traj_opt_state, batched, device),
        buffer_points=convert(np_state.buffer_points),
        buffer_ages=convert(np_state.buffer_ages),
        prev_trajectory=convert(np_state.prev_trajectory),
        start=convert(np_state.start),
        goal=convert(np_state.goal),
        bounds=convert(np_state.bounds),
        step_count=convert(np_state.step_count, np.int32),
    )
