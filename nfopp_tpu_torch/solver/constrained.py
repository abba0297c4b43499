"""SE(2) constrained NFOPP solver on a batch of problems (port of
`nfopp_tpu/solver/constrained.py`).

    step = [field update: sample -> oracle -> BCE + grads -> Adam]
           [trajectory update: composite loss -> H^-1-preconditioned Adam
            -> dual ascent on both multiplier vectors]
           [at step counts 0, freq, 2freq, ...: arc-length reparametrization]

Every state tensor has a leading problem axis B, where the JAX package vmaps
a per-problem function; each problem still owns its field, optimizer states,
multipliers and replay buffer. Noise comes from a noise source
(`ops.sampling.GeneratorNoise` by default) in [B, ...] blocks per step, not
from per-problem keys, so a problem's random stream depends on its batch.

On CUDA the three field passes of a step go through the hand-written kernels
(`nfopp_tpu_torch.kernels`): candidate scoring, field loss and gradients, and
the trajectory's collision terms with their backward. On the CPU the same
calls run their plain PyTorch versions.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..kernels import collision_terms
from ..models.onf import init_onf_params, params_from_jax
from ..ops.hessian import inverse_velocity_hessian
from ..ops.losses import (
    boundary_loss,
    direction_constraint_deltas,
    distance_loss_se2,
    non_holonomic_constraint_deltas,
)
from ..ops.math import linspace, wrap_angle
from ..ops.reparametrize import (
    reparametrize_collision_multipliers,
    reparametrize_constraint_multipliers,
    reparametrize_se2,
)
from ..ops.sampling import GeneratorNoise, uniform_box_points
from ..utils.device import check_device
from ..utils.tree import tree_where
from .adam import AdamState, adam_init, adam_update
from .config import SolverConfig
from .field import field_loss_and_grad, sample_field_points
from .schedule import scan_chunked

__all__ = ["ConstrainedState", "StepAux", "ConstrainedSolver", "state_from_jax"]

OracleFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _check_chunkable(name: str, num_steps: int, freq: int) -> None:
    """The batch-explicit run loop has no dynamic fallback: it needs the
    static [reparam + freq-1 plain] chunk schedule (`constrained.py:52-61`)."""
    if freq <= 1:
        raise ValueError(f"{name} requires reparametrize_trajectory_freq > 1")
    if num_steps % freq != 0:
        raise ValueError(
            f"{name} requires num_steps ({num_steps}) to be a multiple of "
            f"reparametrize_trajectory_freq ({freq})"
        )


class ConstrainedState(NamedTuple):
    """Solver state of a batch of problems (every leaf [B, ...])."""

    trajectory: torch.Tensor  # [B, N, 3] interior waypoints (x, y, theta)
    field_params: dict  # ONF parameters
    field_opt_state: AdamState  # Adam state of the field
    traj_opt_state: AdamState  # Adam state of the trajectory
    constraint_multipliers: torch.Tensor  # [B, N+1] non-holonomic multipliers
    collision_multipliers: torch.Tensor  # [B, N] collision multipliers (>= 0)
    buffer_points: torch.Tensor  # [B, K, 3] replay buffer
    buffer_ages: torch.Tensor  # [B, K]
    prev_trajectory: torch.Tensor  # [B, N, 3] snapshot for field sampling
    start: torch.Tensor  # [B, 3]
    goal: torch.Tensor  # [B, 3]
    bounds: torch.Tensor  # [B, 4] (xmin, xmax, ymin, ymax)
    step_count: torch.Tensor  # [B] int32


class StepAux(NamedTuple):
    field_loss: torch.Tensor  # [B] (or [B, steps] from run)
    trajectory_loss: torch.Tensor


def _as_noise(noise):
    return GeneratorNoise(noise) if isinstance(noise, torch.Generator) else noise


class ConstrainedSolver:
    """Hyperparameters, oracle and constants of a batched solve.

    Methods map a batched state to a new one. The oracle is a callable
    `(oracle_params, positions [B, M, 3]) -> bool [B, M]`.
    """

    def __init__(self, config: SolverConfig, oracle_fn: OracleFn, device="cuda"):
        self.config = config
        self.oracle_fn = oracle_fn
        self.device = check_device(device, "ConstrainedSolver")
        n = config.trajectory_length
        self._inv_hessian = torch.as_tensor(
            inverse_velocity_hessian(n, config.velocity_hessian_weight), device=self.device
        )

    def _tensor(self, value) -> torch.Tensor:
        if torch.is_tensor(value):
            return value.to(dtype=torch.float32, device=self.device)
        return torch.tensor(np.asarray(value), dtype=torch.float32, device=self.device)

    def _field_adam(self, grads, opt_state, params):
        b1, b2 = self.config.collision_betas
        return adam_update(grads, opt_state, params, self.config.collision_lr, b1, b2,
                           self.config.adam_eps)

    def _traj_adam(self, grads, opt_state, params):
        b1, b2 = self.config.trajectory_betas
        return adam_update(grads, opt_state, params, self.config.trajectory_lr, b1, b2,
                           self.config.adam_eps)

    # ------------------------------------------------------------------ init

    def initial_trajectory(self, start: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """Straight-line xy + wrapped-delta angle interpolation, [B, N, 3]."""
        m = self.config.trajectory_length + 2
        start, goal = self._tensor(start), self._tensor(goal)
        x = linspace(start[:, 0], goal[:, 0], m)[:, 1:-1]
        y = linspace(start[:, 1], goal[:, 1], m)[:, 1:-1]
        goal_angle = start[:, 2] + wrap_angle(goal[:, 2] - start[:, 2])
        theta = linspace(start[:, 2], goal_angle, m)[:, 1:-1]
        trajectory = torch.stack([x, y, theta], dim=-1)
        if self.config.init_angles_with_trajectory:
            trajectory = self._blend_angles_with_direction(trajectory, start, goal)
        return trajectory

    def _blend_angles_with_direction(self, trajectory, start, goal):
        """Central-difference heading blended in by a triangular ramp."""
        n = trajectory.shape[1]
        full = torch.cat([start[:, None], trajectory, goal[:, None]], dim=1)
        headings = torch.atan2(full[:, 2:, 1] - full[:, :-2, 1], full[:, 2:, 0] - full[:, :-2, 0])
        zero, one = torch.zeros(1, device=self.device), torch.ones(1, device=self.device)
        weights = torch.cat([linspace(zero, one, n // 2)[0], linspace(one, zero, (n + 1) // 2)[0]])
        delta = wrap_angle(headings - trajectory[..., 2]) * weights
        return torch.cat([trajectory[..., :2], (trajectory[..., 2] + delta)[..., None]], dim=-1)

    def init_state(
        self,
        generator: torch.Generator,
        start,
        goal,
        bounds,
        oracle_params: Any,
        trajectory: torch.Tensor | None = None,
    ) -> ConstrainedState:
        """Fresh state for a batch of problems: start/goal [B, 3], bounds [B, 4].

        Field init, the replay buffer's uniform pre-fill and any pretraining
        draw from `generator`.
        """
        cfg = self.config
        start, goal, bounds = self._tensor(start), self._tensor(goal), self._tensor(bounds)
        batch = start.shape[0]
        trajectory = (self.initial_trajectory(start, goal) if trajectory is None
                      else self._tensor(trajectory))
        field_params = init_onf_params(generator, cfg.onf, batch, self.device)
        u = torch.rand((batch, cfg.collision_point_count, 3), generator=generator,
                       device=generator.device).to(self.device)
        n = cfg.trajectory_length
        state = ConstrainedState(
            trajectory=trajectory,
            field_params=field_params,
            field_opt_state=adam_init(field_params),
            traj_opt_state=adam_init(trajectory),
            constraint_multipliers=torch.zeros((batch, n + 1), device=self.device),
            collision_multipliers=torch.zeros((batch, n), device=self.device),
            buffer_points=uniform_box_points(u, bounds, with_angle=True),
            buffer_ages=torch.zeros((batch, cfg.collision_point_count), device=self.device),
            prev_trajectory=trajectory,
            start=start,
            goal=goal,
            bounds=bounds,
            step_count=torch.zeros((batch,), dtype=torch.int32, device=self.device),
        )
        if cfg.init_collision_iteration > 0:
            state = self._pretrain_field(state, oracle_params, generator)
        return state

    def _pretrain_field(self, state, oracle_params, generator) -> ConstrainedState:
        """Field pretraining on uniform random points."""
        cfg = self.config
        params, opt_state = state.field_params, state.field_opt_state
        batch = state.start.shape[0]
        for _ in range(cfg.init_collision_iteration):
            u = torch.rand((batch, cfg.init_collision_points, 3), generator=generator,
                           device=generator.device).to(self.device)
            points = uniform_box_points(u, state.bounds, True)
            truth = self.oracle_fn(oracle_params, points)
            _, grads = field_loss_and_grad(cfg, params, points, truth)
            params, opt_state = self._field_adam(grads, opt_state, params)
        return state._replace(field_params=params, field_opt_state=opt_state)

    # ------------------------------------------------------------------ step

    def full_trajectory(self, state: ConstrainedState) -> torch.Tensor:
        """[B, N+2, 3] trajectories with the pinned endpoints."""
        return torch.cat([state.start[:, None], state.trajectory, state.goal[:, None]], dim=1)

    def step(self, state: ConstrainedState, oracle_params: Any, noise) -> tuple[ConstrainedState, StepAux]:
        """One step with the reference's dynamic schedule, decided per problem
        from step_count (reparametrization computed for all, kept where due)."""
        noise = _as_noise(noise)
        state, field_loss, traj_loss = self._field_and_trajectory(state, oracle_params, noise)
        due = state.step_count % self.config.reparametrize_trajectory_freq == 0
        state = tree_where(due, self._reparametrize(state), state)
        state = state._replace(step_count=state.step_count + 1)
        return state, StepAux(field_loss, traj_loss)

    def _field_and_trajectory(self, state, oracle_params, noise, with_field: bool | None = None):
        """Field update, then the trajectory update that reads the new field.

        with_field: None = config-driven (every step, or where step_count %
        optimize_collision_model_freq == 0); True/False = decided statically.
        """
        cfg = self.config
        batch = state.start.shape[0]
        if with_field is False:
            field_loss = torch.zeros((batch,), device=self.device)
        elif with_field is True or cfg.optimize_collision_model_freq == 1:
            state, field_loss = self._field_step(state, oracle_params, noise)
        else:
            due = state.step_count % cfg.optimize_collision_model_freq == 0
            trained, loss = self._field_step(state, oracle_params, noise)
            state = tree_where(due, trained, state)
            field_loss = torch.where(due, loss, torch.zeros_like(loss))
        state, traj_loss = self._trajectory_step(state, noise)
        return state, field_loss, traj_loss

    def step_static(
        self, state: ConstrainedState, oracle_params: Any, noise, with_reparam: bool,
        with_field: bool | None = None,
    ) -> tuple[ConstrainedState, StepAux]:
        """Step with the reparametrization (and optionally the field update)
        decided by the caller, as `run`'s static schedule does."""
        noise = _as_noise(noise)
        state, field_loss, traj_loss = self._field_and_trajectory(
            state, oracle_params, noise, with_field
        )
        if with_reparam:
            state = self._reparametrize(state)
        state = state._replace(step_count=state.step_count + 1)
        return state, StepAux(field_loss, traj_loss)

    def _field_grads(self, state: ConstrainedState, oracle_params: Any, noise):
        """Sample -> oracle -> BCE loss + parameter grads (no update)."""
        cfg = self.config
        sample = sample_field_points(
            cfg, noise, state.prev_trajectory, state.buffer_points, state.buffer_ages,
            state.field_params, state.bounds,
        )
        truth = self.oracle_fn(oracle_params, sample.train_points)
        loss, grads = field_loss_and_grad(cfg, state.field_params, sample.train_points, truth)
        return sample, loss, grads

    def _apply_field_update(self, state, sample, grads):
        params, opt_state = self._field_adam(grads, state.field_opt_state, state.field_params)
        return state._replace(
            field_params=params,
            field_opt_state=opt_state,
            buffer_points=sample.buffer_points,
            buffer_ages=sample.buffer_ages,
            prev_trajectory=state.trajectory,
        )

    def _field_step(self, state, oracle_params, noise):
        sample, loss, grads = self._field_grads(state, oracle_params, noise)
        return self._apply_field_update(state, sample, grads), loss

    # ------------------------------------------------------- trajectory loss

    def trajectory_loss(
        self,
        trajectory: torch.Tensor,
        constraint_multipliers: torch.Tensor,
        collision_multipliers: torch.Tensor,
        field_params: dict,
        start: torch.Tensor,
        goal: torch.Tensor,
        bounds: torch.Tensor,
        t: torch.Tensor,
    ) -> torch.Tensor:
        """Composite SE(2) objective per problem [B]. `t` [B, N-1, S] holds S
        uniform samples per segment, drawn outside so value and grads share
        them; the collision terms go through the `collision_terms` kernel
        on CUDA."""
        cfg = self.config
        batch = trajectory.shape[0]
        full = torch.cat([start[:, None], trajectory, goal[:, None]], dim=1)

        delta = trajectory[:, :-1] - trajectory[:, 1:]
        delta = torch.cat([delta[..., :2], wrap_angle(delta[..., 2:])], dim=-1)
        samples = t.shape[-1]
        collision_positions = (
            trajectory[:, 1:, None, :] + t[..., None] * delta[:, :, None, :]
        ).reshape(batch, -1, 3)
        multipliers = (
            collision_multipliers[:, 1:, None] * (1.0 - t) + collision_multipliers[:, :-1, None] * t
        ).reshape(batch, -1)
        collision_loss, multiplier_loss = collision_terms(
            field_params, collision_positions, multipliers, cfg.onf, cfg.collision_beta
        )
        collision_loss = collision_loss / samples
        multiplier_loss = multiplier_loss / samples

        constraint_deltas = non_holonomic_constraint_deltas(full)
        direction_deltas = torch.clamp(direction_constraint_deltas(full), min=0.0)

        return (
            distance_loss_se2(full, cfg.angle_weight)
            + collision_loss * cfg.collision_weight
            + torch.sum(constraint_multipliers * constraint_deltas, dim=1)
            + torch.sum(constraint_deltas**2, dim=1) * cfg.constraint_deltas_weight
            + boundary_loss(trajectory, bounds) * cfg.boundary_weight
            + multiplier_loss
            + cfg.direction_delta_weight * torch.sum(direction_deltas**2, dim=1)
        )

    def _trajectory_step(self, state: ConstrainedState, noise) -> tuple[ConstrainedState, torch.Tensor]:
        """Primal step (H^-1-preconditioned Adam) + dual ascent on both
        multiplier vectors (collision multipliers projected onto >= 0)."""
        cfg = self.config
        batch = state.start.shape[0]
        n = cfg.trajectory_length
        t = noise.uniform((batch, n - 1, cfg.collision_samples_per_segment), self.device)
        with torch.enable_grad():
            leaves = [
                x.detach().requires_grad_(True)
                for x in (state.trajectory, state.constraint_multipliers,
                          state.collision_multipliers)
            ]
            loss = self.trajectory_loss(
                *leaves, state.field_params, state.start, state.goal, state.bounds, t
            )
            traj_grad, cons_grad, coll_grad = torch.autograd.grad(loss.sum(), leaves)

        traj_grad = torch.matmul(self._inv_hessian, traj_grad)
        trajectory, opt_state = self._traj_adam(traj_grad, state.traj_opt_state, state.trajectory)
        constraint_multipliers = state.constraint_multipliers + cfg.multipliers_lr * cons_grad
        collision_multipliers = torch.clamp(
            state.collision_multipliers + cfg.collision_multipliers_lr * coll_grad, min=0.0
        )
        return (
            state._replace(
                trajectory=trajectory,
                traj_opt_state=opt_state,
                constraint_multipliers=constraint_multipliers,
                collision_multipliers=collision_multipliers,
            ),
            loss.detach(),
        )

    # -------------------------------------------------------- reparametrize

    def _reparametrize(self, state: ConstrainedState) -> ConstrainedState:
        """Arc-length reparametrization of the trajectory and both
        multiplier vectors."""
        trajectory, interp = reparametrize_se2(self.full_trajectory(state))
        return state._replace(
            trajectory=trajectory,
            collision_multipliers=reparametrize_collision_multipliers(
                state.collision_multipliers, interp
            ),
            constraint_multipliers=reparametrize_constraint_multipliers(
                state.constraint_multipliers, interp
            ),
        )

    # ------------------------------------------------------------- run loop

    def _static_field_stride(self) -> int:
        s = self.config.optimize_collision_model_freq
        freq = self.config.reparametrize_trajectory_freq
        return s if s > 1 and freq % s == 0 else 1

    def run(
        self, state: ConstrainedState, oracle_params: Any, num_steps: int, noise,
    ) -> tuple[ConstrainedState, StepAux]:
        """Run `num_steps` steps; aux is stacked [B, num_steps].

        With num_steps a multiple of reparametrize_trajectory_freq and every
        problem at the start of a chunk (step_count % freq == 0, as after
        init_state / update_* / retarget) the schedule is static
        (`scan_chunked`); otherwise every step decides from step_count
        (`step`). Reading step_count costs one device sync per call.
        """
        noise = _as_noise(noise)
        freq = self.config.reparametrize_trajectory_freq
        aligned = freq > 1 and bool((state.step_count % freq == 0).all())
        if not aligned or num_steps % freq != 0:
            aux = []
            for _ in range(num_steps):
                state, a = self.step(state, oracle_params, noise)
                aux.append(a)
        else:
            stride = self._static_field_stride()

            def step_fn(s, with_reparam, with_field):
                return self.step_static(s, oracle_params, noise, with_reparam,
                                        with_field if stride > 1 else None)

            state, aux = scan_chunked(step_fn, state, num_steps, freq, field_stride=stride)
        return state, StepAux(*(torch.stack(xs, dim=1) for xs in zip(*aux)))

    # ------------------------------------------------- live problem updates

    def update_goal(self, state: ConstrainedState, goal) -> ConstrainedState:
        """Move the goals: clamp each trajectory's tail past its waypoint
        closest to the new goal, reparametrize, reset the schedule."""
        goal = self._tensor(goal)
        dist = torch.sum((state.trajectory[..., :2] - goal[:, None, :2]) ** 2, dim=-1)
        n = state.trajectory.shape[1]
        min_index = torch.clamp(torch.argmin(dist, dim=1) + 1, max=n)
        idx = torch.arange(n, device=self.device)
        tail = (idx[None, :] >= min_index[:, None])[..., None]
        state = state._replace(
            trajectory=torch.where(tail, goal[:, None, :], state.trajectory),
            goal=goal,
            step_count=torch.zeros_like(state.step_count),
        )
        return self._reparametrize(state)

    def update_start(self, state: ConstrainedState, start) -> ConstrainedState:
        """Move the starts (robot pose tracking in anytime mode)."""
        start = self._tensor(start)
        dist = torch.sum((state.trajectory[..., :2] - start[:, None, :2]) ** 2, dim=-1)
        n = state.trajectory.shape[1]
        min_index = torch.clamp(torch.argmin(dist, dim=1) + 1, max=n)
        idx = torch.arange(n, device=self.device)
        head = (idx[None, :] < min_index[:, None])[..., None]
        state = state._replace(
            trajectory=torch.where(head, start[:, None, :], state.trajectory),
            start=start,
            step_count=torch.zeros_like(state.step_count),
        )
        return self._reparametrize(state)

    def retarget(self, state: ConstrainedState, start, goal,
                 trajectory: torch.Tensor | None = None) -> ConstrainedState:
        """New (start, goal) queries on the same maps: rebuild trajectories,
        multipliers and trajectory-optimizer state; keep each learned field,
        its optimizer state and the replay buffer."""
        start, goal = self._tensor(start), self._tensor(goal)
        trajectory = (self.initial_trajectory(start, goal) if trajectory is None
                      else self._tensor(trajectory))
        batch, n = trajectory.shape[0], self.config.trajectory_length
        return state._replace(
            trajectory=trajectory,
            traj_opt_state=adam_init(trajectory),
            constraint_multipliers=torch.zeros((batch, n + 1), device=self.device),
            collision_multipliers=torch.zeros((batch, n), device=self.device),
            prev_trajectory=trajectory,
            start=start,
            goal=goal,
            step_count=torch.zeros((batch,), dtype=torch.int32, device=self.device),
        )


def _adam_from_jax(opt_state, batched: bool, device) -> AdamState:
    """optax.adam's state (ScaleByAdamState, EmptyState) -> AdamState."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))

    def convert(a):
        t = torch.tensor(np.asarray(a), device=device)
        return t if batched else t[None]

    mu = adam.mu
    if isinstance(mu, dict):
        return AdamState(
            convert(np.asarray(adam.count, np.int32)),
            params_from_jax(adam.mu, device), params_from_jax(adam.nu, device),
        )
    return AdamState(convert(np.asarray(adam.count, np.int32)),
                     convert(np.asarray(adam.mu, np.float32)),
                     convert(np.asarray(adam.nu, np.float32)))


def state_from_jax(np_state, device="cuda") -> ConstrainedState:
    """The JAX package's ConstrainedState (numpy leaves, batched or not) ->
    the port's batched state on `device`. The PRNG key is dropped: the
    port's noise comes from a noise source."""
    device = check_device(device, "state_from_jax")
    batched = np.ndim(np_state.trajectory) == 3

    def convert(a, dtype=np.float32):
        t = torch.tensor(np.asarray(a, dtype), device=device)
        return t if batched else t[None]

    return ConstrainedState(
        trajectory=convert(np_state.trajectory),
        field_params=params_from_jax(np_state.field_params, device),
        field_opt_state=_adam_from_jax(np_state.field_opt_state, batched, device),
        traj_opt_state=_adam_from_jax(np_state.traj_opt_state, batched, device),
        constraint_multipliers=convert(np_state.constraint_multipliers),
        collision_multipliers=convert(np_state.collision_multipliers),
        buffer_points=convert(np_state.buffer_points),
        buffer_ages=convert(np_state.buffer_ages),
        prev_trajectory=convert(np_state.prev_trajectory),
        start=convert(np_state.start),
        goal=convert(np_state.goal),
        bounds=convert(np_state.bounds),
        step_count=convert(np_state.step_count, np.int32),
    )
