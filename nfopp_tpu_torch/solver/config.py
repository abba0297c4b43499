"""Solver hyperparameter configuration (copied from `nfopp_tpu/solver/config.py`).

One hashable NamedTuple covers both the holonomic and the SE(2)-constrained
solver. Field names track the reference constructor arguments
(nerf_opt_planner.py:11-14, constrained_nerf_opt_planner.py:13-18) and the
class defaults match those CONSTRUCTOR defaults (e.g.
constraint_deltas_weight=20, multipliers_lr=1e-1 —
constrained_nerf_opt_planner.py:16-17). The factory preset
`planner_factory.DEFAULT_PARAMETERS` (planner_factory.py:11-46) differs on
those two (0.2 / 1e-3) — use `default_constrained_config()` for factory
parity, `run_planner_config()` / `bench_mr_config()` for the script presets.
Because the config is static under jit, every numeric here is baked into the
compiled step — changing one recompiles.
"""
from __future__ import annotations

from typing import NamedTuple

from ..models.onf import ONFConfig

__all__ = ["SolverConfig", "default_constrained_config", "run_planner_config", "bench_mr_config"]


class SolverConfig(NamedTuple):
    trajectory_length: int = 100  # interior waypoints N (endpoints pinned separately)
    onf: ONFConfig = ONFConfig()
    # optimizers (torch.optim.Adam equivalents, planner_factory.py:55,71-73)
    collision_lr: float = 1e-2
    collision_betas: tuple[float, float] = (0.9, 0.9)
    trajectory_lr: float = 1e-2
    trajectory_betas: tuple[float, float] = (0.9, 0.9)
    adam_eps: float = 1e-8
    # sampling (nerf_opt_planner.py:101-141)
    trajectory_random_offset: float = 0.02  # fine xy jitter sigma
    course_random_offset: float = 1.5  # coarse xy jitter sigma
    angle_offset: float = 0.0  # theta jitter sigma (constrained only)
    random_field_points: int = 10
    collision_point_count: int = 100  # replay buffer capacity K
    buffer_age_decay: float = 0.03  # exp(-decay * age) resampling weight
    # additive resampling-weight floor (ref nerf_opt_planner.py:126 "+ 1e-6");
    # re-diversifies the buffer once the field saturates. 0.0 disables.
    buffer_weight_floor: float = 1e-6
    # losses
    collision_weight: float = 1.0
    collision_loss_koef: float = 1.0
    collision_beta: float = 1.0
    angle_weight: float = 0.5
    constraint_deltas_weight: float = 20.0
    boundary_weight: float = 1.0
    direction_delta_weight: float = 0.0
    # dual ascent
    multipliers_lr: float = 1e-1
    collision_multipliers_lr: float = 1e-3
    # preconditioning
    velocity_hessian_weight: float = 0.5
    # schedule
    init_collision_iteration: int = 0
    init_collision_points: int = 100
    reparametrize_trajectory_freq: int = 10
    optimize_collision_model_freq: int = 1
    # trajectory init
    init_angles_with_trajectory: bool = False
    # Measured-slower structural variants (fused Pallas field kernels, Jacobi
    # step order, merged fwd+bwd step, multi-problem kernels) live in
    # nfopp_tpu.experimental.ExperimentalConstrainedSolver, NOT here — every
    # one was TPU-falsified (BASELINE_MEASURED.md); the production step path
    # is branch-free.
    # lax.scan unroll factor for the plain-step inner loop in `run` (the
    # freq-1 steps between reparametrizations). >1 replicates the step body
    # in the compiled loop, amortizing per-iteration while-loop overhead at
    # the cost of compile time. Numerics identical at any value (same ops,
    # same order; bf16 fusion layout may differ).
    scan_unroll: int = 1
    # unroll factor for the outer chunk scan (each chunk = reparam step +
    # freq-1 plain steps); multiplies the compiled body size accordingly
    outer_scan_unroll: int = 1
    # quality knobs beyond the reference (1 = exact reference behavior)
    collision_samples_per_segment: int = 1  # samples per segment in the
    # trajectory collision loss; >1 reduces corner-slipping (loss scale kept
    # by averaging over samples)

    @property
    def field_batch_size(self) -> int:
        """Points per field-training step: coarse (N-1) + buffer (K) + random (R)."""
        return (self.trajectory_length - 1) + self.collision_point_count + self.random_field_points


def default_constrained_config() -> SolverConfig:
    """DEFAULT_PARAMETERS of the reference factory (planner_factory.py:11-46)."""
    return SolverConfig(
        onf=ONFConfig(mean=0.0, sigma=10.0, use_cos=True, use_normal_init=True,
                      bias=True, angle_encoding=False),
        collision_lr=1e-2,
        trajectory_lr=1e-2,
        constraint_deltas_weight=0.2,
        multipliers_lr=1e-3,
    )


def run_planner_config() -> SolverConfig:
    """The scripts/run_planner.py demo configuration (run_planner.py:14-55)."""
    return SolverConfig(
        onf=ONFConfig(mean=0.0, sigma=1.0, use_cos=True, use_normal_init=True,
                      bias=True, angle_encoding=True),
        collision_lr=5e-2,
        trajectory_lr=1e-2,
        collision_weight=1.0,
        velocity_hessian_weight=0.5,
        constraint_deltas_weight=20.0,
        multipliers_lr=0.1,
        angle_weight=0.5,
        angle_offset=0.3,
        boundary_weight=1.0,
        collision_multipliers_lr=1e-3,
    )


def bench_mr_config() -> SolverConfig:
    """The benchmark-suite configuration (scripts/run_bench_mr.py:20-67)."""
    return SolverConfig(
        onf=ONFConfig(mean=0.0, sigma=10.0, use_cos=True, use_normal_init=True,
                      bias=True, angle_encoding=True),
        collision_lr=2e-2,
        trajectory_lr=5e-2,
        collision_weight=100.0,
        velocity_hessian_weight=0.5,
        constraint_deltas_weight=100.0,
        multipliers_lr=0.1,
        angle_weight=5.0,
        angle_offset=0.3,
        boundary_weight=1.0,
        direction_delta_weight=100.0,
        collision_multipliers_lr=1e-3,
        collision_beta=10.0,
    )
