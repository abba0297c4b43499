"""Stateful planner API + config-driven factory (port of
`nfopp_tpu/solver/api.py`).

`NFOPPlanner` puts the batched solvers behind the reference's
`ContinuousPlanner` interface (continuous_planner.py:4-27): init / step /
get_path / set_boundaries / update_goal_point / update_start_point. It holds
one problem as a batch of 1. `PlannerFactory` and `DEFAULT_PARAMETERS`
mirror planner_factory.py:11-77: the same AttributeDict schema
(collision_model / collision_optimizer / trajectory_optimizer / planner /
trajectory_initializer sections) builds a solver.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..models.onf import ONFConfig
from ..ops.sampling import GeneratorNoise
from ..utils.config import AttributeDict
from .config import SolverConfig
from .constrained import ConstrainedSolver
from .holonomic import HolonomicSolver

__all__ = ["NFOPPlanner", "PlannerFactory", "DEFAULT_PARAMETERS", "config_from_parameters"]


DEFAULT_PARAMETERS = AttributeDict(
    trajectory_length=100,
    collision_model=AttributeDict(
        mean=0.0, sigma=10.0, use_cos=True, bias=True, use_normal_init=True,
        angle_encoding=False, name="ONF",
    ),
    collision_optimizer=AttributeDict(lr=1e-2, betas=(0.9, 0.9)),
    trajectory_optimizer=AttributeDict(lr=1e-2, betas=(0.9, 0.9)),
    trajectory_initializer=AttributeDict(name="TrajectoryInitializer", resolution=0.05),
    planner=AttributeDict(
        name="ConstrainedNFOPPlanner",
        trajectory_random_offset=0.02,
        collision_weight=1.0,
        velocity_hessian_weight=0.5,
        random_field_points=10,
        init_collision_iteration=0,
        constraint_deltas_weight=0.2,
        multipliers_lr=0.001,
        init_collision_points=100,
        reparametrize_trajectory_freq=10,
        optimize_collision_model_freq=1,
        angle_weight=0.5,
        boundary_weight=1.0,
        collision_multipliers_lr=1e-3,
    ),
)

# planner-section keys, each the name of its SolverConfig field
_PLANNER_KEYS = (
    "trajectory_random_offset", "collision_weight", "velocity_hessian_weight",
    "random_field_points", "init_collision_iteration", "init_collision_points",
    "reparametrize_trajectory_freq", "optimize_collision_model_freq",
    "constraint_deltas_weight", "multipliers_lr", "collision_multipliers_lr", "angle_weight",
    "angle_offset", "boundary_weight", "direction_delta_weight", "collision_beta",
    "course_random_offset", "collision_point_count", "collision_loss_koef",
)


def config_from_parameters(parameters: Mapping) -> SolverConfig:
    """Reference AttributeDict parameter schema -> SolverConfig."""
    p = AttributeDict(parameters)
    model = p.collision_model
    onf = ONFConfig(
        mean=float(model.get("mean", 0.0)),
        sigma=float(model.get("sigma", 1.0)),
        use_cos=bool(model.get("use_cos", True)),
        use_normal_init=bool(model.get("use_normal_init", False)),
        bias=bool(model.get("bias", True)),
        angle_encoding=bool(model.get("angle_encoding", False)),
    )
    kwargs: dict[str, Any] = {
        "trajectory_length": int(p.get("trajectory_length", 100)),
        "onf": onf,
        "collision_lr": float(p.collision_optimizer.get("lr", 1e-2)),
        "collision_betas": tuple(p.collision_optimizer.get("betas", (0.9, 0.9))),
        "trajectory_lr": float(p.trajectory_optimizer.get("lr", 1e-2)),
        "trajectory_betas": tuple(p.trajectory_optimizer.get("betas", (0.9, 0.9))),
    }
    for key in _PLANNER_KEYS:
        if key in p.get("planner", {}):
            kwargs[key] = type(SolverConfig._field_defaults[key])(p.planner[key])
    init_cfg = p.get("trajectory_initializer", {})
    if init_cfg:
        kwargs["init_angles_with_trajectory"] = bool(
            init_cfg.get("init_angles_with_trajectory", False)
        )
    return SolverConfig(**kwargs)


class NFOPPlanner:
    """Stateful front end with the reference `ContinuousPlanner` interface,
    holding one problem as a batch of 1 on the solver's device.

    `oracle_params` are the port's batched oracle (leading axis 1).
    `initial_trajectory_fn(start, goal, length) -> [length, d]` optionally
    overrides the straight-line initializer. `seed` seeds the
    `torch.Generator` (on the solver's device) that every init and step
    draws from. JAX's planner always jits `run` (`api.py:137`); this one
    inits and steps through `solver.with_aot("planner")`, so on the card
    pretraining and every step count (a chunk's multiple from a chunk's
    start, or any other) replay captured programs, and on the CPU they are
    the eager functions. JAX's host-side step counter, which told its `run`
    whether it entered at a chunk's start (`api.py:134-181`), is not needed:
    the port's `run` reads step_count and picks its schedule itself.
    """

    def __init__(
        self,
        solver: ConstrainedSolver | HolonomicSolver,
        oracle_params: Any,
        seed: int = 0,
        initial_trajectory_fn: Callable[[np.ndarray, np.ndarray, int], np.ndarray] | None = None,
    ):
        self._solver = solver
        self._programs = solver.with_aot("planner")
        self._oracle_params = oracle_params
        self._generator = torch.Generator(device=solver.device).manual_seed(seed)
        self._noise = GeneratorNoise(self._generator)
        self._initial_trajectory_fn = initial_trajectory_fn
        self._state = None

    @property
    def state(self):
        return self._state

    @property
    def solver(self):
        return self._solver

    @property
    def aot_events(self) -> list:
        """The programs the planner resolved (see `solver.with_aot`)."""
        return self._programs.aot_events

    def update_oracle(self, oracle_params: Any) -> None:
        """Swap world data (live obstacle updates in service mode)."""
        self._oracle_params = oracle_params

    # ------------------------------------------- ContinuousPlanner interface

    def init(self, start_point, goal_point, boundaries) -> None:
        trajectory = None
        if self._initial_trajectory_fn is not None:
            trajectory = np.asarray(self._initial_trajectory_fn(
                np.asarray(start_point), np.asarray(goal_point),
                self._solver.config.trajectory_length,
            ))[None]
        self._state = self._programs.init_state(
            self._generator,
            np.asarray(start_point, np.float32)[None],
            np.asarray(goal_point, np.float32)[None],
            np.asarray(boundaries, np.float32)[None],
            self._oracle_params,
            trajectory=trajectory,
        )

    def step(self, num_steps: int = 1):
        """Advance the solve; returns the per-step aux diagnostics [1, steps]."""
        self._state, aux = self._programs.run(self._state, self._oracle_params, num_steps,
                                              self._noise)
        return aux

    def get_path(self) -> np.ndarray:
        """The current path [N+2, d] with its pinned endpoints."""
        return self._solver.full_trajectory(self._state)[0].cpu().numpy()

    def set_boundaries(self, boundaries) -> None:
        self._state = self._solver.set_boundaries(
            self._state, np.asarray(boundaries, np.float32)[None])

    def update_goal_point(self, goal_point) -> None:
        self._state = self._solver.update_goal(self._state,
                                               np.asarray(goal_point, np.float32)[None])

    def update_start_point(self, start_point) -> None:
        self._state = self._solver.update_start(self._state,
                                                np.asarray(start_point, np.float32)[None])


class PlannerFactory:
    """Builds planners from the reference's parameter schema."""

    @staticmethod
    def make_constrained_onf_planner(
        oracle_fn, oracle_params, parameters: Mapping | None = None, seed: int = 0,
        initial_trajectory_fn=None, device="cuda",
    ) -> NFOPPlanner:
        """SE(2) constrained planner (planner_factory.py:62-77 equivalent)."""
        if parameters is None:
            parameters = DEFAULT_PARAMETERS
        config = config_from_parameters(parameters)
        solver = ConstrainedSolver(config, oracle_fn, device=device)
        return NFOPPlanner(solver, oracle_params, seed, initial_trajectory_fn)

    @staticmethod
    def make_onf_planner(
        oracle_fn, oracle_params, parameters: Mapping | None = None, seed: int = 0,
        device="cuda",
    ) -> NFOPPlanner:
        """Holonomic planner with the reference's hard-coded demo setup
        (planner_factory.py:50-60) unless parameters are given; the field
        never takes angle features."""
        if parameters is None:
            config = SolverConfig(
                # ONF(1.5, 1): use_normal_init defaults False in the reference
                # ctor (onf_model.py:8) -> U(-1/sqrt(2), 1/sqrt(2)) encoding init
                onf=ONFConfig(mean=1.5, sigma=1.0, use_cos=False,
                              use_normal_init=False, angle_encoding=False),
                collision_lr=1e-3,
                collision_betas=(0.9, 0.9),
                trajectory_lr=1e-2,
                trajectory_betas=(0.9, 0.999),
                trajectory_random_offset=0.02,
                collision_weight=0.01,
                velocity_hessian_weight=3.0,
                random_field_points=10,
                init_collision_iteration=400,
            )
        else:
            config = config_from_parameters(parameters)
        if config.onf.angle_encoding:
            config = config._replace(onf=config.onf._replace(angle_encoding=False))
        solver = HolonomicSolver(config, oracle_fn, device=device)
        return NFOPPlanner(solver, oracle_params, seed)
