from .adam import AdamState, adam_init, adam_update
from .config import SolverConfig, bench_mr_config, default_constrained_config, run_planner_config
from .constrained import ConstrainedSolver, ConstrainedState, StepAux, state_from_jax
from .holonomic import HolonomicSolver, HolonomicState, holonomic_state_from_jax
from .api import DEFAULT_PARAMETERS, NFOPPlanner, PlannerFactory, config_from_parameters
from .checkpoint import restore_state, save_state
from .tracking import (
    TrackingCarry,
    TrackingResult,
    evaluate_path,
    run_grouped_with_tracking,
    run_tracking_segment,
    run_with_tracking,
    tracking_finalize,
    tracking_init,
)

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "SolverConfig",
    "bench_mr_config",
    "default_constrained_config",
    "run_planner_config",
    "ConstrainedSolver",
    "ConstrainedState",
    "StepAux",
    "state_from_jax",
    "HolonomicSolver",
    "HolonomicState",
    "holonomic_state_from_jax",
    "DEFAULT_PARAMETERS",
    "NFOPPlanner",
    "PlannerFactory",
    "config_from_parameters",
    "restore_state",
    "save_state",
    "TrackingCarry",
    "TrackingResult",
    "evaluate_path",
    "run_grouped_with_tracking",
    "run_tracking_segment",
    "run_with_tracking",
    "tracking_finalize",
    "tracking_init",
]
