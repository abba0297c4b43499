from .adam import AdamState, adam_init, adam_update
from .config import SolverConfig, bench_mr_config, default_constrained_config, run_planner_config
from .constrained import ConstrainedSolver, ConstrainedState, StepAux, state_from_jax
from .tracking import evaluate_path

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
    "evaluate_path",
]
