"""nfopp_tpu_torch — the NFOPP planner in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of `nfopp_tpu` (JAX on a TPU), which stays beside it as the reference.
This package imports neither JAX nor anything of `nfopp_tpu`. Entry points
run on CUDA unless the caller passes `device="cpu"`, where the kernels'
plain PyTorch versions stand in. `ConstrainedSolver` is the production solve
(f32 on CUDA); `ExperimentalConstrainedSolver.run_batch` is the batch-explicit
solve, which also runs compute_dtype="bfloat16" on CUDA.
"""
from .experimental import ExperimentalConstrainedSolver
from .models import ONFConfig, init_onf_params, onf_apply, params_from_jax
from .solver import (
    ConstrainedSolver,
    ConstrainedState,
    SolverConfig,
    evaluate_path,
    run_planner_config,
    state_from_jax,
)

__all__ = [
    "ONFConfig",
    "init_onf_params",
    "onf_apply",
    "params_from_jax",
    "ConstrainedSolver",
    "ConstrainedState",
    "ExperimentalConstrainedSolver",
    "SolverConfig",
    "evaluate_path",
    "run_planner_config",
    "state_from_jax",
]
