"""nfopp_tpu_torch — the NFOPP planner in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of `nfopp_tpu` (JAX on a TPU), which stays beside it as the reference.
This package imports neither JAX nor anything of `nfopp_tpu`. Entry points
run on CUDA unless the caller passes `device="cpu"`, where the kernels'
plain PyTorch versions stand in. `ConstrainedSolver` is the production solve,
in f32 or with compute_dtype="bfloat16" (onf_apply's casts), with its
shared-field group mode (`run_grouped`) and the tracked (anytime) loops of
`solver.tracking`; `HolonomicSolver` is the 2-D solve; `NFOPPlanner` /
`PlannerFactory` the stateful planner API; `ExperimentalConstrainedSolver.
run_batch` is the batch-explicit solve, in f32 or bf16 with the TPU
multi-problem kernels' casts. `service` holds the replanning services
(`ReplanningService`, `FleetReplanningService`, `WorldState`) and the
scripted replanning sessions over them. `parallel` shards a batch over a
problem mesh of processes, one per card (`torch.distributed`), and
`graft_entry` holds the entry points `entry` and `dryrun_multichip`.
"""
from . import service
from .experimental import ExperimentalConstrainedSolver
from .models import ONFConfig, init_onf_params, onf_apply, params_from_jax
from .solver import (
    ConstrainedSolver,
    ConstrainedState,
    HolonomicSolver,
    NFOPPlanner,
    PlannerFactory,
    SolverConfig,
    evaluate_path,
    run_planner_config,
    run_with_tracking,
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
    "HolonomicSolver",
    "NFOPPlanner",
    "PlannerFactory",
    "SolverConfig",
    "evaluate_path",
    "run_planner_config",
    "run_with_tracking",
    "state_from_jax",
    "service",
]
