"""Experimental solver variants (port of `nfopp_tpu/experimental/`); the
batch-explicit solve `ExperimentalConstrainedSolver.run_batch` is the port's
bf16 path on CUDA."""
from .solver import ExperimentalConstrainedSolver

__all__ = ["ExperimentalConstrainedSolver"]
