"""Experimental solver variants (port of `nfopp_tpu/experimental/`): the
batch-explicit solve `ExperimentalConstrainedSolver.run_batch` and
`jacobi_step`."""
from .solver import ExperimentalConstrainedSolver

__all__ = ["ExperimentalConstrainedSolver"]
