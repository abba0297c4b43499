"""Experimental solver variants (port of `nfopp_tpu/experimental/`): the
batch-explicit solve `ExperimentalConstrainedSolver.run_batch`, the
`jacobi_step` order and the merged field+trajectory step (`merged_step`,
`merged_step.py`)."""
from .solver import ExperimentalConstrainedSolver

__all__ = ["ExperimentalConstrainedSolver"]
