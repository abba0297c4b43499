"""Batched planning, sharded over a problem mesh of processes (port of
`nfopp_tpu/parallel/`: `mesh.py` over torch.distributed, `batch.py`)."""

from .mesh import (
    BATCH_AXIS,
    ProblemMesh,
    batch_sharding,
    gather_batch,
    initialize_distributed,
    mean_over_problems,
    problem_mesh,
    replicate,
    shard_batch,
)
from .batch import BatchPlanner

__all__ = [
    "BATCH_AXIS",
    "BatchPlanner",
    "ProblemMesh",
    "batch_sharding",
    "gather_batch",
    "initialize_distributed",
    "mean_over_problems",
    "problem_mesh",
    "replicate",
    "shard_batch",
]
