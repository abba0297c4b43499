"""Batched planning on one device (port of `nfopp_tpu/parallel/`; the mesh
sharding of `parallel/mesh.py` is not ported)."""

from .batch import BatchPlanner

__all__ = ["BatchPlanner"]
