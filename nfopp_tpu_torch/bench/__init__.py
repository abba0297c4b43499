"""Benchmark evaluation (port of `nfopp_tpu/bench/`): path-quality metrics
(native C++ + numpy), the results schema, the suite runner, the benchmark
adapter (`BenchmarkAdapter`, `BenchmarkCollisionChecker`) and the results
analysis (`analysis`: load, merge, aggregate, tables and plots)."""

from . import analysis, native_binding
from .adapter import BenchmarkAdapter, BenchmarkCollisionChecker
from .metrics import (
    PathStatistics,
    active_evaluator,
    path_statistics,
    path_stats_numpy,
    polygons_to_segments,
    segment_clearance_numpy,
)
from .results import (
    ResultsLog,
    decode_grid_rle,
    encode_grid_rle,
    grid_environment_info,
    serialize_trajectory,
)

__all__ = [
    "analysis",
    "native_binding",
    "BenchmarkAdapter",
    "BenchmarkCollisionChecker",
    "PathStatistics",
    "active_evaluator",
    "path_statistics",
    "path_stats_numpy",
    "polygons_to_segments",
    "segment_clearance_numpy",
    "ResultsLog",
    "decode_grid_rle",
    "encode_grid_rle",
    "grid_environment_info",
    "serialize_trajectory",
]
