"""Benchmark evaluation (port of `nfopp_tpu/bench/`): path-quality metrics
(native C++ + numpy), the results schema and the suite runner. `adapter` and
`analysis` are not ported."""

from . import native_binding
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
    "native_binding",
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
