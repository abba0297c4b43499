"""Grid search initializers: host A*/JPS + the batched wavefront on the
device (port of `nfopp_tpu/astar/`)."""

from .grid_search import GridSearch, astar, jump_point_search
from .initializer import AstarTrajectoryInitializer, batched_wavefront_trajectories
from .wavefront import distance_field, extract_path, wavefront_path

__all__ = [
    "GridSearch",
    "astar",
    "jump_point_search",
    "AstarTrajectoryInitializer",
    "batched_wavefront_trajectories",
    "distance_field",
    "extract_path",
    "wavefront_path",
]
