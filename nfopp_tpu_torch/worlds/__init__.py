from .environments import (
    Environment,
    car_environment,
    two_walls_environment,
    two_walls_se2_environment,
)
from .oracle import (
    CircleOracle,
    GridOracle,
    PolygonOracle,
    RectangleOracle,
    boundary_collision,
    circle_collision,
    grid_collision,
    pad_obstacle_points,
    pad_polygons,
    polygon_clearance,
    polygon_collision,
    rectangle_collision,
)

__all__ = [
    "Environment",
    "car_environment",
    "two_walls_environment",
    "two_walls_se2_environment",
    "CircleOracle",
    "GridOracle",
    "PolygonOracle",
    "RectangleOracle",
    "boundary_collision",
    "circle_collision",
    "grid_collision",
    "pad_obstacle_points",
    "pad_polygons",
    "polygon_clearance",
    "polygon_collision",
    "rectangle_collision",
]
