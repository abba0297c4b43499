from .environments import Environment, car_environment, two_walls_se2_environment
from .oracle import (
    CircleOracle,
    RectangleOracle,
    boundary_collision,
    circle_collision,
    pad_obstacle_points,
    rectangle_collision,
)

__all__ = [
    "Environment",
    "car_environment",
    "two_walls_se2_environment",
    "CircleOracle",
    "RectangleOracle",
    "boundary_collision",
    "circle_collision",
    "pad_obstacle_points",
    "rectangle_collision",
]
