"""The main path's scene and the card it runs on.

`car_world` builds the batched car/parking scene of `bench.py` (rectangle
footprint (-0.3, 0.2, -0.3, 0.2), bounds [0, 3]^2); `card_line` is the card's
name and power limit as `nvidia-smi` gives them.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..worlds import RectangleOracle, car_environment, pad_obstacle_points

__all__ = ["car_world", "card_line"]


def car_world(batch: int, device):
    """(oracle, start [B, 3], goal [B, 3], bounds [B, 4]) of `batch` copies of
    the car scene; the oracle's tensors live on `device`, the rest is numpy."""
    env = car_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 64)
    oracle = RectangleOracle(
        torch.tensor(pts, device=device)[None], torch.tensor(mask, device=device)[None],
        torch.tensor([[-0.3, 0.2, -0.3, 0.2]], device=device),
        torch.tensor([[0.0, 3.0, 0.0, 3.0]], device=device),
    )

    def tile(a):
        return np.tile(np.asarray(a, np.float32)[None], (batch, 1))

    return oracle, tile(env.start), tile(env.goal), tile(env.bounds)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of card 0."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
