"""The main path's scene, the card it runs on, and a timer on that card.

`car_world` builds the batched car/parking scene of `bench.py` (rectangle
footprint (-0.3, 0.2, -0.3, 0.2), bounds [0, 3]^2); `card_line` is the card's
name and power limit as `nvidia-smi` gives them; `time_ms` times a call with
CUDA events, `timed` one longer run of host and device work.
"""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from ..worlds import RectangleOracle, car_environment, pad_obstacle_points

__all__ = ["car_world", "card_line", "time_ms", "timed"]


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


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of `fn` on the current CUDA stream (CUDA events
    around `iters` calls, after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, device) -> tuple[float, object]:
    """(seconds, fn()): on a CUDA device, CUDA events recorded around the
    call after a synchronize (the end event waits for the last launch); on
    the CPU, the host clock."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out
