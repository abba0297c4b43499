"""Label-based phase timer (the reference's utils/timer.py:7-27 capability;
port of `nfopp_tpu/utils/timer.py`).

CUDA launches are asynchronous, so `tock(..., sync=tensor)` synchronises the
tensor's CUDA device first, and the span covers the device's work, not just
the launches (JAX blocks on the value instead). A global `timer` instance
mirrors the reference's module-global usage pattern.
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["Timer", "timer"]


class Timer:
    def __init__(self):
        self._starts: dict[str, float] = {}
        self._durations: dict[str, list[float]] = defaultdict(list)

    def tick(self, label: str) -> None:
        self._starts[label] = time.perf_counter()

    def tock(self, label: str, sync=None) -> float:
        """Stop `label`; if `sync` is a CUDA tensor, synchronise its device
        first so the measured span covers device execution, not just the
        launches (a CPU tensor is computed already)."""
        if isinstance(sync, torch.Tensor) and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        duration = time.perf_counter() - self._starts[label]
        self._durations[label].append(duration)
        return duration

    def stats(self) -> dict[str, tuple[float, float, int]]:
        """label -> (mean_ms, std_ms, count)."""
        return {
            label: (1e3 * float(np.mean(d)), 1e3 * float(np.std(d)), len(d))
            for label, d in self._durations.items()
        }

    def print(self) -> None:
        for label, (mean_ms, std_ms, count) in sorted(self.stats().items()):
            print(f"{label}: {mean_ms:.3f} ms +- {std_ms:.3f} ms (n={count})")

    def reset(self) -> None:
        self._starts.clear()
        self._durations.clear()


timer = Timer()
