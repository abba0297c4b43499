"""The device rule of the port's entry points: they take `device=`, default
to "cuda", and raise when there is no card; they never fall back to the CPU.
`device_constant` holds the small constants a step reads on its device."""
from __future__ import annotations

import functools

import torch

__all__ = ["check_device", "device_constant"]


def check_device(device, who: str) -> torch.device:
    """`device` as a torch.device; raises if it is CUDA and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return device


@functools.lru_cache(maxsize=None)
def device_constant(value: float | tuple, device: torch.device) -> torch.Tensor:
    """`torch.tensor(value, dtype=float32, device=device)`, built once per
    value and device and shared: a step reads it without copying from the
    host, which a captured step (`utils/aot.py`) may not do. Never write to
    it."""
    return torch.tensor(value, dtype=torch.float32, device=device)
