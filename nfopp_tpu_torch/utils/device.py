"""The device rule of the port's entry points: they take `device=`, default
to "cuda", and raise when there is no card; they never fall back to the CPU."""
from __future__ import annotations

import torch

__all__ = ["check_device"]


def check_device(device, who: str) -> torch.device:
    """`device` as a torch.device; raises if it is CUDA and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return device
