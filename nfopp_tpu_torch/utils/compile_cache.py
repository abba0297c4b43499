"""The kernel library, built and loaded before any timed work (the
counterpart of `nfopp_tpu/utils/compile_cache.py::enable_tpu_compile_cache`).

JAX's helper turns on XLA's persistent compile cache on an accelerator
backend, so that a warm restart starts without compiling. The port compiles
nothing per shape: what it builds is the kernel library, once per content
key (`kernels/build.py::library_path`: a hash of the CUDA sources and the
flags) into the `.gitignore`d `kernels/build/`, and a kernel's first launch
loads it. `enable_compile_cache` does that before a script's timed work, so
no timing holds the `nvcc` build or the library's load. Scripts call it
where JAX's call `enable_tpu_compile_cache()`.
"""
from __future__ import annotations

from .device import check_device

__all__ = ["enable_compile_cache"]


def enable_compile_cache(device="cuda") -> bool:
    """Build (if its key is missing) and load the kernel library on a CUDA
    device and return True; return False on the CPU, whose plain versions
    need no library. Raises for CUDA without a card. Safe to call again."""
    device = check_device(device, "enable_compile_cache")
    if device.type != "cuda":
        return False
    from ..kernels import build

    build.load_library()
    return True
