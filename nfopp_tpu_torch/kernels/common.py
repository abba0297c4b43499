"""What the kernel wrappers share: the dispatch rule, the launch counters,
the checks on their inputs and the C view of one batch of fields.

Dispatch rule: a wrapper given CPU tensors computes its plain PyTorch
version; given CUDA tensors it launches its kernel or raises. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.onf import ONFConfig

__all__ = [
    "LAUNCHES", "reset_launches", "NetArgs", "net_args", "use_plain", "is_bf16",
    "check_problems_per_program", "check_points", "check_tensor", "stream",
]

# launches of each kernel, counted by its wrapper where it launches it; the
# collision kernels' bf16 mode counts under its own names
LAUNCHES = {
    "onf_forward": 0, "field_grad": 0, "collision_fwd": 0, "collision_bwd": 0,
    "onf_multi": 0, "field_grad_multi": 0, "collision_fwd_bf16": 0, "collision_bwd_bf16": 0,
}

# wrappers whose kernels are f32 only: the production solver's field passes,
# whose bf16 mode (onf_apply's casts) is a later item of ROADMAP.md
F32_ONLY = ("onf_forward", "field_grad")

# what one CTA holds (csrc/onf_common.cuh): one hidden column per thread
# slot, at most two feature columns per thread slot
MAX_HIDDEN = 128
MAX_FEATURES = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def is_bf16(config: ONFConfig) -> bool:
    """True for compute_dtype 'bfloat16', False for 'float32'; raises otherwise."""
    if config.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}")
    return config.compute_dtype == "bfloat16"


def use_plain(x: torch.Tensor, config: ONFConfig, name: str) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors the
    kernel takes; raises for anything else."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if is_bf16(config) and name in F32_ONLY:
        raise NotImplementedError(
            f"{name}: compute_dtype='bfloat16' on CUDA is not ported for the production "
            "solver's field passes (ROADMAP.md section 1, item 18); the batch-explicit "
            "solve (experimental.ExperimentalConstrainedSolver.run_batch) runs bf16"
        )
    return False


def check_problems_per_program(batch: int, problems_per_program: int) -> None:
    """The TPU kernels' P-problems-per-program contract: B % P == 0."""
    if problems_per_program < 1 or batch % problems_per_program != 0:
        raise ValueError(f"batch {batch} not divisible by {problems_per_program}")


def check_points(x: torch.Tensor, config: ONFConfig, name: str) -> tuple[int, int, int]:
    """Check query points [B, M, dim] for a kernel; returns (B, M, dim)."""
    if x.ndim != 3 or x.shape[1] < 1 or x.shape[2] not in (2, 3):
        raise ValueError(f"{name}: expected points [B, M>=1, 2|3], got {tuple(x.shape)}")
    if config.angle_encoding and x.shape[2] != 3:
        raise ValueError(f"{name}: angle encoding needs (x, y, theta) points")
    check_tensor(name, x, tuple(x.shape), x.device)
    return tuple(x.shape)


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


class NetArgs(ctypes.Structure):
    """Mirror of `struct NetArgs` in csrc/onf_common.cuh."""

    _fields_ = [
        ("ew", ctypes.c_void_p), ("eb", ctypes.c_void_p),
        ("w1", ctypes.c_void_p), ("b1", ctypes.c_void_p),
        ("w2", ctypes.c_void_p), ("b2", ctypes.c_void_p),
        ("w3", ctypes.c_void_p), ("b3", ctypes.c_void_p),
        ("ab", ctypes.c_void_p),
        ("F", ctypes.c_int), ("A", ctypes.c_int), ("HID", ctypes.c_int),
        ("use_cos", ctypes.c_int), ("bias", ctypes.c_int),
        ("mean", ctypes.c_float), ("sigma", ctypes.c_float),
    ]


def net_args(params: dict, config: ONFConfig, batch: int, device: torch.device) -> NetArgs:
    """Check one batch of field parameters and describe it to the kernels."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    f, a, hid = config.fourier_features, config.angle_features, config.hidden
    feat = config.feature_dim
    if hid > MAX_HIDDEN or feat > MAX_FEATURES:
        raise ValueError(
            f"kernels take hidden <= {MAX_HIDDEN} and features <= {MAX_FEATURES}, "
            f"got {hid} and {feat}"
        )
    shapes = {
        ("encoding", "w"): (batch, 2, f), ("encoding", "b"): (batch, f),
        ("mlp1", "w"): (batch, feat, hid), ("mlp1", "b"): (batch, hid),
        ("mlp2", "w"): (batch, hid, hid), ("mlp2", "b"): (batch, hid),
        ("out", "w"): (batch, hid + feat, 1), ("out", "b"): (batch, 1),
    }
    ptr = {}
    for (layer, leaf), shape in shapes.items():
        t = params[layer][leaf]
        check_tensor(f"params[{layer}][{leaf}]", t, shape, device)
        ptr[layer + leaf] = t.data_ptr()
    ab = None
    if config.angle_encoding:
        t = params["angle_biases"]
        check_tensor("params[angle_biases]", t, (batch, a), device)
        ab = t.data_ptr()
    return NetArgs(
        ptr["encodingw"], ptr["encodingb"], ptr["mlp1w"], ptr["mlp1b"],
        ptr["mlp2w"], ptr["mlp2b"], ptr["outw"], ptr["outb"], ab,
        f, a, hid, int(config.use_cos), int(config.bias),
        float(config.mean), float(config.sigma),
    )


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
