#!/usr/bin/env python3
"""Microbenchmark: each hand-written kernel of the port against its plain
PyTorch twin at the same shapes (the counterpart of
scripts/profile_kernels.py, which times the fused Pallas kernels against
XLA's batched path).

Every field kernel (`tools/time_kernels.py::kernel_calls`: the ONF logits
kernel in f32 and bf16 and its multi-problem bf16 form, the field-gradient
kernel in f32 and bf16 and its multi-problem forms, the collision forward
and backward in f32 and bf16) runs on --batch problems of a full-width field
with --m points each, seed 0, --iters calls per round in three rounds, with
CUDA events after warm-up, beside its plain twin; prints one JSON object of
ms per call (the best round) and µs per call per problem.

    python3 scripts/profile_kernels_torch.py [--batch 256] [--m 209] [--iters 50]
    python3 scripts/profile_kernels_torch.py --device cpu --batch 2 --m 8 --iters 2

--device is cuda unless asked for the CPU, where each wrapper runs its plain
version, so only the plain twins are timed (host clock).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def profile_kernels(device, batch: int, m: int, iters: int, rounds: int = 3) -> dict:
    """{name: {"ms", "plain_ms", "us_per_problem", ...}}; on the CPU only
    the plain twins' host times."""
    from nfopp_tpu_torch.tools.time_kernels import kernel_calls, time_calls

    calls = kernel_calls(device, batch, {"scoring": m, "field": m, "collision": m})
    plain = time_calls({name: p for name, (_, p) in calls.items()}, device, iters, rounds)
    if device.type != "cuda":
        return {name: {"plain_host_ms": min(t)} for name, t in plain.items()}
    kernel = time_calls({name: k for name, (k, _) in calls.items()}, device, iters, rounds)
    return {name: {"ms": min(kernel[name]), "plain_ms": min(plain[name]),
                   "us_per_problem": min(kernel[name]) / batch * 1e3,
                   "plain_us_per_problem": min(plain[name]) / batch * 1e3,
                   "speedup": min(plain[name]) / min(kernel[name])}
            for name in calls}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--m", type=int, default=209, help="points per problem")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()

    import torch

    from nfopp_tpu_torch.tools.scene import card_line
    from nfopp_tpu_torch.utils import enable_compile_cache
    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "profile_kernels_torch")
    if enable_compile_cache(device):
        torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({
        "metric": "kernel_vs_plain_ms", "batch": args.batch, "m": args.m, "iters": args.iters,
        "kernels": profile_kernels(device, args.batch, args.m, args.iters),
        "device": card_line() if device.type == "cuda" else "cpu",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
