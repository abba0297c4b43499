"""Time every field kernel on one CUDA card, for comparing two versions of
the kernels on the same card, one after the other.

Times `onf_forward` (f32 and bf16, kernel 1) and `onf_multi` (bf16, kernel
5, P=8) at the candidate scoring's shape (B=256 problems x M=199 points),
`field_grad` (f32 and bf16, kernel 2) and `field_grad_multi` (f32 and bf16,
kernel 4, P=8) at the field update's (B=256 x M=209), and `collision_fwd` /
`collision_bwd` (f32 and bf16, kernels 3a and 3b) at the trajectory's
(B=256 x M=99 poses, the trajectory loss's cotangents), full-width field,
inputs from seed 0, with CUDA events, 50 launches after warm-up, in three
rounds, and prints one JSON object with ms per launch (the best round) and
the card. Run it from the root of the checkout whose kernels it should time
(each checkout builds its own library):

    python3 -m nfopp_tpu_torch.tools.time_kernels

`kernel_calls` and `time_calls` serve `scripts/profile_kernels_torch.py`,
which times each kernel beside its plain PyTorch twin at other shapes.
"""
from __future__ import annotations

import json
import math
import sys
import time

import torch

import nfopp_tpu_torch
from ..kernels import (
    build, collision_terms_plain, field_grad, field_grad_multi, field_grad_multi_plain,
    field_grad_plain, onf_forward, onf_forward_plain, onf_multi, onf_multi_plain,
)
from ..kernels.collision_terms import collision_bwd, collision_fwd
from ..models import init_onf_params
from ..solver import run_planner_config
from .scene import card_line, time_ms

__all__ = ["kernel_calls", "time_calls"]

BATCH, ITERS, ROUNDS = 256, 50, 3


def kernel_calls(device, batch: int, m: dict, seed: int = 0) -> dict:
    """{name: (kernel call, plain twin's call)} of every field kernel at
    `batch` problems and m = {"scoring", "field", "collision"} points, on a
    full-width field and inputs drawn from `seed` on `device`; the
    multi-problem kernels take gcd(batch, 8) problems per program."""
    cfg = run_planner_config()
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_onf_params(g, cfg.onf, batch, device)

    def points(count):
        u = torch.rand((batch, count, 3), generator=g, device=device)
        return torch.stack([-0.1 + 3.2 * u[..., 0], -0.1 + 3.2 * u[..., 1], u[..., 2] * 6.2831855],
                           dim=-1).contiguous()

    x, poses, queries = points(m["field"]), points(m["collision"]), points(m["scoring"])
    truth = torch.rand((batch, m["field"]), generator=g, device=device) > 0.5
    mult = torch.rand((batch, m["collision"]), generator=g, device=device)
    weights = (cfg.collision_weight, 1.0)
    cot = torch.tensor([weights], device=device).expand(batch, 2).contiguous()
    beta = cfg.collision_beta
    onf32, onf16 = cfg.onf, cfg.onf._replace(compute_dtype="bfloat16")
    p = math.gcd(batch, 8)  # problems per program of the multi-problem kernels

    def plain_bwd(onf):
        def call():
            with torch.enable_grad():
                pos, mu = poses.detach().requires_grad_(True), mult.detach().requires_grad_(True)
                a, b = collision_terms_plain(params, pos, mu, onf, beta)
                return torch.autograd.grad((a * weights[0] + b * weights[1]).sum(), (pos, mu))
        return call

    return {
        "onf_forward": (lambda: onf_forward(params, queries, onf32),
                        lambda: onf_forward_plain(params, queries, onf32)),
        "onf_forward_bf16": (lambda: onf_forward(params, queries, onf16),
                             lambda: onf_forward_plain(params, queries, onf16)),
        "onf_multi_bf16": (lambda: onf_multi(params, queries, onf16, p),
                           lambda: onf_multi_plain(params, queries, onf16)),
        "field_grad": (lambda: field_grad(params, x, truth, onf32),
                       lambda: field_grad_plain(params, x, truth, onf32)),
        "field_grad_bf16": (lambda: field_grad(params, x, truth, onf16),
                            lambda: field_grad_plain(params, x, truth, onf16)),
        "field_grad_multi": (lambda: field_grad_multi(params, x, truth, onf32, p),
                             lambda: field_grad_multi_plain(params, x, truth, onf32)),
        "field_grad_multi_bf16": (lambda: field_grad_multi(params, x, truth, onf16, p),
                                  lambda: field_grad_multi_plain(params, x, truth, onf16)),
        "collision_fwd": (lambda: collision_fwd(params, poses, mult, onf32, beta),
                          lambda: collision_terms_plain(params, poses, mult, onf32, beta)),
        "collision_fwd_bf16": (lambda: collision_fwd(params, poses, mult, onf16, beta),
                               lambda: collision_terms_plain(params, poses, mult, onf16, beta)),
        "collision_bwd": (lambda: collision_bwd(params, poses, mult, cot, onf32, beta),
                          plain_bwd(onf32)),
        "collision_bwd_bf16": (lambda: collision_bwd(params, poses, mult, cot, onf16, beta),
                               plain_bwd(onf16)),
    }


def time_calls(fns: dict, device, iters: int = ITERS, rounds: int = ROUNDS) -> dict:
    """{name: [ms per call of each round]}, each name in turn per round: CUDA
    events on a card (5 warm-up calls), the host clock on the CPU."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            if torch.device(device).type == "cuda":
                times[name].append(time_ms(fn, iters, warmup=5))
            else:
                fn()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                times[name].append((time.perf_counter() - t0) / iters * 1e3)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg = run_planner_config()
    m = {"scoring": cfg.collision_point_count + cfg.trajectory_length - 1,
         "field": (cfg.trajectory_length - 1) + cfg.collision_point_count
         + cfg.random_field_points,
         "collision": cfg.trajectory_length - 1}
    build.load_library()
    fns = {name: kernel for name, (kernel, _) in kernel_calls(device, BATCH, m).items()}
    times = time_calls(fns, device)
    print(json.dumps({
        "card": card_line(), "package": nfopp_tpu_torch.__file__, "batch": BATCH,
        "m": m, "library": build.library_path().name,
        "ms": {name: min(t) for name, t in times.items()}, "ms_rounds": times,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
