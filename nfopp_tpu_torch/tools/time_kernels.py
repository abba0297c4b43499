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
"""
from __future__ import annotations

import json
import sys

import torch

import nfopp_tpu_torch
from ..kernels import build, field_grad, field_grad_multi, onf_forward, onf_multi
from ..kernels.collision_terms import collision_bwd, collision_fwd
from ..models import init_onf_params
from ..solver import run_planner_config
from .scene import card_line, time_ms

BATCH, ITERS, ROUNDS = 256, 50, 3


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg = run_planner_config()
    m_field = (cfg.trajectory_length - 1) + cfg.collision_point_count + cfg.random_field_points
    m_traj = cfg.trajectory_length - 1
    m_score = cfg.collision_point_count + cfg.trajectory_length - 1
    g = torch.Generator(device=device).manual_seed(0)
    params = init_onf_params(g, cfg.onf, BATCH, device)

    def points(m):
        u = torch.rand((BATCH, m, 3), generator=g, device=device)
        return torch.stack([-0.1 + 3.2 * u[..., 0], -0.1 + 3.2 * u[..., 1], u[..., 2] * 6.2831855],
                           dim=-1).contiguous()

    x, poses, queries = points(m_field), points(m_traj), points(m_score)
    truth = torch.rand((BATCH, m_field), generator=g, device=device) > 0.5
    mult = torch.rand((BATCH, m_traj), generator=g, device=device)
    cot = torch.tensor([[cfg.collision_weight, 1.0]], device=device).expand(BATCH, 2).contiguous()
    beta = cfg.collision_beta
    onf32, onf16 = cfg.onf, cfg.onf._replace(compute_dtype="bfloat16")
    fns = {
        "onf_forward": lambda: onf_forward(params, queries, onf32),
        "onf_forward_bf16": lambda: onf_forward(params, queries, onf16),
        "onf_multi_bf16": lambda: onf_multi(params, queries, onf16, 8),
        "field_grad": lambda: field_grad(params, x, truth, onf32),
        "field_grad_bf16": lambda: field_grad(params, x, truth, onf16),
        "field_grad_multi": lambda: field_grad_multi(params, x, truth, onf32, 8),
        "field_grad_multi_bf16": lambda: field_grad_multi(params, x, truth, onf16, 8),
        "collision_fwd": lambda: collision_fwd(params, poses, mult, onf32, beta),
        "collision_fwd_bf16": lambda: collision_fwd(params, poses, mult, onf16, beta),
        "collision_bwd": lambda: collision_bwd(params, poses, mult, cot, onf32, beta),
        "collision_bwd_bf16": lambda: collision_bwd(params, poses, mult, cot, onf16, beta),
    }
    build.load_library()
    times = {name: [] for name in fns}
    for _ in range(ROUNDS):  # each kernel in turn
        for name, fn in fns.items():
            times[name].append(time_ms(fn, ITERS, warmup=5))
    print(json.dumps({
        "card": card_line(), "package": nfopp_tpu_torch.__file__, "batch": BATCH,
        "m": {"scoring": m_score, "field": m_field, "collision": m_traj}, "library": build.library_path().name,
        "ms": {name: min(t) for name, t in times.items()}, "ms_rounds": times,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
