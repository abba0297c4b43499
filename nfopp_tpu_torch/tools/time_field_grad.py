"""Time the field-gradient kernels on one CUDA card, for comparing two
versions of the kernels in one session.

Times `field_grad` (f32 and bf16, kernel 2) and `field_grad_multi` (f32 and
bf16, kernel 4, P=8) at the main path's shape (B=256 problems x M=209
points, full-width field, inputs from seed 0) with CUDA events, 50 launches
after warm-up, in three rounds, and prints one JSON object with ms per
launch (the best round) and the card. Run it from the root of the checkout
whose kernels it should time (each checkout builds its own library):

    python3 -m nfopp_tpu_torch.tools.time_field_grad
"""
from __future__ import annotations

import json
import sys

import torch

import nfopp_tpu_torch
from ..kernels import build, field_grad, field_grad_multi
from ..models import init_onf_params
from ..solver import run_planner_config
from .scene import card_line, time_ms

BATCH, ITERS, ROUNDS = 256, 50, 3


def main() -> int:
    if not torch.cuda.is_available():
        print("time_field_grad: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg = run_planner_config()
    m = (cfg.trajectory_length - 1) + cfg.collision_point_count + cfg.random_field_points
    g = torch.Generator(device=device).manual_seed(0)
    params = init_onf_params(g, cfg.onf, BATCH, device)
    u = torch.rand((BATCH, m, 3), generator=g, device=device)
    x = torch.stack([-0.1 + 3.2 * u[..., 0], -0.1 + 3.2 * u[..., 1], u[..., 2] * 6.2831855],
                    dim=-1).contiguous()
    truth = torch.rand((BATCH, m), generator=g, device=device) > 0.5
    onf32, onf16 = cfg.onf, cfg.onf._replace(compute_dtype="bfloat16")
    fns = {
        "field_grad": lambda: field_grad(params, x, truth, onf32),
        "field_grad_bf16": lambda: field_grad(params, x, truth, onf16),
        "field_grad_multi": lambda: field_grad_multi(params, x, truth, onf32, 8),
        "field_grad_multi_bf16": lambda: field_grad_multi(params, x, truth, onf16, 8),
    }
    build.load_library()
    times = {name: [] for name in fns}
    for _ in range(ROUNDS):  # each kernel in turn
        for name, fn in fns.items():
            times[name].append(time_ms(fn, ITERS, warmup=5))
    print(json.dumps({
        "card": card_line(), "package": nfopp_tpu_torch.__file__, "batch": BATCH, "m": m,
        "library": build.library_path().name,
        "ms": {name: min(t) for name, t in times.items()}, "ms_rounds": times,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
