#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nfopp_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build: every kernel from nfopp_tpu_torch/kernels/csrc (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (B=256 problems, full-width field, f32), with the stated
     tolerances, and timed with CUDA events beside its bound; then on the
     other field configurations at small shapes;
  4. main path: the batched car-scene solve (run_planner_config, f32,
     B=256 x 1000 steps, seeded) through the port's entry points, after a
     one-step CUDA-vs-CPU agreement check on 4 problems (then 100 more steps
     of both, whose drift is logged, not held); every kernel must launch once
     per step, and the feasible fraction must reach 0.98.
The last two lines are the card (nvidia-smi) and {"ok": true, "device": ...};
before them, one JSON line lists every kernel with its launches, error and
times.
"""
from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BATCH, STEPS = 256, 1000  # the bench workload: bench.py's batch and step budget
DRIFT_STEPS = 100  # steps of the CUDA-vs-CPU drift readout after the checked step

# A ReLU unit whose pre-activation lies within KINK_TOL of zero may land on
# either side of the kink in two summation orders; a problem whose ReLU
# gradients miss their bound is recomputed in f64 with every choice of sides
# for up to MAX_KINKS such units (see `hold`).
KINK_TOL = 1e-5
MAX_KINKS = 10

# f32 CUDA-core peak and memory rate by card (NVIDIA data sheets, dense).
CARD_PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60.0e12, 3.9e12),
              "H100 SXM": (67.0e12, 3.35e12)}

REPLACES = {
    "onf_forward": "nfopp_tpu/experimental/pallas/onf_fused.py:73",
    "field_grad": "nfopp_tpu/experimental/pallas/field_grad.py:35",
    "collision_fwd": "nfopp_tpu/experimental/pallas/collision_terms.py:76",
    "collision_bwd": "nfopp_tpu/experimental/pallas/collision_terms.py:99",
}
SOURCES = {
    "onf_forward": "nfopp_tpu_torch/kernels/csrc/onf_forward.cu",
    "field_grad": "nfopp_tpu_torch/kernels/csrc/field_grad.cu",
    "collision_fwd": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
    "collision_bwd": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_peaks(name: str) -> tuple[str, float, float]:
    for key in ("H100 PCIe", "H100 NVL"):
        if key.split()[1] in name:
            return (key, *CARD_PEAKS[key])
    return ("H100 SXM", *CARD_PEAKS["H100 SXM"])


def field_macs(cfg) -> dict:
    """Multiply-adds per point of each kernel's function (transcendentals
    not counted)."""
    f, a, hid = cfg.fourier_features, cfg.angle_features, cfg.hidden
    feat = f + a
    forward = 2 * f + feat * hid + hid * hid + (hid + feat)
    input_back = hid + hid * hid + feat * hid + feat + 2 * f + a
    param_back = (hid + feat) + hid + 2 * hid * hid + 2 * feat * hid + feat + 3 * f + a
    return {"onf_forward": forward, "collision_fwd": forward,
            "collision_bwd": forward + input_back, "field_grad": forward + param_back}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

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


def within(got, want, rtol: float, atol: float):
    """[B] bool: every element of problem b has |got - want| <= atol + rtol |want|."""
    ok = (got - want).abs() <= atol + rtol * want.abs()
    return ok.reshape(got.shape[0], -1).all(dim=1)


def masked_forward(params, x, cfg, flips=()):
    """The field's forward pass (models/onf.py's graph, written out again) on
    one problem in whatever dtype its inputs have, with each ReLU's mask taken
    from its pre-activation and flipped at the (layer, point, unit) entries of
    `flips`. Returns the logits [1, M] and the two pre-activations [1, M, hid]."""
    import torch

    from nfopp_tpu_torch.models import angle_encode

    f = cfg.fourier_features
    enc = ((x[..., :2] - cfg.mean) / cfg.sigma) @ params["encoding"]["w"]
    if cfg.bias:
        enc = enc + params["encoding"]["b"][:, None]
    enc = (torch.cat([torch.sin(enc[..., :f // 2]), torch.cos(enc[..., f // 2:])], dim=-1)
           if cfg.use_cos else torch.sin(enc))
    feats = enc
    if cfg.angle_encoding:
        angle = angle_encode(params["angle_biases"], x[..., 2], cfg.angle_harmonics)
        feats = torch.cat([enc, angle], dim=-1)
    h, pre = feats, []
    for layer, name in enumerate(("mlp1", "mlp2")):
        z = h @ params[name]["w"] + params[name]["b"][:, None]
        mask = z.detach() > 0
        for flip_layer, point, unit in flips:
            if flip_layer == layer:
                mask[0, point, unit] = ~mask[0, point, unit]
        pre.append(z.detach())
        h = z * mask
    logits = torch.cat([h, feats], dim=-1) @ params["out"]["w"] + params["out"]["b"][:, None]
    return logits[..., 0], pre


def explain_by_kinks(name, i, got, tols, params, points, cfg, recompute) -> list:
    """The flips (layer, point, unit) under which problem i's f64
    recomputation meets the bounds `tols` against the kernel's outputs `got`;
    raises if no choice of sides for its near-zero ReLU units does."""
    from nfopp_tpu_torch.utils.tree import tree_map

    p = tree_map(lambda t: t[i:i + 1].detach().double(), params)
    x = points[i:i + 1].detach().double()
    _, pre = masked_forward(p, x, cfg)
    near = [(layer, point, unit) for layer, z in enumerate(pre)
            for _, point, unit in (z.abs() < KINK_TOL).nonzero().tolist()]
    if len(near) > MAX_KINKS:
        raise AssertionError(f"{name}: problem {i} has {len(near)} ReLU units within "
                             f"{KINK_TOL} of zero, more than the {MAX_KINKS} tried")
    for k in range(len(near) + 1):
        for flips in itertools.combinations(near, k):
            want = recompute(p, x, i, flips)
            if all(bool(within(g[i:i + 1].double(), w, *t).all())
                   for g, w, t in zip(got, want, tols)):
                return list(flips)
    raise AssertionError(
        f"{name}: problem {i} misses its bound, and no choice of sides for its "
        f"{len(near)} ReLU unit(s) within {KINK_TOL} of zero explains it: {near}")


def hold(name, got, want, tols, kinks=None) -> float:
    """Hold each kernel output got[j] [B, ...] to the plain version's want[j]
    elementwise at |got - want| <= atol + rtol |want|, (rtol, atol) = tols[j];
    returns the largest absolute difference.

    kinks = (params, points, cfg, recompute), for outputs taken back through
    the field's ReLUs, where recompute(p, x, i, flips) gives problem i's
    outputs in f64 with the ReLU masks flipped at `flips`. A problem that
    misses then passes only if `explain_by_kinks` finds flips among its
    units within KINK_TOL of zero under which the f64 recomputation meets
    the same bounds; each such problem is logged.
    """
    import torch

    got = [g.detach() for g in got]
    want = [w.detach() for w in want]
    for g in got:
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output")
    ok = torch.stack([within(g, w, *t) for g, w, t in zip(got, want, tols)]).all(dim=0)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    missed = (~ok).nonzero().flatten().tolist()
    if missed and kinks is None:
        raise AssertionError(f"{name}: problems {missed} outside the bounds {tols}; "
                             f"largest difference {err:.3g}")
    for i in missed:
        flips = explain_by_kinks(name, i, got, tols, *kinks)
        log(f"  {name}: problem {i} (largest difference {err:.3g}) matches an f64 "
            f"recomputation with ReLU sides flipped at (layer, point, unit) {flips}")
    return err


def field_grad_f64(truth, cfg):
    """recompute() of `hold` for the field kernel's parameter gradients."""
    import torch

    from nfopp_tpu_torch.ops.losses import bce_with_logits
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map

    def recompute(p, x, i, flips):
        with torch.enable_grad():
            leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
            logits, _ = masked_forward(leaves, x, cfg, flips)
            loss = bce_with_logits(logits, truth[i:i + 1].double())
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss.sum(), flat, allow_unused=True)
        return [torch.zeros_like(q) if g is None else g for q, g in zip(flat, grads)]

    return recompute


def collision_f64(mult, weights, cfg, beta):
    """recompute() of `hold` for the collision terms' input gradients at the
    cotangents `weights` = (g_softplus, g_tanh)."""
    import torch

    from nfopp_tpu_torch.ops.losses import softplus_beta

    def recompute(p, x, i, flips):
        with torch.enable_grad():
            pos = x.detach().requires_grad_(True)
            mu = mult[i:i + 1].detach().double().requires_grad_(True)
            z, _ = masked_forward(p, pos, cfg, flips)
            total = (float(weights[0]) * softplus_beta(z, beta).sum()
                     + float(weights[1]) * (mu * torch.tanh(z)).sum())
            return list(torch.autograd.grad(total, (pos, mu)))

    return recompute


def check_kernels(device, peaks, seed: int, batch: int) -> dict:
    """Phase 3: every kernel against its plain version at the main path's shapes."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.kernels.collision_terms import collision_bwd, collision_fwd
    from nfopp_tpu_torch.models import init_onf_params
    from nfopp_tpu_torch.solver import run_planner_config
    from nfopp_tpu_torch.utils.tree import tree_leaves

    cfg = run_planner_config()
    onf = cfg.onf
    n, k, r = cfg.trajectory_length, cfg.collision_point_count, cfg.random_field_points
    shapes = {"onf_forward": k + n - 1, "field_grad": (n - 1) + k + r,
              "collision_fwd": n - 1, "collision_bwd": n - 1}
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_onf_params(g, onf, batch, device)
    n_params = sum(p.numel() for p in tree_leaves(params)) // batch

    def points(m):
        u = torch.rand((batch, m, 3), generator=g, device=device)
        return torch.stack([-0.1 + 3.2 * u[..., 0], -0.1 + 3.2 * u[..., 1],
                            u[..., 2] * 6.2831855], dim=-1).contiguous()

    x1, x2, x3 = points(shapes["onf_forward"]), points(shapes["field_grad"]), points(n - 1)
    truth = torch.rand((batch, shapes["field_grad"]), generator=g, device=device) > 0.5
    mult = torch.rand((batch, n - 1), generator=g, device=device)
    beta = cfg.collision_beta
    weights = torch.tensor([cfg.collision_weight, 1.0], device=device)
    cot = weights.expand(batch, 2).contiguous()
    results = {}

    # kernel 1: forward (tolerance of tests/test_pallas.py:32)
    got = kernels.onf_forward(params, x1, onf)
    want = kernels.onf_forward_plain(params, x1, onf)
    results["onf_forward"] = {
        "max_abs_err": hold("onf_forward", [got], [want], [(1e-4, 2e-4)]),
        "ms": time_ms(lambda: kernels.onf_forward(params, x1, onf)),
        "plain_ms": time_ms(lambda: kernels.onf_forward_plain(params, x1, onf)),
    }

    # kernel 2: loss + every parameter gradient (tests/test_field_grad_fused.py:33-46)
    loss, grads = kernels.field_grad(params, x2, truth, onf)
    ref_loss, ref_grads = kernels.field_grad_plain(params, x2, truth, onf)
    results["field_grad"] = {
        "max_abs_err": max(
            hold("field_grad loss", [loss], [ref_loss], [(1e-5, 1e-6)]),
            hold("field_grad gradients", tree_leaves(grads), tree_leaves(ref_grads),
                 [(2e-4, 2e-5)] * len(tree_leaves(grads)),
                 kinks=(params, x2, onf, field_grad_f64(truth, onf)))),
        "ms": time_ms(lambda: kernels.field_grad(params, x2, truth, onf)),
        "plain_ms": time_ms(lambda: kernels.field_grad_plain(params, x2, truth, onf)),
    }

    # kernel 3a: the two sums (tests/test_collision_terms.py:34-35)
    out = collision_fwd(params, x3, mult, onf, beta)
    ref = torch.stack(kernels.collision_terms_plain(params, x3, mult, onf, beta), dim=1)
    results["collision_fwd"] = {
        "max_abs_err": hold("collision_fwd", [out], [ref], [(1e-5, 1e-5)]),
        "ms": time_ms(lambda: collision_fwd(params, x3, mult, onf, beta)),
        "plain_ms": time_ms(lambda: kernels.collision_terms_plain(params, x3, mult, onf, beta)),
    }

    # kernel 3b: input gradients at the trajectory loss's cotangents
    # (tests/test_collision_terms.py:50-51); the plain version is autograd
    def plain_bwd():
        pos = x3.detach().requires_grad_(True)
        mu = mult.detach().requires_grad_(True)
        a, b = kernels.collision_terms_plain(params, pos, mu, onf, beta)
        return torch.autograd.grad((a * weights[0] + b * weights[1]).sum(), (pos, mu))

    def kernel_grads():  # through the autograd Function, as the solver calls it
        pos = x3.detach().requires_grad_(True)
        mu = mult.detach().requires_grad_(True)
        a, b = kernels.collision_terms(params, pos, mu, onf, beta)
        return torch.autograd.grad((a * weights[0] + b * weights[1]).sum(), (pos, mu))

    dpos, dmult = kernel_grads()
    ref_dpos, ref_dmult = plain_bwd()
    results["collision_bwd"] = {
        "max_abs_err": hold("collision_bwd", [dpos, dmult], [ref_dpos, ref_dmult],
                            [(5e-4, 1e-5), (5e-4, 1e-6)],
                            kinks=(params, x3, onf, collision_f64(mult, weights, onf, beta))),
        "ms": time_ms(lambda: collision_bwd(params, x3, mult, cot, onf, beta)),
        "plain_ms": time_ms(plain_bwd),
    }

    # bounds: the larger of operations over the f32 peak and bytes over the
    # memory rate, for this run's shapes
    _, flops_peak, bytes_rate = peaks
    macs = field_macs(onf)
    param_bytes = 4 * batch * n_params
    for name, m in shapes.items():
        points_bytes = 4 * batch * m * 3
        moved = {
            "onf_forward": param_bytes + points_bytes + 4 * batch * m,
            "field_grad": 2 * param_bytes + points_bytes + 4 * batch * m + 4 * batch,
            "collision_fwd": param_bytes + points_bytes + 4 * batch * m + 8 * batch,
            "collision_bwd": param_bytes + 2 * points_bytes + 8 * batch * m + 8 * batch,
        }[name]
        flops = 2.0 * macs[name] * batch * m
        t_ops, t_bytes = flops / flops_peak * 1e3, moved / bytes_rate * 1e3
        results[name]["bound_ms"] = max(t_ops, t_bytes)
        results[name]["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        results[name]["gflop"] = flops / 1e9
        log(f"kernel {name}: M={m} err={results[name]['max_abs_err']:.3g} "
            f"ms={results[name]['ms']:.4f} plain_ms={results[name]['plain_ms']:.4f} "
            f"bound_ms={results[name]['bound_ms']:.4f}")
    return results


def check_configs(device, seed: int) -> dict:
    """The kernels' other field configurations (those of the JAX kernel tests,
    tests/test_field_grad_fused.py:13-20, plus bias=False) on small shapes
    that end in partial tiles: each kernel against its plain version, with
    the tolerances of phase 3."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.models import ONFConfig, init_onf_params
    from nfopp_tpu_torch.utils.tree import tree_leaves

    configs = [
        ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True),
        ONFConfig(mean=1.0, sigma=3.0, use_cos=True, angle_encoding=False),
        ONFConfig(mean=0.0, sigma=1.0, use_cos=False, angle_encoding=False),
        ONFConfig(mean=0.5, sigma=2.0, use_cos=True, angle_encoding=True, bias=False),
    ]
    g = torch.Generator(device=device).manual_seed(seed)
    errors = {}
    for i, onf in enumerate(configs):
        params = init_onf_params(g, onf, 3, device)
        dim = 3 if onf.angle_encoding else 2
        for m in (5, 37):
            x = torch.randn((3, m, dim), generator=g, device=device) * 2
            truth = torch.rand((3, m), generator=g, device=device) > 0.5
            mult = torch.rand((3, m), generator=g, device=device)
            err = hold("onf_forward", [kernels.onf_forward(params, x, onf)],
                       [kernels.onf_forward_plain(params, x, onf)], [(1e-4, 2e-4)])
            loss, grads = kernels.field_grad(params, x, truth, onf)
            ref_loss, ref_grads = kernels.field_grad_plain(params, x, truth, onf)
            err = max(err, hold("field_grad loss", [loss], [ref_loss], [(1e-5, 1e-6)]),
                      hold("field_grad gradients", tree_leaves(grads), tree_leaves(ref_grads),
                           [(2e-4, 2e-5)] * len(tree_leaves(grads)),
                           kinks=(params, x, onf, field_grad_f64(truth, onf))))
            sums, grads_in = [], []
            for fn in (kernels.collision_terms, kernels.collision_terms_plain):
                pos = x.detach().requires_grad_(True)
                mu = mult.detach().requires_grad_(True)
                a, b = fn(params, pos, mu, onf, 10.0)
                sums.append(torch.stack([a, b]))
                grads_in.append(torch.autograd.grad((3.0 * a + b).sum(), (pos, mu)))
            cot = torch.tensor([3.0, 1.0])
            err = max(err, hold("collision sums", [sums[0]], [sums[1]], [(1e-5, 1e-5)]),
                      hold("collision gradients", grads_in[0], grads_in[1],
                           [(5e-4, 1e-5), (5e-4, 1e-6)],
                           kinks=(params, x, onf, collision_f64(mult, cot, onf, 10.0))))
            errors[f"config{i}_m{m}"] = err
    return errors


def agreement_check(device, seed: int) -> tuple[dict, list]:
    """One solver step (field update, trajectory update, reparametrization)
    of 4 problems, 10 steps into a solve, through the CUDA kernels and through
    the plain versions on the CPU, from the same state and the same noise;
    then DRIFT_STEPS more steps of both, whose largest differences are
    logged and returned at steps 1-5 and every 10th, not held to a bound.

    Tolerances of the checked step: trajectories, multipliers and the replay
    buffer atol 1e-5, losses rtol 1e-4, field parameters atol 1e-4. Adam's
    update lr * g / (|g| + eps) turns rounding-level differences of near-zero
    gradients into parameter differences up to ~1e-4, and over many steps
    such differences can flip a Gumbel top-k pick, after which the two solves
    part ways (the drift readout shows how far they get), so the long run is
    judged by its feasible fraction instead.
    """
    import torch

    from nfopp_tpu_torch.ops.sampling import GeneratorNoise
    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map
    from nfopp_tpu_torch.worlds import rectangle_collision

    cfg = run_planner_config()
    oracle, start, goal, bounds = car_world(4, device)
    solver = ConstrainedSolver(cfg, rectangle_collision, device=device)
    g = torch.Generator().manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    state, _ = solver.run(state, oracle, 10, GeneratorNoise(g))

    runs = []  # [solver, state, oracle, noise] on the card, then on the CPU
    for dev in (device, torch.device("cpu")):
        runs.append([ConstrainedSolver(cfg, rectangle_collision, device=dev),
                     tree_map(lambda x: x.to(dev), state), car_world(4, dev)[0],
                     GeneratorNoise(torch.Generator().manual_seed(seed + 1))])
    errors, drift = {}, []
    for k in range(1 + DRIFT_STEPS):
        outs = []
        for run in runs:
            slv, st, orc, noise = run
            with_reparam = k % cfg.reparametrize_trajectory_freq == 0
            run[1], aux = slv.step_static(st, orc, noise, with_reparam=with_reparam)
            outs.append(tree_map(lambda x: x.cpu(), (run[1], aux)))
        (a, aux_a), (b, aux_b) = outs
        params = list(zip(tree_leaves(a.field_params), tree_leaves(b.field_params)))
        if k == 0:
            for name in ("trajectory", "collision_multipliers", "constraint_multipliers",
                         "buffer_points", "buffer_ages"):
                errors[name] = hold(name, [getattr(a, name)], [getattr(b, name)], [(0.0, 1e-5)])
            for name in aux_a._fields:
                errors[name] = hold(name, [getattr(aux_a, name)], [getattr(aux_b, name)],
                                    [(1e-4, 1e-5)])
            errors["field_params"] = hold("field_params", *zip(*params),
                                          [(0.0, 1e-4)] * len(params))
            continue
        if k > 5 and k % 10:
            continue
        step = {"step": k, "field_params": max(float((x - y).abs().max()) for x, y in params)}
        for name in ("trajectory", "buffer_points", "collision_multipliers"):
            step[name] = float((getattr(a, name) - getattr(b, name)).abs().max())
        log(f"  drift CUDA vs CPU after {k} more steps: {step}")
        drift.append(step)
    return errors, drift


def main_path(device, seed: int, batch: int, steps: int) -> tuple[dict, dict]:
    """Phase 4: the B x steps car-scene solve through the kernels."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.solver import ConstrainedSolver, evaluate_path, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(batch, device)
    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    state, aux = solver.run(state, oracle, steps, g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    for name, count in launches.items():
        if count != steps:
            raise AssertionError(f"kernel {name} launched {count} times in {steps} steps")
    path = solver.full_trajectory(state)
    n = solver.config.trajectory_length
    if tuple(path.shape) != (batch, n + 2, 3) or not torch.isfinite(path).all():
        raise AssertionError(f"bad trajectories: shape {tuple(path.shape)}")
    if not torch.isfinite(aux.field_loss).all() or not torch.isfinite(aux.trajectory_loss).all():
        raise AssertionError("non-finite losses")
    collides, length = evaluate_path(rectangle_collision, oracle, path)
    feasible = float((~collides).float().mean())
    metrics = {
        "batch": batch, "steps": steps, "seconds": seconds,
        "us_per_step_per_problem": seconds / steps / batch * 1e6,
        "solves_per_s": batch / seconds,
        "feasible_fraction": feasible,
        "mean_length_feasible": float(length[~collides].mean()) if feasible > 0 else None,
        "final_field_loss": float(aux.field_loss[:, -1].mean()),
    }
    if feasible < 0.98:
        raise AssertionError(f"feasible fraction {feasible} below the 0.98 floor")
    return metrics, launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of weights, data and noise")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script measures the card and has no CPU mode")
        return 2
    sys.path.insert(0, str(ROOT))
    from nfopp_tpu_torch.kernels import build
    from nfopp_tpu_torch.tools.scene import card_line

    # 1. device
    card = card_line()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card_peaks(card)
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks of {peaks[0]}: "
        f"{peaks[1] / 1e12} TFLOP/s f32, {peaks[2] / 1e12} TB/s")

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f}s -> {build.library_path().name}")
    ptxas = build.library_path().with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.strip())

    # 3. kernels against their plain versions
    kernel_results = check_kernels(device, peaks, args.seed, BATCH)
    log(f"kernels on the other field configs, max abs err: {check_configs(device, args.seed)}")

    # 4. main path
    agreement, drift = agreement_check(device, args.seed)
    log(f"agreement CUDA vs CPU, one step of 4 problems: {agreement}")
    metrics, launches = main_path(device, args.seed, BATCH, STEPS)
    metrics.update(build_s=build_s, agreement_max_abs=agreement, card=card,
                   drift_trajectory={d["step"]: d["trajectory"] for d in drift})
    print(json.dumps({"main_path": metrics}), flush=True)

    entries = []
    for name, res in kernel_results.items():
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
