#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nfopp_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build: every kernel from nfopp_tpu_torch/kernels/csrc (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version at the shapes of
     the paths below (B=256 problems, full-width field), with the stated
     tolerances, and timed with CUDA events beside its bound: the f32 kernels
     of the main path; the multi-problem kernels in f32 and bf16, with
     P = 1, 2, 4, 8 problems per program giving identical outputs; the
     collision kernels' bf16 mode; then every kernel on the other field
     configurations at small shapes, in f32 and bf16;
  4. main path: the batched car-scene solve (run_planner_config, f32,
     B=256 x 1000 steps, seeded) through the port's entry points, after a
     one-step CUDA-vs-CPU agreement check on 4 problems (then 100 more steps
     of both, whose drift is logged, not held); each of its four kernels must
     launch once per step, and the feasible fraction must reach 0.98;
  5. bf16 batch path: the same solve in bf16 through the batch-explicit
     ExperimentalConstrainedSolver.run_batch (P=8), after a one-step
     CUDA-vs-CPU agreement check of that path on 4 problems; each of its
     four kernels (onf_multi, field_grad_multi and the collision kernels'
     bf16 mode) must launch once per step, and the feasible fraction must
     reach 0.98.
The last two lines are the card (nvidia-smi) and {"ok": true, "device": ...};
before them, one JSON line lists every kernel with its launches, error and
times, and earlier lines hold each path's numbers and the f32 checks of the
multi-problem kernels.
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
PROBLEMS_PER_PROGRAM = (1, 2, 4, 8)  # P of the multi-problem kernels; 8 on the batch path

# A ReLU unit whose pre-activation lies within KINK_TOL of zero may land on
# either side of the kink in two summation orders; a problem whose ReLU
# gradients miss their bound is recomputed in f64 with every choice of sides
# for up to MAX_KINKS such units (see `hold`).
KINK_TOL = 1e-5
MAX_KINKS = 10

# bf16 outputs. Kernel and plain version round at the same places, so they
# agree at the f32 bounds except where one product's two f32 sums, taken in
# different orders, fall on either side of a bf16 rounding boundary: that
# value then moves by one bf16 ulp, 2^-7 of itself, and carries the move into
# what depends on it. Such ties are rare (a difference of a few f32 ulps has
# to straddle one of the 2^7 rounding boundaries per binade), so an element
# past its f32 bound passes if it is within BF16_ULP times its problem's
# largest magnitude in that output, and at most BF16_TIE_SHARE of an output's
# elements (or BF16_TIE_FLOOR, for small outputs) may need that. A bf16 output
# that misses by more than one bf16 ulp in every problem (a rounding in the
# wrong place) fails the share at B=256.
BF16_ULP = 2.0 ** -7
BF16_TIE_SHARE = 0.01
BF16_TIE_FLOOR = 8

# Peaks by card (NVIDIA data sheets, dense): f32 on the CUDA cores, bf16 on
# the tensor cores, and the memory rate.
CARD_PEAKS = {"H100 PCIe": (51.2e12, 756e12, 2.0e12), "H100 NVL": (60.0e12, 835e12, 3.9e12),
              "H100 SXM": (67.0e12, 989e12, 3.35e12)}

MAIN_PATH = ("onf_forward", "field_grad", "collision_fwd", "collision_bwd")
BATCH_PATH = ("onf_multi", "field_grad_multi", "collision_fwd_bf16", "collision_bwd_bf16")
# each batch-path kernel computes its main-path counterpart's function
COUNTERPART = dict(zip(BATCH_PATH, MAIN_PATH))
REPLACES = {
    "onf_forward": "nfopp_tpu/experimental/pallas/onf_fused.py:73",
    "field_grad": "nfopp_tpu/experimental/pallas/field_grad.py:35",
    "collision_fwd": "nfopp_tpu/experimental/pallas/collision_terms.py:76",
    "collision_bwd": "nfopp_tpu/experimental/pallas/collision_terms.py:99",
    "onf_multi": "nfopp_tpu/experimental/pallas/onf_multi.py:28",
    "field_grad_multi": "nfopp_tpu/experimental/pallas/field_grad_multi.py:32",
    "collision_fwd_bf16": "nfopp_tpu/experimental/pallas/collision_terms.py:76",
    "collision_bwd_bf16": "nfopp_tpu/experimental/pallas/collision_terms.py:99",
}
SOURCES = {
    "onf_forward": "nfopp_tpu_torch/kernels/csrc/onf_forward.cu",
    "field_grad": "nfopp_tpu_torch/kernels/csrc/field_grad.cu",
    "collision_fwd": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
    "collision_bwd": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
    "onf_multi": "nfopp_tpu_torch/kernels/csrc/onf_multi.cu",
    "field_grad_multi": "nfopp_tpu_torch/kernels/csrc/field_grad_multi.cu",
    "collision_fwd_bf16": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
    "collision_bwd_bf16": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_peaks(name: str) -> tuple[str, float, float, float]:
    for key in ("H100 PCIe", "H100 NVL"):
        if key.split()[1] in name:
            return (key, *CARD_PEAKS[key])
    return ("H100 SXM", *CARD_PEAKS["H100 SXM"])


def field_macs(cfg) -> dict:
    """Multiply-adds per point of each kernel's function (transcendentals
    not counted); the bf16 kernels do the same work."""
    f, a, hid = cfg.fourier_features, cfg.angle_features, cfg.hidden
    feat = f + a
    forward = 2 * f + feat * hid + hid * hid + (hid + feat)
    input_back = hid + hid * hid + feat * hid + feat + 2 * f + a
    param_back = (hid + feat) + hid + 2 * hid * hid + 2 * feat * hid + feat + 3 * f + a
    macs = {"onf_forward": forward, "collision_fwd": forward,
            "collision_bwd": forward + input_back, "field_grad": forward + param_back}
    macs.update({name: macs[f32] for name, f32 in COUNTERPART.items()})
    return macs


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


def bounds_of(got, want, rtol: float, atol: float, bf16: bool):
    """|got - want| and its bound, elementwise: atol + rtol |want|, plus under
    bf16 BF16_ULP times each problem's largest |want|."""
    bound = atol + rtol * want.abs()
    if bf16:
        scale = want.abs().reshape(want.shape[0], -1).amax(dim=1)
        bound = bound + BF16_ULP * scale.reshape((-1,) + (1,) * (want.ndim - 1))
    return (got - want).abs(), bound


def within(got, want, rtol: float, atol: float, bf16: bool = False):
    """[B] bool: every element of problem b within its bound (`bounds_of`)."""
    diff, bound = bounds_of(got, want, rtol, atol, bf16)
    return (diff <= bound).reshape(got.shape[0], -1).all(dim=1)


def bf16_round(t):
    """t rounded to bf16 (ties to even) in its own dtype; under autograd the
    cotangent is rounded too, as the backward of a cast is."""
    import torch

    return t.to(torch.bfloat16).to(t.dtype)


def pallas_mm(a, w):
    """a @ w with the TPU multi-problem kernels' casts: both operands rounded
    to bf16, and in the backward both operands of each product rounded, the
    incoming cotangent included, the result not."""
    import torch

    class PallasMM(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, w):
            ar, wr = bf16_round(a), bf16_round(w)
            ctx.save_for_backward(ar, wr)
            return ar @ wr

        @staticmethod
        def backward(ctx, g):
            ar, wr = ctx.saved_tensors
            gr = bf16_round(g)
            return gr @ wr.transpose(-1, -2), ar.transpose(-1, -2) @ gr

    return PallasMM.apply(a, w)


def masked_forward(params, x, cfg, flips=(), casts=None):
    """The field's forward pass (models/onf.py's graph, written out again) on
    one problem in whatever dtype its inputs have, with each ReLU's mask taken
    from its pre-activation and flipped at the (layer, point, unit) entries of
    `flips`. `casts` places the bf16 roundings: None (f32), "multi" (the TPU
    multi-problem kernels': encoding in full precision, `pallas_mm` for the
    rest) or "apply" (onf_apply's: every product's operands, xy and the
    encoding weights too, cast separately at each use, so that autograd rounds
    each cotangent where it passes back through a cast). Returns the logits
    [1, M] and the two pre-activations [1, M, hid]."""
    import torch

    from nfopp_tpu_torch.models import angle_encode

    mm = {None: torch.matmul, "multi": pallas_mm,
          "apply": lambda a, w: bf16_round(a) @ bf16_round(w)}[casts]
    f = cfg.fourier_features
    xy = (x[..., :2] - cfg.mean) / cfg.sigma
    enc = mm(xy, params["encoding"]["w"]) if casts == "apply" else xy @ params["encoding"]["w"]
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
        z = mm(h, params[name]["w"]) + params[name]["b"][:, None]
        mask = z.detach() > 0
        for flip_layer, point, unit in flips:
            if flip_layer == layer:
                mask[0, point, unit] = ~mask[0, point, unit]
        pre.append(z.detach())
        h = z * mask
    logits = mm(torch.cat([h, feats], dim=-1), params["out"]["w"]) + params["out"]["b"][:, None]
    return logits[..., 0], pre


def explain_by_kinks(name, i, got, tols, params, points, cfg, recompute, bf16=False) -> list:
    """The flips (layer, point, unit) under which problem i's f64
    recomputation meets the bounds `tols` against the kernel's outputs `got`;
    raises if no choice of sides for its near-zero ReLU units does."""
    from nfopp_tpu_torch.utils.tree import tree_map

    p = tree_map(lambda t: t[i:i + 1].detach().double(), params)
    x = points[i:i + 1].detach().double()
    _, pre = masked_forward(p, x, cfg, casts=recompute.casts)
    near = [(layer, point, unit) for layer, z in enumerate(pre)
            for _, point, unit in (z.abs() < KINK_TOL).nonzero().tolist()]
    if len(near) > MAX_KINKS:
        raise AssertionError(f"{name}: problem {i} has {len(near)} ReLU units within "
                             f"{KINK_TOL} of zero, more than the {MAX_KINKS} tried")
    for k in range(len(near) + 1):
        for flips in itertools.combinations(near, k):
            want = recompute(p, x, i, flips)
            if all(bool(within(g[i:i + 1].double(), w, *t, bf16).all())
                   for g, w, t in zip(got, want, tols)):
                return list(flips)
    raise AssertionError(
        f"{name}: problem {i} misses its bound, and no choice of sides for its "
        f"{len(near)} ReLU unit(s) within {KINK_TOL} of zero explains it: {near}")


def hold(name, got, want, tols, kinks=None, bf16=False) -> float:
    """Hold each kernel output got[j] [B, ...] to the plain version's want[j]
    elementwise at |got - want| <= atol + rtol |want|, (rtol, atol) = tols[j];
    returns the largest absolute difference.

    bf16: the bound of `bounds_of` with the bf16 tie allowance; at most
    BF16_TIE_SHARE of each output's elements (or BF16_TIE_FLOOR) may need it.

    kinks = (params, points, cfg, recompute), for outputs taken back through
    the field's ReLUs, where recompute(p, x, i, flips) gives problem i's
    outputs in f64 with the ReLU masks flipped at `flips` (and whose `casts`
    attribute names masked_forward's casts). A problem that misses then
    passes only if `explain_by_kinks` finds flips among its units within
    KINK_TOL of zero under which the f64 recomputation meets the same bounds;
    each such problem is logged. Under bf16 the flips found may be none: the
    plain version, not the kernel, sat on the far side of a bf16 rounding.
    """
    import torch

    got = [g.detach() for g in got]
    want = [w.detach() for w in want]
    for g in got:
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output")
    ok = torch.stack([within(g, w, *t, bf16) for g, w, t in zip(got, want, tols)]).all(dim=0)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    missed = (~ok).nonzero().flatten().tolist()
    if missed and kinks is None:
        raise AssertionError(f"{name}: problems {missed} outside the bounds {tols}; "
                             f"largest difference {err:.3g}")
    for i in missed:
        flips = explain_by_kinks(name, i, got, tols, *kinks, bf16=bf16)
        if flips:
            log(f"  {name}: problem {i} (largest difference {err:.3g}) matches an f64 "
                f"recomputation with ReLU sides flipped at (layer, point, unit) {flips}")
        else:  # the plain version, not the kernel, took the far side of a rounding
            log(f"  {name}: problem {i} (largest difference {err:.3g}) matches an f64 "
                "recomputation with no ReLU side flipped")
    if bf16:  # ties, among the problems held by their bounds
        for j, (g, w, (rtol, atol)) in enumerate(zip(got, want, tols)):
            diff, bound = bounds_of(g[ok], w[ok], rtol, atol, bf16=False)
            ties, count = int((diff > bound).sum()), w[ok].numel()
            if ties > max(BF16_TIE_FLOOR, BF16_TIE_SHARE * count):
                raise AssertionError(f"{name}: output {j} has {ties} of {count} elements "
                                     f"past the f32 bound, more than bf16 ties explain")
            if ties:
                log(f"  {name}: output {j}: {ties} of {count} elements within the bf16 "
                    "tie allowance")
    return err


def field_grad_f64(truth, cfg, casts=None):
    """recompute() of `hold` for the field kernels' parameter gradients."""
    import torch

    from nfopp_tpu_torch.ops.losses import bce_with_logits
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map

    def recompute(p, x, i, flips):
        with torch.enable_grad():
            leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
            logits, _ = masked_forward(leaves, x, cfg, flips, casts)
            loss = bce_with_logits(logits, truth[i:i + 1].double())
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss.sum(), flat, allow_unused=True)
        return [torch.zeros_like(q) if g is None else g for q, g in zip(flat, grads)]

    recompute.casts = casts
    return recompute


def collision_f64(mult, weights, cfg, beta, casts=None):
    """recompute() of `hold` for the collision terms' input gradients at the
    cotangents `weights` = (g_softplus, g_tanh)."""
    import torch

    from nfopp_tpu_torch.ops.losses import softplus_beta

    def recompute(p, x, i, flips):
        with torch.enable_grad():
            pos = x.detach().requires_grad_(True)
            mu = mult[i:i + 1].detach().double().requires_grad_(True)
            z, _ = masked_forward(p, pos, cfg, flips, casts)
            total = (float(weights[0]) * softplus_beta(z, beta).sum()
                     + float(weights[1]) * (mu * torch.tanh(z)).sum())
            return list(torch.autograd.grad(total, (pos, mu)))

    recompute.casts = casts
    return recompute


def collision_grads(fn, params, x, mult, cfg, beta, weights):
    """(d positions, d multipliers) of weights[0] * sum softplus + weights[1] *
    sum mu tanh through `fn` (the kernels' autograd Function, or the plain
    version's autograd)."""
    import torch

    pos = x.detach().requires_grad_(True)
    mu = mult.detach().requires_grad_(True)
    a, b = fn(params, pos, mu, cfg, beta)
    return torch.autograd.grad((a * weights[0] + b * weights[1]).sum(), (pos, mu))


class KernelInputs:
    """Seeded inputs at the paths' shapes (B problems, full-width field):
    query points for the scoring pass (M = K + N-1 = 199), the field update
    (M = (N-1) + K + R = 209) and the collision terms (M = N-1 = 99)."""

    def __init__(self, device, seed: int, batch: int):
        import torch

        from nfopp_tpu_torch.models import init_onf_params
        from nfopp_tpu_torch.solver import run_planner_config
        from nfopp_tpu_torch.utils.tree import tree_leaves

        self.cfg = run_planner_config()
        self.onf = self.cfg.onf
        self.onf_bf16 = self.onf._replace(compute_dtype="bfloat16")
        n, k, r = (self.cfg.trajectory_length, self.cfg.collision_point_count,
                   self.cfg.random_field_points)
        self.shapes = {"onf_forward": k + n - 1, "field_grad": (n - 1) + k + r,
                       "collision_fwd": n - 1, "collision_bwd": n - 1}
        self.shapes.update({name: self.shapes[f32] for name, f32 in COUNTERPART.items()})
        g = torch.Generator(device=device).manual_seed(seed)
        self.batch = batch
        self.params = init_onf_params(g, self.onf, batch, device)
        self.n_params = sum(p.numel() for p in tree_leaves(self.params)) // batch

        def points(m):
            u = torch.rand((batch, m, 3), generator=g, device=device)
            return torch.stack([-0.1 + 3.2 * u[..., 0], -0.1 + 3.2 * u[..., 1],
                                u[..., 2] * 6.2831855], dim=-1).contiguous()

        m2 = self.shapes["field_grad"]
        self.x1, self.x2, self.x3 = points(k + n - 1), points(m2), points(n - 1)
        self.truth = torch.rand((batch, m2), generator=g, device=device) > 0.5
        self.mult = torch.rand((batch, n - 1), generator=g, device=device)
        self.beta = self.cfg.collision_beta
        self.weights = torch.tensor([self.cfg.collision_weight, 1.0], device=device)
        self.cot = self.weights.expand(batch, 2).contiguous()


def add_bounds(results: dict, inputs: KernelInputs, peaks) -> None:
    """bound_ms of each kernel in `results`: the larger of operations over the
    peak of their type (f32 CUDA cores, or bf16 tensor cores for the bf16
    kernels) and bytes over the memory rate, for this run's shapes."""
    _, f32_peak, bf16_peak, bytes_rate = peaks
    macs = field_macs(inputs.onf)
    batch = inputs.batch
    param_bytes = 4 * batch * inputs.n_params
    for name, res in results.items():
        m = inputs.shapes[name]
        points_bytes = 4 * batch * m * 3
        moved = {
            "onf_forward": param_bytes + points_bytes + 4 * batch * m,
            "field_grad": 2 * param_bytes + points_bytes + 4 * batch * m + 4 * batch,
            "collision_fwd": param_bytes + points_bytes + 4 * batch * m + 8 * batch,
            "collision_bwd": param_bytes + 2 * points_bytes + 8 * batch * m + 8 * batch,
        }[COUNTERPART.get(name, name)]
        flops = 2.0 * macs[name] * batch * m
        peak = f32_peak if name in MAIN_PATH else bf16_peak
        t_ops, t_bytes = flops / peak * 1e3, moved / bytes_rate * 1e3
        res["bound_ms"] = max(t_ops, t_bytes)
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        res["gflop"] = flops / 1e9
        log(f"kernel {name}: M={m} err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
            f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} ({res['bound_by']})")


def check_collision(inp: "KernelInputs", onf) -> dict:
    """Kernels 3a and 3b (in onf's compute_dtype) against the plain version
    and its autograd at the trajectory loss's cotangents, with the tolerances
    of tests/test_collision_terms.py:34-35 and :50-51; in bf16 the plain
    version has onf_apply's casts, and the bf16 tie allowance applies."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.kernels.collision_terms import collision_bwd, collision_fwd

    params, x3, mult, beta, weights = inp.params, inp.x3, inp.mult, inp.beta, inp.weights
    bf16 = onf.compute_dtype == "bfloat16"
    suffix = "_bf16" if bf16 else ""
    out = collision_fwd(params, x3, mult, onf, beta)
    ref = torch.stack(kernels.collision_terms_plain(params, x3, mult, onf, beta), dim=1)
    results = {"collision_fwd" + suffix: {
        "max_abs_err": hold("collision_fwd" + suffix, [out], [ref], [(1e-5, 1e-5)], bf16=bf16),
        "ms": time_ms(lambda: collision_fwd(params, x3, mult, onf, beta)),
        "plain_ms": time_ms(lambda: kernels.collision_terms_plain(params, x3, mult, onf, beta)),
    }}

    def plain_bwd():
        return collision_grads(kernels.collision_terms_plain, params, x3, mult, onf, beta, weights)

    got = collision_grads(kernels.collision_terms, params, x3, mult, onf, beta, weights)
    recompute = collision_f64(mult, weights, onf, beta, "apply" if bf16 else None)
    results["collision_bwd" + suffix] = {
        "max_abs_err": hold("collision_bwd" + suffix, got, plain_bwd(),
                            [(5e-4, 1e-5), (5e-4, 1e-6)], kinks=(params, x3, onf, recompute),
                            bf16=bf16),
        "ms": time_ms(lambda: collision_bwd(params, x3, mult, inp.cot, onf, beta)),
        "plain_ms": time_ms(plain_bwd),
    }
    return results


def check_kernels(device, peaks, seed: int, batch: int) -> dict:
    """Phase 3, main path: the f32 kernels against their plain versions at the
    main path's shapes."""
    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_leaves

    inp = KernelInputs(device, seed, batch)
    onf, params, x1, x2, truth = inp.onf, inp.params, inp.x1, inp.x2, inp.truth
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

    results.update(check_collision(inp, onf))
    add_bounds(results, inp, peaks)
    return results


def check_batch_kernels(device, peaks, seed: int, batch: int) -> tuple[dict, dict]:
    """Phase 3, bf16 batch path: the multi-problem kernels (f32 and bf16) and
    the collision kernels' bf16 mode against their plain versions at the
    batch path's shapes; every P of PROBLEMS_PER_PROGRAM must give the same
    bits. Returns the bf16 results (the path's kernels) and the f32 checks
    of the multi-problem kernels."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_leaves

    inp = KernelInputs(device, seed + 1, batch)
    params, x1, x2, truth = inp.params, inp.x1, inp.x2, inp.truth
    p_last = PROBLEMS_PER_PROGRAM[-1]
    results, f32 = {}, {}
    for onf in (inp.onf, inp.onf_bf16):
        bf16 = onf.compute_dtype == "bfloat16"
        tag = "bf16" if bf16 else "f32"
        casts = "multi" if bf16 else None
        logits = [kernels.onf_multi(params, x1, onf, p) for p in PROBLEMS_PER_PROGRAM]
        fields = [kernels.field_grad_multi(params, x2, truth, onf, p)
                  for p in PROBLEMS_PER_PROGRAM]
        for p, z, (loss, grads) in zip(PROBLEMS_PER_PROGRAM[1:], logits[1:], fields[1:]):
            first = [logits[0], fields[0][0], *tree_leaves(fields[0][1])]
            same = [torch.equal(a, b) for a, b in zip([z, loss, *tree_leaves(grads)], first)]
            if not all(same):
                raise AssertionError(f"multi-problem kernels ({tag}): P={p} differs from P=1")
        out = results if bf16 else f32
        out["onf_multi"] = {
            "max_abs_err": hold(f"onf_multi {tag}", [logits[0]],
                                [kernels.onf_multi_plain(params, x1, onf)], [(1e-4, 2e-4)],
                                bf16=bf16),
            "ms": time_ms(lambda: kernels.onf_multi(params, x1, onf, p_last)),
            "plain_ms": time_ms(lambda: kernels.onf_multi_plain(params, x1, onf)),
        }
        loss, grads = fields[0]
        ref_loss, ref_grads = kernels.field_grad_multi_plain(params, x2, truth, onf)
        out["field_grad_multi"] = {
            "max_abs_err": max(
                hold(f"field_grad_multi {tag} loss", [loss], [ref_loss], [(1e-5, 1e-6)],
                     bf16=bf16),
                hold(f"field_grad_multi {tag} gradients", tree_leaves(grads),
                     tree_leaves(ref_grads), [(2e-4, 2e-5)] * len(tree_leaves(grads)),
                     kinks=(params, x2, onf, field_grad_f64(truth, onf, casts)), bf16=bf16)),
            "ms": time_ms(lambda: kernels.field_grad_multi(params, x2, truth, onf, p_last)),
            "plain_ms": time_ms(lambda: kernels.field_grad_multi_plain(params, x2, truth, onf)),
        }

    results.update(check_collision(inp, inp.onf_bf16))
    add_bounds(results, inp, peaks)
    for name, res in f32.items():
        log(f"kernel {name} f32: err={res['max_abs_err']:.3g} ms={res['ms']:.4f} "
            f"plain_ms={res['plain_ms']:.4f}")
    return results, f32


def check_configs(device, seed: int) -> dict:
    """Every kernel on the other field configurations (those of the JAX kernel
    tests, tests/test_field_grad_fused.py:13-20, plus bias=False) on small
    shapes that end in partial tiles, against its plain version with the
    tolerances of phase 3: the f32 kernels, the multi-problem kernels in f32
    and bf16, the collision kernels in bf16."""
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
    cot = torch.tensor([3.0, 1.0])
    errors = {}
    for i, base in enumerate(configs):
        params = init_onf_params(g, base, 3, device)
        dim = 3 if base.angle_encoding else 2
        for m in (5, 37):
            x = torch.randn((3, m, dim), generator=g, device=device) * 2
            truth = torch.rand((3, m), generator=g, device=device) > 0.5
            mult = torch.rand((3, m), generator=g, device=device)
            err = 0.0
            for onf in (base, base._replace(compute_dtype="bfloat16")):
                bf16 = onf.compute_dtype == "bfloat16"
                casts = "multi" if bf16 else None
                forward_fns = {"onf_multi": (lambda *a: kernels.onf_multi(*a, 3),
                                             kernels.onf_multi_plain)}
                field_fns = {"field_grad_multi": (lambda *a: kernels.field_grad_multi(*a, 3),
                                                  kernels.field_grad_multi_plain)}
                if not bf16:
                    forward_fns["onf_forward"] = (kernels.onf_forward, kernels.onf_forward_plain)
                    field_fns["field_grad"] = (kernels.field_grad, kernels.field_grad_plain)
                for name, (fn, plain) in forward_fns.items():
                    err = max(err, hold(name, [fn(params, x, onf)], [plain(params, x, onf)],
                                        [(1e-4, 2e-4)], bf16=bf16))
                for name, (fn, plain) in field_fns.items():
                    loss, grads = fn(params, x, truth, onf)
                    ref_loss, ref_grads = plain(params, x, truth, onf)
                    leaves = tree_leaves(grads)
                    err = max(err, hold(f"{name} loss", [loss], [ref_loss], [(1e-5, 1e-6)],
                                        bf16=bf16),
                              hold(f"{name} gradients", leaves, tree_leaves(ref_grads),
                                   [(2e-4, 2e-5)] * len(leaves),
                                   kinks=(params, x, onf, field_grad_f64(truth, onf, casts)),
                                   bf16=bf16))
                sums, grads_in = [], []
                for fn in (kernels.collision_terms, kernels.collision_terms_plain):
                    pos = x.detach().requires_grad_(True)
                    mu = mult.detach().requires_grad_(True)
                    a, b = fn(params, pos, mu, onf, 10.0)
                    sums.append(torch.stack([a, b], dim=1))
                    grads_in.append(torch.autograd.grad((3.0 * a + b).sum(), (pos, mu)))
                casts = "apply" if bf16 else None
                err = max(err, hold("collision sums", [sums[0]], [sums[1]], [(1e-5, 1e-5)],
                                    bf16=bf16),
                          hold("collision gradients", grads_in[0], grads_in[1],
                               [(5e-4, 1e-5), (5e-4, 1e-6)],
                               kinks=(params, x, onf, collision_f64(mult, cot, onf, 10.0, casts)),
                               bf16=bf16))
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


def batch_agreement_check(device, seed: int) -> dict:
    """One step of the bf16 batch path (`_step_batch` with reparametrization,
    P=4) on 4 problems, 10 steps into a solve, through the CUDA kernels and
    through the plain versions on the CPU, from the same state and noise.

    Tolerances: the field loss and the replay buffer come from the entry
    field, as in the f32 check (rtol 1e-4; atol 1e-5), with the bf16 tie
    allowance on the loss. What follows the field's Adam update is held as in
    tests/test_torch_experimental.py's bf16 step: a tie moves one gradient
    element by a bf16 ulp (2^-8 relative, against ~1e-7 in f32), which Adam's
    lr * g / (|g| + eps) can turn into a parameter difference of ~1e-3 when
    the element is near zero, and which the trajectory update then sees
    through the collision terms. So field parameters atol 1e-3, trajectories
    and multipliers atol 1e-4, the trajectory loss rtol 1e-3.
    """
    import torch

    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.ops.sampling import GeneratorNoise
    from nfopp_tpu_torch.solver import run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map
    from nfopp_tpu_torch.worlds import rectangle_collision

    cfg = bf16_config(run_planner_config())
    oracle, start, goal, bounds = car_world(4, device)
    solver = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=device)
    g = torch.Generator().manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    state, _ = solver.run_batch(state, oracle, 10, GeneratorNoise(g), problems_per_program=4)

    outs = []
    for dev in (device, torch.device("cpu")):
        slv = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=dev)
        noise = GeneratorNoise(torch.Generator().manual_seed(seed + 1))
        st, aux = slv._step_batch(tree_map(lambda x: x.to(dev), state), car_world(4, dev)[0],
                                  noise, True, 4)
        outs.append(tree_map(lambda x: x.cpu(), (st, aux)))
    (a, aux_a), (b, aux_b) = outs
    errors = {
        "field_loss": hold("batch field_loss", [aux_a.field_loss], [aux_b.field_loss],
                           [(1e-4, 1e-5)], bf16=True),
        "trajectory_loss": hold("batch trajectory_loss", [aux_a.trajectory_loss],
                                [aux_b.trajectory_loss], [(1e-3, 1e-5)]),
    }
    for name, tol in (("buffer_points", 1e-5), ("buffer_ages", 0.0), ("trajectory", 1e-4),
                      ("collision_multipliers", 1e-4), ("constraint_multipliers", 1e-4)):
        errors[name] = hold(f"batch {name}", [getattr(a, name)], [getattr(b, name)],
                            [(0.0, tol)])
    params = list(zip(tree_leaves(a.field_params), tree_leaves(b.field_params)))
    errors["field_params"] = hold("batch field_params", *zip(*params), [(0.0, 1e-3)] * len(params))
    return errors


def bf16_config(cfg):
    """`cfg` with the field's products in bf16, as bench.py runs by default."""
    return cfg._replace(onf=cfg.onf._replace(compute_dtype="bfloat16"))


def solve(device, seed: int, batch: int, steps: int, path: tuple, bf16_batch: bool):
    """The B x steps car-scene solve through the kernels: the f32 main path
    (ConstrainedSolver.run) or the bf16 batch path (run_batch, P=8). Each
    kernel of `path` must launch once per step and no other kernel at all."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.solver import ConstrainedSolver, evaluate_path, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(batch, device)
    if bf16_batch:
        solver = ExperimentalConstrainedSolver(bf16_config(run_planner_config()),
                                               rectangle_collision, device=device)
    else:
        solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    if bf16_batch:
        state, aux = solver.run_batch(state, oracle, steps, g,
                                      problems_per_program=PROBLEMS_PER_PROGRAM[-1])
    else:
        state, aux = solver.run(state, oracle, steps, g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    for name, count in launches.items():
        if count != (steps if name in path else 0):
            raise AssertionError(f"kernel {name} launched {count} times in {steps} steps "
                                 f"of the path of {path}")
    path_xy = solver.full_trajectory(state)
    n = solver.config.trajectory_length
    if tuple(path_xy.shape) != (batch, n + 2, 3) or not torch.isfinite(path_xy).all():
        raise AssertionError(f"bad trajectories: shape {tuple(path_xy.shape)}")
    if not torch.isfinite(aux.field_loss).all() or not torch.isfinite(aux.trajectory_loss).all():
        raise AssertionError("non-finite losses")
    collides, length = evaluate_path(rectangle_collision, oracle, path_xy)
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
        f"{peaks[1] / 1e12} TFLOP/s f32, {peaks[2] / 1e12} TFLOP/s bf16, {peaks[3] / 1e12} TB/s")

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
    batch_results, multi_f32 = check_batch_kernels(device, peaks, args.seed, BATCH)
    kernel_results.update(batch_results)
    print(json.dumps({"multi_f32": multi_f32}), flush=True)
    log(f"kernels on the other field configs, max abs err: {check_configs(device, args.seed)}")

    # 4. main path
    agreement, drift = agreement_check(device, args.seed)
    log(f"agreement CUDA vs CPU, one step of 4 problems: {agreement}")
    metrics, launches = solve(device, args.seed, BATCH, STEPS, MAIN_PATH, bf16_batch=False)
    metrics.update(build_s=build_s, agreement_max_abs=agreement, card=card,
                   drift_trajectory={d["step"]: d["trajectory"] for d in drift})
    print(json.dumps({"main_path": metrics}), flush=True)

    # 5. bf16 batch path
    agreement = batch_agreement_check(device, args.seed)
    log(f"agreement CUDA vs CPU, one bf16 batch step of 4 problems: {agreement}")
    batch_metrics, batch_launches = solve(device, args.seed, BATCH, STEPS, BATCH_PATH,
                                          bf16_batch=True)
    batch_metrics.update(problems_per_program=PROBLEMS_PER_PROGRAM[-1], compute_dtype="bfloat16",
                         agreement_max_abs=agreement, card=card)
    print(json.dumps({"batch_path": batch_metrics}), flush=True)
    launches.update({name: batch_launches[name] for name in BATCH_PATH})

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
