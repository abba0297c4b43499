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
     of the main path and their bf16 mode (onf_apply's casts); the
     multi-problem kernels in f32 and bf16, with P = 1, 2, 4, 8 problems per
     program giving identical outputs; the collision kernels' bf16 mode; two
     launches of each kernel giving identical bits; then every kernel on the
     other field configurations at small shapes, in f32 and bf16, and the
     forward and collision-backward kernels at the widest fields they take;
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
     reach 0.98;
  6. bf16 main path: ConstrainedSolver.run in bf16 (bench.py's default
     precision), B=256 x 1000 steps, after a one-step CUDA-vs-CPU agreement
     check on 4 problems; each of its four kernels (the bf16 mode of
     onf_forward, field_grad and the collision kernels) must launch once per
     step, and the feasible fraction must reach 0.98;
  7. tracked path: run_with_tracking in bf16 with bench.py's anytime settings
     (ANYTIME), B=256; each bf16 kernel must launch once per step actually
     run (chunks x 50), and the feasible fraction must reach 0.98;
  8. grouped path: init_state(group_size=8) and run_grouped_with_tracking in
     f32, B=256 (32 groups of 8 restarts), 1000 steps; each f32 kernel once
     per step, the replicas of every group bit-identical at the end, and the
     feasible fraction at least 0.98;
  9. holonomic path and planner API: HolonomicSolver.run with
     make_onf_planner's config on the two-walls scene, B=256 x 1000 steps,
     each f32 kernel once per step on 2-wide points (the feasible fraction is
     printed, not held); the constrained planner (DEFAULT_PARAMETERS: no angle
     features on SE(2) poses) and the holonomic planner, one problem each,
     through init, 1000 steps, moved goal and start, new bounds and 50 more
     steps, with their endpoints pinned; and a checkpoint of phase 7's tracked
     solve, restored and resumed bit for bit;
 10. benchmark suite: run_grid_suite on the corridor suite as its users run
     it (256 worlds of scripts/run_benchmark_torch.py, geodesic >= 120,
     bench_parameters, f32, 8 restarts per failure, 128 shortcut trials,
     the native evaluator); each f32 kernel launches once per step run of
     each solve and the field-gradient kernel also once per pretraining
     iteration of each init, paths are finite with pinned endpoints, the
     feasible fraction after the restart round must reach 0.98, and the
     wavefront init on the card must equal its CPU run bit for bit; its
     launches join the f32 kernels' counts in the kernel line.
 11. replanning services (nfopp_tpu_torch.service, through the three driver
     scripts' functions), each f32 kernel (bf16 in f) launched once per step
     run: (a) the dynamic demo's host loop, 40 ticks of WorldState ->
     ReplanningService with a 0.08 s budget, clear of the true disc, each
     raw path from the pose it was fed to the goal; (b) fleet_replan_session
     in the users' serving shape (256 robots, 2 sub-fleets of 128 with one
     shared field each, 20-step bursts, 2 goals x 25 cycles), replicas
     bit-identical, goals exact, final plans >= 0.98 feasible; (c) 16 robots
     in 2 sub-fleets against two independent sessions at
     tests/test_session.py's tolerances; (d) replan_session of one robot,
     2 goals x 10 cycles x 40 steps, endpoints pinned; (e) the dynamic
     sessions, one robot for 30 cycles and 16 staggered robots for 60,
     clear of the true disc; (f) the refilling bf16 anytime server, B=256,
     12 chunks of 50 steps, more than one completed solve and a pool that
     did not run dry; (g) the online FleetReplanningService, 256 robots with
     one shared field per 128, 20-step chunks within a 0.1 s budget, a
     warm-up and 4 cycles, replicas bit-identical, a finite path for every
     robot. After (b), (d), (e), (f) and (g) every kernel is held on the
     path's own inputs, (b) and (g) on 128 robots.
 12. the paper's comparison (GPMP2, the benchmark adapter and analysis, the
     demo): (a) GPMP2 (baselines/gpmp2.py through scripts/run_gpmp2_torch.py's
     functions) on phase 10's 256 corridor worlds, footprint 1.0, the
     wavefront init on the card, 100 states, 30 Gauss-Newton iterations,
     after a one-iteration CUDA-vs-CPU check on 4 problems (residuals and
     Jacobian against the CPU's, J^T J, J^T r and the LU step against f64);
     every state finite, endpoints within 0.1 of their pins, no problem's
     cost rising over an iteration, none of the port's kernels launched;
     timed after a warm-up, with its peak memory, its collision-free count
     by the script's dense check beside phase 10's NFOPP numbers; (b) the
     same on the script's movingai (16 .scen entries of the committed city
     map) and forest (16 seeds) suites, each with the script's JSON line;
     (c) a BenchmarkAdapter on one corridor world (collision answers against
     the dilated grid, both planners' paths evaluated and saved), and phase
     10's and (a)'s logs through bench.analysis into the comparison table;
     (d) scripts/run_planner_torch.py's demo, one problem, 1000 steps in
     f32, each f32 kernel once per step (its launches join the kernel line),
     a finite path with pinned endpoints, its feasibility printed.
 13. the merged field+trajectory step and the Jacobi order
     (ExperimentalConstrainedSolver, experimental/merged_step.py), car scene,
     run_planner_config, B=256 x 1000 steps: merged in f32 and bf16 and in
     groups of 8 shared fields (run_grouped), none of the port's kernels
     launched, finite, replicas bit-identical; the Jacobi order in f32, each
     f32 kernel once per step and held on its own inputs; feasible fractions
     printed. Then one step of 4 problems: merged against Jacobi on the card
     (field loss and gradients at phase 3's tolerances, the same replay
     buffer while no candidate's weight is below the floor) and merged on the
     card against the CPU. Then the suite and parity scripts through their
     functions (SCRIPT_RUNS), ours side only: compare_suites_torch (16
     corridor worlds), shortcut_gains_torch --smoke (corridor),
     run_sweep_torch (2 sigmas x 1 weight, 16 worlds, 500 iterations),
     two_walls_reliability_torch (1 seed x 8 restarts: single, portfolio,
     shared field, 1000 iterations), compare_with_reference_torch (16 seeds
     in one batch),
     compare_holonomic_torch (4 seeds); the launches of the Jacobi cell and
     of the scripts join the f32 kernels' counts.
After each solve of phases 7-10 (the tracked and grouped paths, the holonomic
path, both planners and the suite), every kernel of that path is held against
its plain version on the inputs the path's next step gives it, at the path's
own shapes (`hold_path_kernels`; on the suite also the field-gradient kernel
on pretraining's 200 points). Phase 3's check of the other field configurations
includes both kinds of field these paths add, at small shapes: no angle
features on SE(2) poses, and on points.
The last two lines are the card (nvidia-smi) and {"ok": true, "device": ...};
before them, one JSON line lists every kernel with its launches, error and
times, and earlier lines hold each path's numbers and the f32 checks of the
multi-problem kernels.
"""
from __future__ import annotations

import argparse
import itertools
import json
from functools import partial
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BATCH, STEPS = 256, 1000  # the bench workload: bench.py's batch and step budget
# bench.py --anytime's run_with_tracking settings (bench.py:449-464)
ANYTIME = {"max_iterations": 1000, "min_iterations": 200, "check_freq": 50,
           "samples_per_segment": 5, "stop_on_plateau": True}
GROUP_SIZE = 8  # restarts of one query sharing a field (parallel/batch.py::solve_portfolio)
# the corridor benchmark suite as its users run it (artifacts/corridor256_summary.json:
# run_benchmark.py --suite corridor --seeds 256 --min-geodesic 120 --restart-failed 8),
# with the shortcut pass added
SUITE_WORLDS = {"suite": "corridor", "seeds": 256, "min_geodesic": 120.0}
SUITE_SOLVE = {"footprint_radius": 1.0, "max_iterations": 1000, "min_iterations": 200,
               "check_freq": 50, "stop_on_plateau": True, "restart_failed": 8,
               "restart_rounds": 1, "shortcut_trials": 128, "require_native_evaluator": True}
# phase 11, the replanning services: the dynamic demo's host loop (ticks, budget
# in s), the users' fleet serving shape (256 robots in 2 sub-fleets of 128, one
# shared field each, 20-step bursts), the sub-fleet schedule check, one robot's
# session, the dynamic sessions, the bf16 anytime server and the online fleet
# service in the serving shape (256 robots, one shared field per 128, 20-step
# chunks within the 0.1 s budget)
HOST_TICKS, HOST_BUDGET = 40, 0.08
FLEET = {"robots": 256, "subgroups": 2, "group_size": 128, "steps": 20, "goals": 2, "cycles": 25}
SUBGROUPS = {"robots": 16, "subgroups": 2, "group_size": 8, "steps": 20, "goals": 2, "cycles": 2}
SINGLE = {"goals": 2, "cycles": 10, "steps": 40}
DYNAMIC = {"steps": 20, "cycles": 30, "fleet": 16, "fleet_cycles": 60}
SERVER = {"batch": 256, "pool_rounds": 3, "chunks": 12}
FLEET_SERVICE = {"robots": 256, "group_size": 128, "steps_per_chunk": 20, "budget": 0.1,
                 "cycles": 4}
DRIFT_STEPS = 100  # steps of the CUDA-vs-CPU drift readout after the checked step
PROBLEMS_PER_PROGRAM = (1, 2, 4, 8)  # P of the multi-problem kernels; 8 on the batch path

# A ReLU unit whose pre-activation lies within KINK_TOL of zero may land on
# either side of the kink in two summation orders; a problem whose ReLU
# gradients miss their bound is recomputed in f64 with every choice of sides
# for up to MAX_KINKS such units (see `hold`).
KINK_TOL = 1e-5
MAX_KINKS = 10
# Under bf16 a forward operand (a feature, h1 or h2 element) whose two f32
# sums straddle a bf16 rounding boundary (a tie, below) moves by one bf16 ulp
# and moves the next layer's pre-activations by up to BF16_ULP |a_j| |W_jc|:
# a unit that close to zero can take the other side in the kernel than in the
# plain version though it is far from zero in f64. A bf16 problem that no
# choice of sides within KINK_TOL explains is recomputed with one such unit
# flipped (with up to two of the KINK_TOL units), trying the MAX_TIE_FLIPS
# units nearest zero relative to their reach.
MAX_TIE_FLIPS = 40
# A bf16 tie can also sit in an activation itself: a feature, h1 or h2 element
# whose two f32 values (kernel, plain version) straddle a bf16 rounding boundary
# is rounded to neighbouring bf16 values, which moves its point's logit by one
# bf16 ulp of the activation times its weights, and through the point's BCE
# cotangent every parameter gradient. A bf16 problem no ReLU flip explains is
# recomputed with one such activation rounded to the other side, trying the
# MAX_TIE_FLIPS activations nearest a rounding boundary within ROUNDING_TIE_DIST
# of it (relative): 2^-21 is 4 to 8 f32 ulps of summation-order difference (the
# tie seen on the card sat 9.3e-9, under one ulp, from its boundary).
ROUNDING_TIE_DIST = 2.0 ** -21

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

# (hidden, angle harmonics, modes): the widest fields the collision
# backward's kernels take, 220 features at hidden 108 (f32, the shared-memory
# limit; bf16 too) and 256 features at hidden 128 (bf16, net_args' limit)
COLLISION_BWD_WIDEST = ((108, 10, ("float32", "bfloat16")), (128, 28, ("bfloat16",)))
# the same for the forward kernels (ONF logits and collision forward): 220
# features at hidden 118 (the first version's limit, both modes) and 120
# (f32, the shared-memory limit), 226 at 117 (f32, fits only without the
# tiles' bank padding), 256 at 128 (bf16, net_args' limit)
FORWARD_WIDEST = ((118, 10, ("float32", "bfloat16")), (120, 10, ("float32",)),
                  (117, 13, ("float32",)), (128, 28, ("bfloat16",)))

MAIN_PATH = ("onf_forward", "field_grad", "collision_fwd", "collision_bwd")
BATCH_PATH = ("onf_multi", "field_grad_multi", "collision_fwd_bf16", "collision_bwd_bf16")
MAIN_PATH_BF16 = ("onf_forward_bf16", "field_grad_bf16", "collision_fwd_bf16", "collision_bwd_bf16")
# each bf16 kernel computes its f32 counterpart's function
COUNTERPART = {**dict(zip(BATCH_PATH, MAIN_PATH)), **dict(zip(MAIN_PATH_BF16, MAIN_PATH))}
REPLACES = {
    "onf_forward": "nfopp_tpu/experimental/pallas/onf_fused.py:73",
    "field_grad": "nfopp_tpu/experimental/pallas/field_grad.py:35",
    "collision_fwd": "nfopp_tpu/experimental/pallas/collision_terms.py:76",
    "collision_bwd": "nfopp_tpu/experimental/pallas/collision_terms.py:99",
    "onf_multi": "nfopp_tpu/experimental/pallas/onf_multi.py:28",
    "field_grad_multi": "nfopp_tpu/experimental/pallas/field_grad_multi.py:32",
    "collision_fwd_bf16": "nfopp_tpu/experimental/pallas/collision_terms.py:76",
    "collision_bwd_bf16": "nfopp_tpu/experimental/pallas/collision_terms.py:99",
    "onf_forward_bf16": "nfopp_tpu/experimental/pallas/onf_fused.py:73",
    "field_grad_bf16": "nfopp_tpu/experimental/pallas/field_grad.py:35",
}
# the file that holds each kernel's code (the ONF logits and field-gradient
# kernels are templates in headers, instantiated by onf_forward.cu /
# onf_multi.cu and field_grad.cu / field_grad_multi.cu)
SOURCES = {
    "onf_forward": "nfopp_tpu_torch/kernels/csrc/forward.cuh",
    "field_grad": "nfopp_tpu_torch/kernels/csrc/field_grad.cuh",
    "collision_fwd": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
    "collision_bwd": "nfopp_tpu_torch/kernels/csrc/collision_bwd.cu",
    "onf_multi": "nfopp_tpu_torch/kernels/csrc/forward.cuh",
    "field_grad_multi": "nfopp_tpu_torch/kernels/csrc/field_grad.cuh",
    "collision_fwd_bf16": "nfopp_tpu_torch/kernels/csrc/collision_terms.cu",
    "collision_bwd_bf16": "nfopp_tpu_torch/kernels/csrc/collision_bwd.cu",
    "onf_forward_bf16": "nfopp_tpu_torch/kernels/csrc/forward.cuh",
    "field_grad_bf16": "nfopp_tpu_torch/kernels/csrc/field_grad.cuh",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sass_listing(build) -> str:
    """`cuobjdump -sass` of the built kernel library."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(build.library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout


# the kernels that run their products on the tensor cores, and how many
# instantiations each has: the bf16 modes of the field-gradient kernel
# (BF16_MULTI, BF16_APPLY), of the ONF logits kernel (the same two) and of
# the collision forward and backward (BF16_APPLY)
TENSOR_CORE_KERNELS = {"field_grad_tc_kernel": 2, "collision_bwd_tc_kernel": 1,
                       "onf_logits_tc_kernel": 2, "collision_fwd_tc_kernel": 1}


def tensor_core_kernels(sass: str) -> dict:
    """HMMA (tensor-core) instructions in each field kernel of a `cuobjdump
    -sass` listing; raises unless every instantiation of each
    TENSOR_CORE_KERNELS entry has some and the f32 kernels have none."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    for kernel, instances in TENSOR_CORE_KERNELS.items():
        tc = {k: v for k, v in counts.items() if kernel in k}
        if len(tc) != instances or not all(tc.values()):
            raise AssertionError(f"{kernel}: instantiations without tensor-core instructions: {tc}")
    f32 = {k: v for k, v in counts.items() if "_f32_kernel" in k and v}
    if f32:
        raise AssertionError(f"f32 kernels with tensor-core instructions: {f32}")
    return {k: v for k, v in counts.items()
            if any(kind in k for kind in ("field_grad", "collision", "onf_logits"))}


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


def bf16_other_side(a):
    """Elementwise, for values `a`: the bf16 value on the other side of the
    rounding boundary nearest a's own bf16 rounding, and a's distance from
    that boundary relative to |a| (inf where a is a bf16 value)."""
    import torch

    r = bf16_round(a)
    bits = r.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    step = torch.where((a > r) == (r > 0), 1, -1)  # one bf16 ulp towards a
    other = (bits + step).to(torch.int16).view(torch.bfloat16).to(a.dtype)
    dist = (a - (r + other) / 2).abs() / a.abs()
    return other, torch.where(a == r, torch.inf, dist)


def masked_forward(params, x, cfg, flips=(), casts=None, record=None):
    """The field's forward pass (models/onf.py's graph, written out again) on
    one problem in whatever dtype its inputs have, with each ReLU's mask taken
    from its pre-activation and flipped at the (layer, point, unit) entries of
    `flips`. `casts` places the bf16 roundings: None (f32), "multi" (the TPU
    multi-problem kernels': encoding in full precision, `pallas_mm` for the
    rest) or "apply" (onf_apply's: every product's operands, xy and the
    encoding weights too, cast separately at each use, so that autograd rounds
    each cotangent where it passes back through a cast). Under "apply",
    entries ("tie", name, point, unit) of `flips` round that activation
    (name "feat", "h1" or "h2") to the bf16 value on the other side of its
    rounding boundary, at every use (`bf16_other_side`). Returns the logits
    [1, M] and the two pre-activations [1, M, hid]; a dict `record` receives
    each ReLU layer's input and weight under "inputs" and "weights", and the
    activations by name under "activations"."""
    import torch

    from nfopp_tpu_torch.models import angle_encode

    ties = [flip[1:] for flip in flips if flip[0] == "tie"]
    flips = [flip for flip in flips if flip[0] != "tie"]

    def cast_in(a, name):
        """a rounded to bf16, across the boundary at the ties of `name`."""
        r = bf16_round(a)
        for tie_name, point, unit in ties:
            if tie_name == name:
                other, _ = bf16_other_side(a[0, point, unit].detach())
                shift = torch.zeros_like(r)
                shift[0, point, unit] = other - r[0, point, unit].detach()
                r = r + shift
        return r

    def mm(a, w, name=None):
        if casts == "apply":
            return cast_in(a, name) @ bf16_round(w)
        return {None: torch.matmul, "multi": pallas_mm}[casts](a, w)
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
    if record is not None:
        record["inputs"], record["weights"] = [], []
        record["activations"] = {"feat": feats.detach()}
    for layer, (name, act) in enumerate((("mlp1", "feat"), ("mlp2", "h1"))):
        if record is not None:
            record["inputs"].append(h.detach())
            record["weights"].append(params[name]["w"].detach())
        z = mm(h, params[name]["w"], act) + params[name]["b"][:, None]
        mask = z.detach() > 0
        for flip_layer, point, unit in flips:
            if flip_layer == layer:
                mask[0, point, unit] = ~mask[0, point, unit]
        pre.append(z.detach())
        h = z * mask
        if record is not None:
            record["activations"][f"h{layer + 1}"] = h.detach()
    if casts == "apply":  # each part's rounding, with its ties
        logits = (torch.cat([cast_in(h, "h2"), cast_in(feats, "feat")], dim=-1)
                  @ bf16_round(params["out"]["w"]))
    else:
        logits = mm(torch.cat([h, feats], dim=-1), params["out"]["w"])
    logits = logits + params["out"]["b"][:, None]
    return logits[..., 0], pre


def tie_reach_units(pre, record, near) -> list:
    """ReLU units (layer, point, unit) beyond KINK_TOL of zero but within the
    reach of one bf16 tie in the layer's input, BF16_ULP max_j |a_j| |W_jc|,
    nearest zero relative to their reach first; at most MAX_TIE_FLIPS."""
    ranked = []
    for layer, (z, a, w) in enumerate(zip(pre, record["inputs"], record["weights"])):
        reach = BF16_ULP * (a[0].abs()[:, :, None] * w[0].abs()[None]).amax(dim=1)
        ratio = z[0].abs() / reach
        for point, unit in ((z[0].abs() >= KINK_TOL) & (ratio < 1)).nonzero().tolist():
            ranked.append((float(ratio[point, unit]), (layer, point, unit)))
    ranked.sort()
    return [unit for _, unit in ranked[:MAX_TIE_FLIPS] if unit not in near]


def rounding_ties(record) -> list:
    """Activations ("tie", name, point, unit) within ROUNDING_TIE_DIST of a
    bf16 rounding boundary (`bf16_other_side`), nearest first; at most
    MAX_TIE_FLIPS."""
    ranked = []
    for name, a in record["activations"].items():
        _, dist = bf16_other_side(a[0])
        for point, unit in (dist < ROUNDING_TIE_DIST).nonzero().tolist():
            ranked.append((float(dist[point, unit]), ("tie", name, point, unit)))
    ranked.sort()
    return [tie for _, tie in ranked[:MAX_TIE_FLIPS]]


def explain_by_kinks(name, i, got, tols, params, points, cfg, recompute, bf16=False) -> list:
    """The flips (layer, point, unit) under which problem i's f64
    recomputation meets the bounds `tols` against the kernel's outputs `got`;
    raises if no choice of sides for its near-zero ReLU units does (under
    bf16, nor one unit within a tie's reach, `tie_reach_units`, nor one
    activation rounded across its bf16 rounding boundary, `rounding_ties`)."""
    from nfopp_tpu_torch.utils.tree import tree_map

    p = tree_map(lambda t: t[i:i + 1].detach().double(), params)
    x = points[i:i + 1].detach().double()
    record = {}
    _, pre = masked_forward(p, x, cfg, casts=recompute.casts, record=record)
    near = [(layer, point, unit) for layer, z in enumerate(pre)
            for _, point, unit in (z.abs() < KINK_TOL).nonzero().tolist()]
    if len(near) > MAX_KINKS:
        raise AssertionError(f"{name}: problem {i} has {len(near)} ReLU units within "
                             f"{KINK_TOL} of zero, more than the {MAX_KINKS} tried")

    def meets(flips) -> bool:
        want = recompute(p, x, i, flips)
        return all(bool(within(g[i:i + 1].double(), w, *t, bf16).all())
                   for g, w, t in zip(got, want, tols))

    for k in range(len(near) + 1):
        for flips in itertools.combinations(near, k):
            if meets(flips):
                return list(flips)
    tied = tie_reach_units(pre, record, near) if bf16 else []
    rounded = rounding_ties(record) if bf16 and recompute.casts == "apply" else []
    for unit in tied + rounded:
        for k in range(min(len(near), 2) + 1):
            for flips in itertools.combinations(near, k):
                if meets(flips + (unit,)):
                    return list(flips + (unit,))
    raise AssertionError(
        f"{name}: problem {i} misses its bound, and no choice of sides for its "
        f"{len(near)} ReLU unit(s) within {KINK_TOL} of zero explains it: {near}"
        + (f", nor one of the {len(tied)} within a bf16 tie's reach, nor one of the "
           f"{len(rounded)} activations within a tie of a bf16 rounding boundary"
           if bf16 else ""))


def f64_distances(i, got, want, kinks) -> tuple[list, list]:
    """Output by output, the largest difference of problem i's kernel
    outputs and of its plain outputs from their f64 recomputation (no
    flips)."""
    from nfopp_tpu_torch.utils.tree import tree_map

    params, points, _, recompute = kinks
    p = tree_map(lambda t: t[i:i + 1].detach().double(), params)
    ref = recompute(p, points[i:i + 1].detach().double(), i, ())
    return ([float((g[i:i + 1].double() - r).abs().max()) for g, r in zip(got, ref)],
            [float((w[i:i + 1].double() - r).abs().max()) for w, r in zip(want, ref)])


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
    plain version, not the kernel, sat on the far side of a bf16 rounding; or
    one of them a unit within a bf16 tie's reach (`tie_reach_units`), or, under
    onf_apply's casts, an activation within a tie of a bf16 rounding boundary
    rounded to its other side (`rounding_ties`). A
    problem no flips explain passes only if, output by output, the kernel is
    no farther from its f64 recomputation than the plain version is from its
    own on the batch's problem where the plain version is farthest
    (`f64_distances` over every problem): on a badly conditioned field
    (trained logits of tens whose f32 sums cancel) no f32 computation meets
    the bounds, and the kernel is then held to PyTorch's own f32 error on
    these inputs; logged.
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
    unexplained = []
    for i in missed:
        try:
            flips = explain_by_kinks(name, i, got, tols, *kinks, bf16=bf16)
        except AssertionError as reason:
            unexplained.append((i, reason))
            continue
        if flips:
            log(f"  {name}: problem {i} (largest difference {err:.3g}) matches an f64 "
                f"recomputation with ReLU sides flipped at (layer, point, unit), or "
                f"activations rounded across a bf16 boundary at (\"tie\", name, point, "
                f"unit): {flips}")
        else:  # the plain version, not the kernel, took the far side of a rounding
            log(f"  {name}: problem {i} (largest difference {err:.3g}) matches an f64 "
                "recomputation with no ReLU side flipped")
    if unexplained:  # held to the plain version's f32 error on this batch
        offs = [f64_distances(b, got, want, kinks) for b in range(len(ok))]
        noise = [max(plain[j] for _, plain in offs) for j in range(len(got))]
        for i, reason in unexplained:
            if any(k > q for k, q in zip(offs[i][0], noise)):
                raise AssertionError(
                    f"{reason}; and the kernel is farther from the f64 recomputation "
                    f"({offs[i][0]}) than the plain version is on any problem ({noise})"
                ) from None
            log(f"  {name}: problem {i} (largest difference {err:.3g}) is no farther from "
                f"the f64 recomputation, output by output, than the plain version is on "
                f"some problem: {offs[i][0]} vs {noise}")
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


def logits_f64(cfg, casts=None):
    """recompute() of `hold` for the ONF logits kernel: [1, M, 1]."""
    def recompute(p, x, i, flips):
        return [masked_forward(p, x, cfg, flips, casts)[0][..., None]]

    recompute.casts = casts
    return recompute


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


def collision_sums_f64(mult, cfg, beta, casts=None):
    """recompute() of `hold` for the collision terms' sums: [1, 2] of
    (sum softplus_beta(z), sum mu tanh(z))."""
    import torch

    from nfopp_tpu_torch.ops.losses import softplus_beta

    def recompute(p, x, i, flips):
        z, _ = masked_forward(p, x, cfg, flips, casts)
        mu = mult[i:i + 1].double()
        return [torch.stack([softplus_beta(z, beta).sum(dim=-1),
                             (mu * torch.tanh(z)).sum(dim=-1)], dim=1)]

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
    from nfopp_tpu_torch.tools.scene import time_ms

    params, x3, mult, beta, weights = inp.params, inp.x3, inp.mult, inp.beta, inp.weights
    bf16 = onf.compute_dtype == "bfloat16"
    suffix = "_bf16" if bf16 else ""
    out = collision_fwd(params, x3, mult, onf, beta)
    ref = torch.stack(kernels.collision_terms_plain(params, x3, mult, onf, beta), dim=1)
    same_bits("collision_fwd" + suffix, lambda: collision_fwd(params, x3, mult, onf, beta))
    results = {"collision_fwd" + suffix: {
        "max_abs_err": hold("collision_fwd" + suffix, [out], [ref], [(1e-5, 1e-5)], bf16=bf16),
        "ms": time_ms(lambda: collision_fwd(params, x3, mult, onf, beta)),
        "plain_ms": time_ms(lambda: kernels.collision_terms_plain(params, x3, mult, onf, beta)),
    }}

    def plain_bwd():
        return collision_grads(kernels.collision_terms_plain, params, x3, mult, onf, beta, weights)

    got = collision_grads(kernels.collision_terms, params, x3, mult, onf, beta, weights)
    same_bits("collision_bwd" + suffix, lambda: collision_bwd(params, x3, mult, inp.cot, onf, beta))
    recompute = collision_f64(mult, weights, onf, beta, "apply" if bf16 else None)
    results["collision_bwd" + suffix] = {
        "max_abs_err": hold("collision_bwd" + suffix, got, plain_bwd(),
                            [(5e-4, 1e-5), (5e-4, 1e-6)], kinks=(params, x3, onf, recompute),
                            bf16=bf16),
        "ms": time_ms(lambda: collision_bwd(params, x3, mult, inp.cot, onf, beta)),
        "plain_ms": time_ms(plain_bwd),
    }
    return results


def same_bits(name, fn) -> None:
    """Two launches of `fn` give identical bits (no atomics, fixed order)."""
    import torch

    from nfopp_tpu_torch.utils.tree import tree_leaves

    first, second = tree_leaves(fn()), tree_leaves(fn())
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches differ")


def check_kernels(device, peaks, seed: int, batch: int) -> dict:
    """Phase 3, main paths: kernels 1 and 2 in f32 and in bf16 (onf_apply's
    casts, held with the bf16 tie allowance and the "apply" kink
    recomputation) and the f32 collision kernels against their plain
    versions at the main path's shapes."""
    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.tools.scene import time_ms
    from nfopp_tpu_torch.utils.tree import tree_leaves

    inp = KernelInputs(device, seed, batch)
    params, x1, x2, truth = inp.params, inp.x1, inp.x2, inp.truth
    results = {}
    for onf in (inp.onf, inp.onf_bf16):
        bf16 = onf.compute_dtype == "bfloat16"
        suffix = "_bf16" if bf16 else ""

        # kernel 1: forward (tolerance of tests/test_pallas.py:32)
        got = kernels.onf_forward(params, x1, onf)
        want = kernels.onf_forward_plain(params, x1, onf)
        same_bits("onf_forward" + suffix, lambda: kernels.onf_forward(params, x1, onf))
        results["onf_forward" + suffix] = {
            "max_abs_err": hold("onf_forward" + suffix, [got], [want], [(1e-4, 2e-4)], bf16=bf16),
            "ms": time_ms(lambda: kernels.onf_forward(params, x1, onf)),
            "plain_ms": time_ms(lambda: kernels.onf_forward_plain(params, x1, onf)),
        }

        # kernel 2: loss + every parameter gradient (tests/test_field_grad_fused.py:33-46)
        name = "field_grad" + suffix
        loss, grads = kernels.field_grad(params, x2, truth, onf)
        ref_loss, ref_grads = kernels.field_grad_plain(params, x2, truth, onf)
        same_bits(name, lambda: kernels.field_grad(params, x2, truth, onf))
        results[name] = {
            "max_abs_err": max(
                hold(f"{name} loss", [loss], [ref_loss], [(1e-5, 1e-6)], bf16=bf16),
                hold(f"{name} gradients", tree_leaves(grads), tree_leaves(ref_grads),
                     [(2e-4, 2e-5)] * len(tree_leaves(grads)),
                     kinks=(params, x2, onf, field_grad_f64(truth, onf, "apply" if bf16 else None)),
                     bf16=bf16)),
            "ms": time_ms(lambda: kernels.field_grad(params, x2, truth, onf)),
            "plain_ms": time_ms(lambda: kernels.field_grad_plain(params, x2, truth, onf)),
        }

    results.update(check_collision(inp, inp.onf))
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
    from nfopp_tpu_torch.tools.scene import time_ms
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
        same_bits(f"onf_multi {tag}", lambda: kernels.onf_multi(params, x1, onf, p_last))
        same_bits(f"field_grad_multi {tag}",
                  lambda: kernels.field_grad_multi(params, x2, truth, onf, p_last))
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


def check_forward(name, params, x, mult, onf) -> float:
    """The ONF logits kernel (through onf_forward and onf_multi) and the
    collision forward against their plain versions, with the tolerances of
    phase 3; returns the largest difference."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.kernels.collision_terms import collision_fwd

    bf16 = onf.compute_dtype == "bfloat16"
    sums = torch.stack(kernels.collision_terms_plain(params, x, mult, onf, 10.0), dim=1)
    return max(
        hold(f"onf_forward {name}", [kernels.onf_forward(params, x, onf)],
             [kernels.onf_forward_plain(params, x, onf)], [(1e-4, 2e-4)], bf16=bf16),
        hold(f"onf_multi {name}", [kernels.onf_multi(params, x, onf, x.shape[0])],
             [kernels.onf_multi_plain(params, x, onf)], [(1e-4, 2e-4)], bf16=bf16),
        hold(f"collision_fwd {name}", [collision_fwd(params, x, mult, onf, 10.0)], [sums],
             [(1e-5, 1e-5)], bf16=bf16))


def check_configs(device, seed: int) -> dict:
    """Every kernel on the other field configurations (those of the JAX kernel
    tests, tests/test_field_grad_fused.py:13-20, plus bias=False, and the
    planner API's two default fields) on small shapes that end in partial
    tiles, against its plain version with the
    tolerances of phase 3, in f32 and bf16; the forward kernels and the
    collision backward at the widest fields their kernels take
    (FORWARD_WIDEST, COLLISION_BWD_WIDEST); one step past the widest, each
    launch refuses with a clear error."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.kernels.collision_terms import collision_bwd, collision_fwd
    from nfopp_tpu_torch.models import ONFConfig, init_onf_params
    from nfopp_tpu_torch.solver import DEFAULT_PARAMETERS, PlannerFactory, config_from_parameters
    from nfopp_tpu_torch.utils.tree import tree_leaves

    configs = [  # (field, width of the query points)
        (ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True), 3),
        (ONFConfig(mean=1.0, sigma=3.0, use_cos=True, angle_encoding=False), 2),
        (ONFConfig(mean=0.0, sigma=1.0, use_cos=False, angle_encoding=False), 2),
        (ONFConfig(mean=0.5, sigma=2.0, use_cos=True, angle_encoding=True, bias=False), 3),
        # the widest hidden layer the bf16 field-gradient kernels take at 220
        # features (the f32 one, without room for its slope tile, 108)
        (ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True, hidden=104), 3),
        # the planner API's default constrained field: no angle features on
        # SE(2) poses, whose theta the kernels read and must not use
        (config_from_parameters(DEFAULT_PARAMETERS).onf, 3),
        # make_onf_planner's holonomic field, on points
        (PlannerFactory.make_onf_planner(None, None, device=device).solver.config.onf, 2),
    ]
    g = torch.Generator(device=device).manual_seed(seed)
    cot = torch.tensor([3.0, 1.0])
    errors = {}
    for i, (base, dim) in enumerate(configs):
        params = init_onf_params(g, base, 3, device)
        for m in (5, 37):
            x = torch.randn((3, m, dim), generator=g, device=device) * 2
            truth = torch.rand((3, m), generator=g, device=device) > 0.5
            mult = torch.rand((3, m), generator=g, device=device)
            err = 0.0
            for onf in (base, base._replace(compute_dtype="bfloat16")):
                bf16 = onf.compute_dtype == "bfloat16"
                forward_fns = {"onf_multi": (lambda *a: kernels.onf_multi(*a, 3),
                                             kernels.onf_multi_plain),
                               "onf_forward": (kernels.onf_forward, kernels.onf_forward_plain)}
                field_fns = {"field_grad_multi": (lambda *a: kernels.field_grad_multi(*a, 3),
                                                  kernels.field_grad_multi_plain, "multi"),
                             "field_grad": (kernels.field_grad, kernels.field_grad_plain, "apply")}
                for name, (fn, plain) in forward_fns.items():
                    err = max(err, hold(name, [fn(params, x, onf)], [plain(params, x, onf)],
                                        [(1e-4, 2e-4)], bf16=bf16))
                for name, (fn, plain, casts) in field_fns.items():
                    casts = casts if bf16 else None
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
    # the forward kernels at the widest fields they take
    for hidden, harmonics, dtypes in FORWARD_WIDEST:
        base = ONFConfig(mean=0.0, sigma=1.0, hidden=hidden, angle_harmonics=harmonics)
        params = init_onf_params(g, base, 3, device)
        x = torch.randn((3, 37, 3), generator=g, device=device) * 2
        mult = torch.rand((3, 37), generator=g, device=device)
        for dtype in dtypes:
            name = f"{dtype} {base.feature_dim} features, hidden {hidden}"
            errors[f"forward_{dtype}_{base.feature_dim}x{hidden}"] = check_forward(
                name, params, x, mult, base._replace(compute_dtype=dtype))
    # the collision backward's kernels at the widest fields they take
    cot3 = cot.to(device).expand(3, 2).contiguous()
    for hidden, harmonics, dtypes in COLLISION_BWD_WIDEST:
        base = ONFConfig(mean=0.0, sigma=1.0, hidden=hidden, angle_harmonics=harmonics)
        params = init_onf_params(g, base, 3, device)
        x = torch.randn((3, 37, 3), generator=g, device=device) * 2
        mult = torch.rand((3, 37), generator=g, device=device)
        for dtype in dtypes:
            onf = base._replace(compute_dtype=dtype)
            bf16 = dtype == "bfloat16"
            recompute = collision_f64(mult, cot, onf, 10.0, "apply" if bf16 else None)
            errors[f"collision_bwd_{dtype}_{base.feature_dim}x{hidden}"] = hold(
                f"collision_bwd {dtype} {base.feature_dim} features, hidden {hidden}",
                collision_bwd(params, x, mult, cot3, onf, 10.0),
                collision_grads(kernels.collision_terms_plain, params, x, mult, onf, 10.0, cot),
                [(5e-4, 1e-5), (5e-4, 1e-6)], kinks=(params, x, onf, recompute), bf16=bf16)
    # one step past those widths a launch refuses with a clear error: the
    # field-gradient kernels and the f32 collision backward at hidden 112
    # (220 features), the f32 forward kernels at hidden 121, the bf16
    # kernels at hidden 136, which net_args refuses for every kernel
    wide = ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True, hidden=112)
    wide_fwd = wide._replace(hidden=121)
    wider = ONFConfig(mean=0.0, sigma=1.0, hidden=136, compute_dtype="bfloat16")
    params = init_onf_params(g, wide, 3, device)
    params_fwd = init_onf_params(g, wide_fwd, 3, device)
    params_wider = init_onf_params(g, wider, 3, device)
    x = torch.randn((3, 37, 3), generator=g, device=device) * 2
    truth = torch.rand((3, 37), generator=g, device=device) > 0.5
    mult = torch.rand((3, 37), generator=g, device=device)
    calls = {}
    for onf in (wide, wide._replace(compute_dtype="bfloat16")):
        calls[f"field_grad {onf.compute_dtype}"] = partial(kernels.field_grad, params, x, truth, onf)
        calls[f"field_grad_multi {onf.compute_dtype}"] = partial(
            kernels.field_grad_multi, params, x, truth, onf, 3)
    calls["collision_bwd float32"] = partial(collision_bwd, params, x, mult, cot3, wide, 10.0)
    calls["collision_bwd bfloat16, hidden 136"] = partial(
        collision_bwd, params_wider, x, mult, cot3, wider, 10.0)
    for p, onf in ((params_fwd, wide_fwd), (params_wider, wider)):
        label = f"{onf.compute_dtype}, hidden {onf.hidden}"
        calls[f"onf_forward {label}"] = partial(kernels.onf_forward, p, x, onf)
        calls[f"onf_multi {label}"] = partial(kernels.onf_multi, p, x, onf, 3)
        calls[f"collision_fwd {label}"] = partial(collision_fwd, p, x, mult, onf, 10.0)
    for label, call in calls.items():
        try:
            call()
        except ValueError as exc:
            if "does not fit" not in str(exc) and "kernels take hidden <=" not in str(exc):
                raise
        else:
            raise AssertionError(f"{label} took a field wider than its kernel holds")
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


def bf16_agreement_check(device, seed: int, batch_path: bool) -> dict:
    """One step with reparametrization of a bf16 path on 4 problems, 10 steps
    into a solve, through the CUDA kernels and through the plain versions on
    the CPU, from the same state and noise: the batch path (`_step_batch`,
    P=4) or the bf16 main path (ConstrainedSolver.step_static).

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

    from nfopp_tpu_torch.solver import ConstrainedSolver

    cfg = bf16_config(run_planner_config())
    solver_cls = ExperimentalConstrainedSolver if batch_path else ConstrainedSolver
    tag = "batch" if batch_path else "main bf16"
    oracle, start, goal, bounds = car_world(4, device)
    solver = solver_cls(cfg, rectangle_collision, device=device)
    g = torch.Generator().manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    if batch_path:
        state, _ = solver.run_batch(state, oracle, 10, GeneratorNoise(g), problems_per_program=4)
    else:
        state, _ = solver.run(state, oracle, 10, GeneratorNoise(g))

    outs = []
    for dev in (device, torch.device("cpu")):
        slv = solver_cls(cfg, rectangle_collision, device=dev)
        noise = GeneratorNoise(torch.Generator().manual_seed(seed + 1))
        st, orc = tree_map(lambda x: x.to(dev), state), car_world(4, dev)[0]
        if batch_path:
            st, aux = slv._step_batch(st, orc, noise, True, 4)
        else:
            st, aux = slv.step_static(st, orc, noise, with_reparam=True)
        outs.append(tree_map(lambda x: x.cpu(), (st, aux)))
    (a, aux_a), (b, aux_b) = outs
    errors = {
        "field_loss": hold(f"{tag} field_loss", [aux_a.field_loss], [aux_b.field_loss],
                           [(1e-4, 1e-5)], bf16=True),
        "trajectory_loss": hold(f"{tag} trajectory_loss", [aux_a.trajectory_loss],
                                [aux_b.trajectory_loss], [(1e-3, 1e-5)]),
    }
    for name, tol in (("buffer_points", 1e-5), ("buffer_ages", 0.0), ("trajectory", 1e-4),
                      ("collision_multipliers", 1e-4), ("constraint_multipliers", 1e-4)):
        errors[name] = hold(f"{tag} {name}", [getattr(a, name)], [getattr(b, name)],
                            [(0.0, tol)])
    params = list(zip(tree_leaves(a.field_params), tree_leaves(b.field_params)))
    errors["field_params"] = hold(f"{tag} field_params", *zip(*params),
                                  [(0.0, 1e-3)] * len(params))
    return errors


def bf16_config(cfg):
    """`cfg` with the field's products in bf16, as bench.py runs by default."""
    return cfg._replace(onf=cfg.onf._replace(compute_dtype="bfloat16"))


def solve(device, seed: int, batch: int, steps: int, path: tuple):
    """The B x steps car-scene solve through the kernels of `path`: the f32 or
    bf16 main path (ConstrainedSolver.run) or the bf16 batch path (run_batch,
    P=8). Each kernel of `path` must launch once per step and no other kernel
    at all."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.solver import ConstrainedSolver, evaluate_path, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(batch, device)
    bf16_batch = path == BATCH_PATH
    cfg = run_planner_config() if path == MAIN_PATH else bf16_config(run_planner_config())
    solver_cls = ExperimentalConstrainedSolver if bf16_batch else ConstrainedSolver
    solver = solver_cls(cfg, rectangle_collision, device=device)
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

    check_launches(launches, path, steps, "the solve")
    path_xy = solver.full_trajectory(state)
    check_finite_paths(path_xy, (batch, solver.config.trajectory_length + 2, 3), "solve")
    if not torch.isfinite(aux.field_loss).all() or not torch.isfinite(aux.trajectory_loss).all():
        raise AssertionError("non-finite losses")
    collides, length = evaluate_path(rectangle_collision, oracle, path_xy)
    feasible = float((~collides).float().mean())
    metrics = {
        "batch": batch, "steps": steps, "seconds": seconds,
        "us_per_step_per_problem": per_problem_us(seconds, steps, batch),
        "solves_per_s": batch / seconds,
        "feasible_fraction": feasible,
        "mean_length_feasible": float(length[~collides].mean()) if feasible > 0 else None,
        "final_field_loss": float(aux.field_loss[:, -1].mean()),
    }
    if feasible < 0.98:
        raise AssertionError(f"feasible fraction {feasible} below the 0.98 floor")
    return metrics, launches


def check_launches(launches: dict, path: tuple, steps: int, what: str,
                   extra: dict | None = None) -> None:
    """Each kernel of `path` launched once per step (`steps` times) and
    extra[name] times more (pretraining), every other kernel never."""
    extra = extra or {}
    for name, count in launches.items():
        if count != (steps + extra.get(name, 0) if name in path else 0):
            raise AssertionError(f"kernel {name} launched {count} times in {steps} steps of "
                                 f"{what} (path {path}, besides {extra})")


def check_finite_paths(paths, shape: tuple, what: str) -> None:
    import torch

    if tuple(paths.shape) != shape or not torch.isfinite(paths).all():
        raise AssertionError(f"{what}: bad paths, shape {tuple(paths.shape)} (want {shape})")


def check_replicas(field_tree, group_size: int) -> None:
    """Every leaf [B, ...] of a batch's field (parameters, Adam state)
    bit-identical within each group of `group_size` consecutive problems, and
    the first two groups' parameters distinct."""
    import torch

    from nfopp_tpu_torch.utils.tree import tree_leaves

    leaves = tree_leaves(field_tree)
    for leaf in leaves:
        grouped = leaf.reshape((-1, group_size) + tuple(leaf.shape[1:]))
        if not torch.equal(grouped, grouped[:, :1].expand_as(grouped)):
            raise AssertionError(f"a leaf {tuple(leaf.shape)} differs within a group")
    if all(torch.equal(leaf[0], leaf[group_size]) for leaf in leaves if leaf.is_floating_point()):
        raise AssertionError("two groups hold the same field")


def per_problem_us(seconds: float, steps: float, batch: int) -> float:
    """µs per step per problem for `seconds` of `steps` steps of `batch`."""
    return seconds / steps / batch * 1e6


def hold_path_kernels(what: str, solver, state, oracle, seed: int) -> dict:
    """Each kernel of `solver`'s path against its plain version on the inputs
    one more step from `state` would give it (noise from a generator seeded
    with `seed`): the field's parameters, the candidates it scores [B, K+N-1,
    d] (onf_forward), its training points and their oracle labels [B, (N-1)
    +K+R, d] (field_grad), and the trajectory's collision points with their
    multipliers, beta and the trajectory loss's cotangents (collision terms,
    forward and backward; zero multipliers and beta 1 on a holonomic path).
    Phase 3's tolerances, its ReLU-kink recomputation and, in bf16,
    onf_apply's casts and the tie allowance. Returns the largest difference
    of each kernel."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.ops.sampling import GeneratorNoise, random_intermediate_positions
    from nfopp_tpu_torch.solver.field import field_sample_post, field_sample_pre

    cfg = solver.config
    onf = cfg.onf
    bf16 = onf.compute_dtype == "bfloat16"
    casts = "apply" if bf16 else None
    params = state.field_params
    noise = GeneratorNoise(torch.Generator(device=solver.device).manual_seed(seed))
    pre = field_sample_pre(cfg, noise, state.prev_trajectory, state.bounds)
    candidates = torch.cat([state.buffer_points, pre.fine], dim=1)
    ages = torch.cat([state.buffer_ages, torch.zeros_like(pre.fine[..., 0])], dim=1)
    logits = kernels.onf_forward(params, candidates, onf)
    errors = {"onf_forward": hold(f"{what} onf_forward", [logits],
                                  [kernels.onf_forward_plain(params, candidates, onf)],
                                  [(1e-4, 2e-4)],
                                  kinks=(params, candidates, onf, logits_f64(onf, casts)),
                                  bf16=bf16)}

    sample = field_sample_post(cfg, pre, logits[..., 0], candidates, ages)
    points = sample.train_points
    errors["field_grad"] = hold_field_grad(what, params, points,
                                           solver.oracle_fn(oracle, points), onf)

    batch, n = state.trajectory.shape[:2]
    if hasattr(state, "collision_multipliers"):  # the constrained solver's loss
        samples = cfg.collision_samples_per_segment
        t = noise.uniform((batch, n - 1, samples), solver.device)
        x, mult = solver.collision_inputs(state.trajectory, state.collision_multipliers, t)
        beta, cot = cfg.collision_beta, (cfg.collision_weight / samples, 1.0 / samples)
    else:  # the holonomic solver's: one point per segment, no multipliers
        t = noise.uniform((batch, n - 1, 1), solver.device)
        x = random_intermediate_positions(t, state.trajectory)
        mult = torch.zeros(x.shape[:2], device=solver.device)
        beta, cot = 1.0, (cfg.collision_weight, 0.0)
    weights = torch.tensor(cot, device=solver.device)
    sums = [torch.stack(fn(params, x, mult, onf, beta), dim=1)
            for fn in (kernels.collision_terms, kernels.collision_terms_plain)]
    errors["collision_fwd"] = hold(
        f"{what} collision_fwd", sums[:1], sums[1:], [(1e-5, 1e-5)],
        kinks=(params, x, onf, collision_sums_f64(mult, onf, beta, casts)), bf16=bf16)
    errors["collision_bwd"] = hold(
        f"{what} collision_bwd",
        collision_grads(kernels.collision_terms, params, x, mult, onf, beta, weights),
        collision_grads(kernels.collision_terms_plain, params, x, mult, onf, beta, weights),
        [(5e-4, 1e-5), (5e-4, 1e-6)],
        kinks=(params, x, onf, collision_f64(mult, weights, onf, beta, casts)), bf16=bf16)
    shapes = {"onf_forward": candidates.shape, "field_grad": points.shape,
              "collision": x.shape}
    log(f"{what}: kernels held on the path's own inputs {dict(shapes)}: {errors}")
    return {"max_abs_err": errors,
            "shapes": {name: list(shape) for name, shape in shapes.items()}}


def hold_field_grad(what: str, params, points, truth, onf) -> float:
    """The field-gradient kernel (loss and every parameter gradient) against
    its plain version on training points [B, M, d] and their labels, with
    phase 3's tolerances and ReLU-kink recomputation (bf16: onf_apply's
    casts and the tie allowance); returns the largest difference."""
    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_leaves

    bf16 = onf.compute_dtype == "bfloat16"
    loss, grads = kernels.field_grad(params, points, truth, onf)
    ref_loss, ref_grads = kernels.field_grad_plain(params, points, truth, onf)
    return max(
        hold(f"{what} field_grad loss", [loss], [ref_loss], [(1e-5, 1e-6)], bf16=bf16),
        hold(f"{what} field_grad gradients", tree_leaves(grads), tree_leaves(ref_grads),
             [(2e-4, 2e-5)] * len(tree_leaves(grads)),
             kinks=(params, points, onf, field_grad_f64(truth, onf, "apply" if bf16 else None)),
             bf16=bf16))


def tracked_solve(device, seed: int, batch: int):
    """Phase 7: run_with_tracking in bf16 (bench.py's default precision) with
    its anytime settings on the car scene. Every chunk steps the whole batch,
    so each kernel launches once per step of the longest-running problem
    (chunks x check_freq). Returns the metrics, the launches and what phase
    9's checkpoint resumes (solver, final state, oracle, generator)."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config, run_with_tracking
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(batch, device)
    solver = ConstrainedSolver(bf16_config(run_planner_config()), rectangle_collision,
                               device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    result = run_with_tracking(solver, state, oracle, g, **ANYTIME)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    iterations = result.iterations.float()
    steps_run = int(result.iterations.max())
    check_launches(launches, MAIN_PATH_BF16, steps_run, "the tracked path")
    check_finite_paths(result.path, (batch, solver.config.trajectory_length + 2, 3),
                       "tracked path")
    feasible = float(result.feasible.float().mean())
    mean_iterations = float(iterations.mean())
    held = hold_path_kernels("tracked path", solver, result.state, oracle, seed + 7)
    metrics = {
        "batch": batch, **ANYTIME, "compute_dtype": "bfloat16", "seconds": seconds,
        "iterations_mean": mean_iterations, "iterations_max": steps_run,
        "iterations_min": int(result.iterations.min()),
        # per iteration a problem actually ran (its own early stop counted)
        "us_per_iteration_per_problem": per_problem_us(seconds, mean_iterations, batch),
        # per step the batch ran (every problem computed until the last stops)
        "us_per_step_per_problem": per_problem_us(seconds, steps_run, batch),
        "solves_per_s": batch / seconds,
        "feasible_fraction": feasible,
        "mean_length_feasible": (float(result.length[result.feasible].mean())
                                 if feasible > 0 else None),
        "kernels_held": held,
    }
    if feasible < 0.98:
        raise AssertionError(f"tracked path: feasible fraction {feasible} below the 0.98 floor")
    return metrics, launches, (solver, result.state, oracle, g)


def grouped_solve(device, seed: int, batch: int, steps: int):
    """Phase 8: the shared-field portfolio, init_state(group_size=8) and
    run_grouped_with_tracking in f32 on the car scene, `batch` problems (batch
    / 8 groups of 8 restarts of the car query); each f32 kernel launches once
    per step, and every group's replicas end bit-identical."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.solver import (
        ConstrainedSolver,
        run_grouped_with_tracking,
        run_planner_config,
    )
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(batch, device)
    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle, group_size=GROUP_SIZE)
    check_replicas((state.field_params, state.field_opt_state), GROUP_SIZE)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    result = run_grouped_with_tracking(
        solver, state, oracle, GROUP_SIZE, g, max_iterations=steps,
        min_iterations=ANYTIME["min_iterations"], check_freq=ANYTIME["check_freq"],
        samples_per_segment=ANYTIME["samples_per_segment"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    check_launches(launches, MAIN_PATH, steps, "the grouped path")
    check_replicas((result.state.field_params, result.state.field_opt_state), GROUP_SIZE)
    check_finite_paths(result.path, (batch, solver.config.trajectory_length + 2, 3),
                       "grouped path")
    feasible = float(result.feasible.float().mean())
    held = hold_path_kernels("grouped path", solver, result.state, oracle, seed + 8)
    metrics = {
        "batch": batch, "group_size": GROUP_SIZE, "steps": steps, "compute_dtype": "float32",
        "seconds": seconds, "us_per_step_per_problem": per_problem_us(seconds, steps, batch),
        "solves_per_s": batch / seconds, "feasible_fraction": feasible,
        "groups_with_a_feasible_path": int(result.feasible.reshape(-1, GROUP_SIZE).any(dim=1)
                                           .sum()),
        "mean_length_feasible": (float(result.length[result.feasible].mean())
                                 if feasible > 0 else None),
        "replicas_bit_identical": True,
        "kernels_held": held,
    }
    if feasible < 0.98:
        raise AssertionError(f"grouped path: feasible fraction {feasible} below the 0.98 floor")
    return metrics, launches


def two_walls_world(batch: int, device):
    """(circle oracle, start, goal, bounds) of the holonomic two-walls scene
    with a disc of radius 0.3 (tests/test_api_service.py:18-22)."""
    import numpy as np
    import torch

    from nfopp_tpu_torch.worlds import CircleOracle, pad_obstacle_points, two_walls_environment

    env = two_walls_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    oracle = CircleOracle(torch.tensor(pts, device=device)[None],
                          torch.tensor(mask, device=device)[None],
                          torch.tensor([0.3], device=device),
                          torch.tensor([[0.0, 3.0, 0.0, 3.0]], device=device))

    def tile(a):
        return np.tile(np.asarray(a, np.float32)[None], (batch, 1))

    return oracle, tile(env.start), tile(env.goal), tile(env.bounds)


def holonomic_solve(device, seed: int, batch: int, steps: int):
    """Phase 9 (i): HolonomicSolver.run with make_onf_planner's demo config
    (100 features, no angle features, 400 pretraining iterations) on the
    two-walls scene; each f32 kernel launches once per step on 2-wide points.
    The feasible fraction is printed, not held."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.solver import PlannerFactory, evaluate_path
    from nfopp_tpu_torch.worlds import circle_collision

    oracle, start, goal, bounds = two_walls_world(batch, device)
    solver = PlannerFactory.make_onf_planner(circle_collision, oracle, device=device).solver
    g = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    state, aux = solver.run(state, oracle, steps, g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    check_launches(launches, MAIN_PATH, steps, "the holonomic path")
    paths = solver.full_trajectory(state)
    check_finite_paths(paths, (batch, solver.config.trajectory_length + 2, 2), "holonomic path")
    if not torch.isfinite(aux.field_loss).all() or not torch.isfinite(aux.trajectory_loss).all():
        raise AssertionError("holonomic path: non-finite losses")
    collides, length = evaluate_path(circle_collision, oracle, paths)
    feasible = float((~collides).float().mean())
    held = hold_path_kernels("holonomic path", solver, state, oracle, seed + 9)
    return {
        "batch": batch, "steps": steps, "config": "make_onf_planner", "seconds": seconds,
        "us_per_step_per_problem": per_problem_us(seconds, steps, batch),
        "feasible_fraction": feasible, "feasible_count": int((~collides).sum()),
        "mean_length_feasible": float(length[~collides].mean()) if feasible > 0 else None,
        "launches": {name: launches[name] for name in MAIN_PATH},
        "kernels_held": held,
    }


def drive_planner(what: str, planner, start, goal, bounds, new_goal, new_start, oracle_fn,
                  oracle, steps: int, seed: int) -> dict:
    """The ContinuousPlanner interface on one problem: init, `steps` steps
    (each f32 kernel once per step), moved goal and start, new bounds, 50
    more steps; the endpoints stay pinned (tests/test_api_service.py:70-100).
    After the `steps` steps every kernel is held on the planner's own inputs
    (`hold_path_kernels`)."""
    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.solver import evaluate_path

    def pinned(path, first, last, what):
        if not np.isfinite(path).all():
            raise AssertionError(f"planner API: non-finite path after {what}")
        for got, want in ((path[0], first), (path[-1], last)):
            if not np.allclose(got, want, atol=1e-5):
                raise AssertionError(f"planner API: endpoint {got} is not {want} after {what}")

    planner.init(start, goal, bounds)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    planner.step(steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_launches(dict(kernels.LAUNCHES), MAIN_PATH, steps, "the planner API")
    path = planner.get_path()
    n = planner.solver.config.trajectory_length
    if path.shape != (n + 2, len(start)):
        raise AssertionError(f"planner API: path shape {path.shape}")
    pinned(path, start, goal, "init and step")
    collides, length = evaluate_path(oracle_fn, oracle,
                                     torch.tensor(path, device=planner.solver.device)[None])
    held = hold_path_kernels(what, planner.solver, planner.state, oracle, seed)
    planner.update_goal_point(new_goal)
    pinned(planner.get_path(), start, new_goal, "update_goal_point")
    planner.update_start_point(new_start)
    pinned(planner.get_path(), new_start, new_goal, "update_start_point")
    planner.set_boundaries((0.0, 4.0, 0.0, 4.0))
    planner.step(50)
    pinned(planner.get_path(), new_start, new_goal, "set_boundaries and 50 steps")
    return {"steps": steps, "seconds": seconds, "feasible": not bool(collides[0]),
            "length": float(length[0]), "config": str(planner.solver.config.onf),
            "kernels_held": held}


def planner_api(device, seed: int, steps: int) -> dict:
    """Phase 9 (ii): the constrained planner of DEFAULT_PARAMETERS (no angle
    features on SE(2) poses) on the car scene, and make_onf_planner's
    holonomic planner on the two-walls scene, one problem each."""
    from nfopp_tpu_torch.solver import DEFAULT_PARAMETERS, PlannerFactory
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import circle_collision, rectangle_collision

    car, start, goal, bounds = car_world(1, device)
    constrained = PlannerFactory.make_constrained_onf_planner(
        rectangle_collision, car, DEFAULT_PARAMETERS, seed=seed, device=device)
    walls, start2, goal2, bounds2 = two_walls_world(1, device)
    holonomic = PlannerFactory.make_onf_planner(circle_collision, walls, seed=seed, device=device)
    return {
        "constrained": drive_planner("constrained planner", constrained, start[0], goal[0],
                                     bounds[0], [2.0, 2.0, 0.3], [0.6, 0.6, 0.0],
                                     rectangle_collision, car, steps, seed + 10),
        "holonomic": drive_planner("holonomic planner", holonomic, start2[0], goal2[0],
                                   bounds2[0], [2.0, 2.0], [0.6, 0.6], circle_collision, walls,
                                   steps, seed + 11),
    }


def checkpoint_round_trip(solver, state, oracle, g) -> dict:
    """Phase 9 (iii): phase 7's solve, tracked one more chunk, saved with its
    generator, restored bit for bit, and resumed for two chunks bit for bit
    as the uninterrupted run (on the card, at phase 7's batch)."""
    import tempfile

    import torch

    from nfopp_tpu_torch.solver import (
        restore_state,
        run_tracking_segment,
        save_state,
        tracking_init,
    )
    from nfopp_tpu_torch.utils.tree import tree_leaves

    def segment(carry, end, noise):
        return run_tracking_segment(solver, carry, oracle, end, noise, 0,
                                    ANYTIME["check_freq"], ANYTIME["samples_per_segment"], True)

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    carry = segment(tracking_init(solver, state), 1, g)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        path = save_state(carry, pathlib.Path(tmp) / "carry.npz", generator=g)
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        straight = segment(carry, 3, g)
        fresh = torch.Generator(device=g.device)
        t0 = time.perf_counter()
        restored = restore_state(tracking_init(solver, state), path, generator=fresh)
        restore_s = time.perf_counter() - t0
    if not same(restored, carry):
        raise AssertionError("checkpoint: the restored carry differs from the saved one")
    if not same(segment(restored, 3, fresh), straight):
        raise AssertionError("checkpoint: the resumed solve differs from the uninterrupted one")
    return {"batch": int(state.start.shape[0]), "bytes": size, "save_s": save_s,
            "restore_s": restore_s, "round_trip_bit_identical": True,
            "resumed_bit_identical": True}


def load_script(name: str):
    """scripts/<name>.py as a module: a script's scene, parameters and loops,
    as its users run them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class SuiteProbe:
    """Times and records what `run_grid_suite` runs, by wrapping the names
    its module looks up (restored on exit): the wavefront init (inputs and
    output), every BatchPlanner init and solve (batch, steps run, result),
    every shortcut pass (and the feasibility it leaves) and the evaluation's
    path statistics. Each timed part ends with a device synchronize."""

    def __init__(self, runner):
        import torch

        self.runner = runner
        self.calls = []  # (part, seconds, info)
        probe = self

        def timed(part, fn, record=None):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                probe.calls.append((part, time.perf_counter() - t0,
                                    record(args, out) if record else None))
                return out
            return call

        class Planner(runner.BatchPlanner):
            init_batch = timed("init", runner.BatchPlanner.init_batch,
                               lambda args, out: {"batch": int(out.start.shape[0]),
                                                  "states": out, "oracle": args[5]})
            solve = timed("solve", runner.BatchPlanner.solve, lambda args, out: {
                "steps_run": int(out.iterations.max()), "result": out, "solver": args[0].solver})

        self.patches = {
            "BatchPlanner": Planner,
            "batched_wavefront_trajectories": timed(
                "wavefront", runner.batched_wavefront_trajectories,
                lambda args, out: {"inputs": args, "output": out}),
            "_shortcut_pass": timed("shortcut", runner._shortcut_pass,
                                    lambda args, out: {"feasible": out[2].copy()}),
            "path_statistics": timed("evaluation", runner.path_statistics),
        }

    def __enter__(self):
        self.saved = {name: getattr(self.runner, name) for name in self.patches}
        for name, fn in self.patches.items():
            setattr(self.runner, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.runner, name, fn)

    def parts(self, part):
        return [(seconds, info) for p, seconds, info in self.calls if p == part]


def suite_solve(device, seed: int) -> tuple[dict, dict, list, object]:
    """Phase 10: the benchmark suite (run_grid_suite) on the corridor suite
    as its users run it (SUITE_WORLDS, bench_parameters, SUITE_SOLVE). Holds
    the feasible fraction after the restart round, finite paths with pinned
    endpoints, each f32 kernel launched once per step run by each solve and
    the field-gradient kernel also once per pretraining iteration of each
    init, the CUDA wavefront init equal to a CPU run bit for bit, and every
    kernel of the path on the inputs of the suite's next step (the
    field-gradient kernel also on pretraining's 200 points). Returns the
    metrics, the suite's launches, its scenarios and its SuiteResult (phase
    12 plans the same worlds with GPMP2)."""
    import argparse as _argparse

    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.bench import runner
    from nfopp_tpu_torch.ops.sampling import uniform_box_points

    script = load_script("run_benchmark_torch")
    parameters = script.bench_parameters()
    t0 = time.perf_counter()
    scenarios = script.build_scenarios(_argparse.Namespace(**SUITE_WORLDS))
    build_s = time.perf_counter() - t0
    batch = len(scenarios)

    with SuiteProbe(runner) as probe:
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = runner.run_grid_suite(scenarios, parameters, seed=seed, device=device,
                                       **SUITE_SOLVE)
        torch.cuda.synchronize()
        suite_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)

    inits, solves = probe.parts("init"), probe.parts("solve")
    shortcuts = probe.parts("shortcut")
    steps_run = [info["steps_run"] for _, info in solves]
    pretraining = int(parameters.planner.init_collision_iteration)
    for name, count in launches.items():
        want = sum(steps_run) + (pretraining * len(inits) if name == "field_grad" else 0)
        if count != (want if name in MAIN_PATH else 0):
            raise AssertionError(f"suite path: kernel {name} launched {count} times, want "
                                 f"{want if name in MAIN_PATH else 0} (solves of {steps_run} "
                                 f"steps, {len(inits)} inits)")

    starts = np.stack([sc.start for sc in scenarios])
    goals = np.stack([sc.goal for sc in scenarios])
    n = parameters.trajectory_length
    paths = torch.tensor(result.paths)
    check_finite_paths(paths, (batch, n + 2, 3), "suite path")
    for got, want, end in ((result.paths[:, 0], starts, "start"),
                           (result.paths[:, -1], goals, "goal")):
        if not np.allclose(got, want, atol=1e-5):
            raise AssertionError(f"suite path: a path's {end} is not pinned")

    (_, wave), = probe.parts("wavefront")
    cpu_wave = runner.batched_wavefront_trajectories(
        *(x.cpu() if torch.is_tensor(x) else x for x in wave["inputs"]))
    if not torch.equal(cpu_wave, wave["output"].cpu()):
        diff = float((cpu_wave - wave["output"].cpu()).abs().max())
        raise AssertionError(f"suite path: CUDA wavefront init differs from the CPU's ({diff})")

    solver, base = solves[0][1]["solver"], solves[0][1]["result"]
    init_states, oracle = inits[0][1]["states"], inits[0][1]["oracle"]
    held = hold_path_kernels("suite path", solver, base.state, oracle, seed + 12)
    g = torch.Generator(device=device).manual_seed(seed + 13)
    u = torch.rand((batch, solver.config.init_collision_points, 3), generator=g, device=device)
    points = uniform_box_points(u, init_states.bounds, with_angle=True)
    held["max_abs_err"]["field_grad_pretraining"] = hold_field_grad(
        "suite pretraining", init_states.field_params, points, solver.oracle_fn(oracle, points),
        solver.config.onf)
    held["shapes"]["field_grad_pretraining"] = list(points.shape)

    feasible = float(result.feasible.mean())
    base_iterations = base.iterations.float()
    solve_s = solves[0][0]

    def total(calls) -> float:
        return sum(seconds for seconds, _ in calls)

    metrics = {
        "suite": "corridor", **SUITE_WORLDS, **SUITE_SOLVE, "batch": batch, "seed": seed,
        "seconds": {
            "wall": build_s + suite_s, "scenario_build": build_s,
            "run_grid_suite": suite_s, "suite_wall_time": result.wall_time,
            "wavefront_init": total(probe.parts("wavefront")),
            "init": inits[0][0], "solve": solve_s,
            "shortcut": shortcuts[0][0] if shortcuts else 0.0,
            "restart": total(inits[1:] + solves[1:] + shortcuts[1:]),
            "evaluation": total(probe.parts("evaluation")),
        },
        "feasible": {
            "solve": float(base.feasible.float().mean()),
            "after_shortcut": float(np.mean(shortcuts[0][1]["feasible"])) if shortcuts else None,
            "after_restarts": feasible,
        },
        "feasible_count": int(result.feasible.sum()),
        "repaired_by_shortcut": result.repaired_by_shortcut,
        "restart_rounds_used": result.restart_rounds_used,
        "restart_lanes": [info["batch"] for _, info in inits[1:]],
        "steps_run": steps_run,
        "iterations_mean": float(np.mean(result.iterations)),
        "iterations_median": float(np.median(result.iterations)),
        "solve_iterations_mean": float(base_iterations.mean()),
        # per iteration a problem actually ran in the base solve (phase 7's metric)
        "us_per_iteration_per_problem": per_problem_us(solve_s, float(base_iterations.mean()),
                                                       batch),
        "mean_length_feasible": (float(result.lengths[result.feasible].mean())
                                 if feasible > 0 else None),
        "evaluator": result.log.settings["evaluator"],
        "start_or_goal_invalid": int((result.start_invalid | result.goal_invalid).sum()),
        "wavefront_cuda_equals_cpu": True,
        "launches": {name: launches[name] for name in MAIN_PATH},
        "kernels_held": held,
    }
    if feasible < 0.98:
        raise AssertionError(f"suite path: feasible fraction {feasible} below the 0.98 floor")
    return metrics, launches, scenarios, result


def host_service(device, seed: int) -> tuple[dict, dict]:
    """Phase 11a: the dynamic demo's host loop (scripts/dynamic_replan_demo_torch.py)
    for HOST_TICKS ticks: WorldState's sensor points of the oscillating disc
    -> update_world, update_robot_pose -> replan_cycle within HOST_BUDGET s
    with a PathPostprocessor. Holds the executed poses clear of the true
    disc, finite paths, each raw planner path starting at the pose it was
    fed and ending at the goal, and each f32 kernel launched once per step
    run (the field-gradient kernel also once per pretraining iteration)."""
    import numpy as np

    from nfopp_tpu_torch import kernels

    demo = load_script("dynamic_replan_demo_torch")
    kernels.reset_launches()
    result, traces = demo.host_loop(HOST_TICKS, 0.1, 0.35, HOST_BUDGET, device, seed)
    launches = dict(kernels.LAUNCHES)
    steps = sum(traces["steps"])
    pretraining = int(demo.demo_parameters().planner.init_collision_iteration)
    check_launches(launches, MAIN_PATH, steps, "the host service", {"field_grad": pretraining})
    if result["collided"] or result["min_clearance"] < demo.ROBOT_CLEAR:
        raise AssertionError(f"host service: clearance {result['min_clearance']} below the "
                             f"robot's radius {demo.ROBOT_CLEAR}")
    for fed, raw, path in zip(traces["fed"], traces["raw"], traces["path"]):
        if not (np.isfinite(raw).all() and np.isfinite(path).all()):
            raise AssertionError("host service: a non-finite path")
        if not (np.allclose(raw[0], fed, atol=1e-5)
                and np.allclose(raw[-1], demo.GOAL, atol=1e-6)):
            raise AssertionError(f"host service: a path from {raw[0]} to {raw[-1]}, fed {fed}")
    steps_per_cycle = np.asarray(traces["steps"], float)
    return {**result, "ticks": HOST_TICKS, "steps_run": steps,
            "steps_per_cycle": {"mean": float(steps_per_cycle.mean()),
                                "min": int(steps_per_cycle.min()),
                                "max": int(steps_per_cycle.max())},
            "launches": {name: launches[name] for name in MAIN_PATH}}, launches


def fleet_session(device, seed: int) -> tuple[dict, dict]:
    """Phase 11b: fleet_replan_session in the users' serving shape (FLEET:
    256 robots as 2 sub-fleets of 128 with one shared field each, 20 steps
    per cycle, 2 goal rounds x 25 cycles) on the car scene, f32. Holds each
    f32 kernel once per step of each sub-fleet burst, every group's replicas
    bit-identical, the goals exactly the last goal row, and the final plans'
    feasible fraction >= 0.98; then every kernel on one sub-fleet's inputs."""
    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_rows

    latency = load_script("replan_latency_torch")
    f = FLEET
    solver, oracle, env = latency.car_setup(device)
    states = latency.fleet_states(solver, oracle, env, f["robots"], f["group_size"], seed)
    check_replicas((states.field_params, states.field_opt_state), f["group_size"])
    rows = latency.goal_rows(env, f["robots"], f["goals"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    seconds, final, aux = latency.run_session(solver, oracle, states, rows, f["cycles"],
                                              f["steps"], f["group_size"], f["subgroups"],
                                              seed + 1)
    launches = dict(kernels.LAUNCHES)
    cycles = f["goals"] * f["cycles"]
    check_launches(launches, MAIN_PATH, cycles * f["subgroups"] * f["steps"], "the fleet session")
    check_replicas((final.field_params, final.field_opt_state), f["group_size"])
    if not np.array_equal(final.goal.cpu().numpy(), rows[-1]):
        raise AssertionError("fleet session: the goals are not the last goal row")
    check_finite_paths(solver.full_trajectory(final),
                       (f["robots"], solver.config.trajectory_length + 2, 3), "fleet session")
    if not torch.isfinite(aux.path_length).all():
        raise AssertionError("fleet session: non-finite path lengths")
    quality = latency.fleet_quality(solver, oracle, final)
    sub = f["robots"] // f["subgroups"]
    held = hold_path_kernels("fleet session", solver, tree_rows(final, 0, sub), oracle, seed + 14)
    per_cycle_ms = seconds / cycles * 1e3
    metrics = {**f, "compute_dtype": "float32", "seconds": seconds, "per_cycle_ms": per_cycle_ms,
               "per_burst_step_ms": seconds / (cycles * f["subgroups"] * f["steps"]) * 1e3,
               "robot_replans_per_s": f["robots"] / (per_cycle_ms * 1e-3),
               **quality, "replicas_bit_identical": True, "kernels_held": held}
    if quality["final_plans_feasible_frac"] < 0.98:
        raise AssertionError(f"fleet session: feasible fraction "
                             f"{quality['final_plans_feasible_frac']} below the 0.98 floor")
    return metrics, launches


def subgroups_schedule(device, seed: int) -> dict:
    """Phase 11c: fleet_replan_session(subgroups=2) (SUBGROUPS) against two
    independent sessions of its sub-fleets, each with its sub-fleet's noise
    source, with tests/test_session.py:118-160's tolerances: trajectories
    atol 5e-3, goals exact, starts atol 1e-5, path lengths rtol 1e-3.
    Whether the bits are equal is printed, not held."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_rows

    latency = load_script("replan_latency_torch")
    f = SUBGROUPS
    solver, oracle, env = latency.car_setup(device)
    states = latency.fleet_states(solver, oracle, env, f["robots"], f["group_size"], seed)
    rows = latency.goal_rows(env, f["robots"], f["goals"])
    kernels.reset_launches()
    _, out, aux = latency.run_session(solver, oracle, states, rows, f["cycles"], f["steps"],
                                      f["group_size"], f["subgroups"], seed + 1)
    check_launches(dict(kernels.LAUNCHES), MAIN_PATH,
                   f["goals"] * f["cycles"] * f["subgroups"] * f["steps"], "the subgrouped session")
    sub = f["robots"] // f["subgroups"]
    bits, worst = True, {"trajectory": 0.0, "start": 0.0, "path_length_rel": 0.0}
    for s in range(f["subgroups"]):
        lo, hi = s * sub, (s + 1) * sub
        # subfleet_generators(seed + 1, S)[s] is seeded (seed + 1) * S + s
        _, ref, ref_aux = latency.run_session(
            solver, oracle, tree_rows(states, lo, hi), rows[:, lo:hi], f["cycles"], f["steps"],
            f["group_size"], 1, (seed + 1) * f["subgroups"] + s)
        got = tree_rows(out, lo, hi)
        bits &= all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(ref)))
        bits &= torch.equal(aux.path_length[:, :, lo:hi], ref_aux.path_length)
        worst["trajectory"] = max(worst["trajectory"],
                                  float((got.trajectory - ref.trajectory).abs().max()))
        worst["start"] = max(worst["start"], float((got.start - ref.start).abs().max()))
        rel = ((aux.path_length[:, :, lo:hi] - ref_aux.path_length).abs()
               / ref_aux.path_length.abs())
        worst["path_length_rel"] = max(worst["path_length_rel"], float(rel.max()))
        if not torch.equal(got.goal, ref.goal):
            raise AssertionError("subgroups: the goals differ from the independent session's")
    if worst["trajectory"] > 5e-3 or worst["start"] > 1e-5 or worst["path_length_rel"] > 1e-3:
        raise AssertionError(f"subgroups: sub-fleets differ from independent sessions: {worst}")
    return {**f, "bits_equal": bool(bits), "max_differences": worst,
            "goals_equal": True}


def single_session(device, seed: int) -> tuple[dict, dict]:
    """Phase 11d: replan_session of one robot on the car scene, f32 (SINGLE:
    2 goals x 10 cycles x 40 steps). Holds each f32 kernel once per step,
    the goal exactly the last goal, a finite final path with pinned
    endpoints; then every kernel on the robot's inputs."""
    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels

    latency = load_script("replan_latency_torch")
    f = SINGLE
    solver, oracle, env = latency.car_setup(device)
    state = latency.fleet_states(solver, oracle, env, 1, 1, seed)
    rows = latency.goal_rows(env, 1, f["goals"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    seconds, final, aux = latency.run_session(solver, oracle, state, rows, f["cycles"],
                                              f["steps"], 1, 1, seed + 1)
    launches = dict(kernels.LAUNCHES)
    cycles = f["goals"] * f["cycles"]
    check_launches(launches, MAIN_PATH, cycles * f["steps"], "the single session")
    path = solver.full_trajectory(final)
    check_finite_paths(path, (1, solver.config.trajectory_length + 2, 3), "single session")
    path = path[0].cpu().numpy()
    if not np.array_equal(final.goal[0].cpu().numpy(), rows[-1, 0]):
        raise AssertionError("single session: the goal is not the last goal")
    if not (np.array_equal(path[-1], rows[-1, 0])
            and np.array_equal(path[0], final.start[0].cpu().numpy())):
        raise AssertionError("single session: the path's endpoints are not pinned")
    if not torch.isfinite(aux.path_length).all():
        raise AssertionError("single session: non-finite path lengths")
    held = hold_path_kernels("single session", solver, final, oracle, seed + 15)
    return {**f, "compute_dtype": "float32", "seconds": seconds,
            "per_cycle_ms": seconds / cycles * 1e3,
            **latency.fleet_quality(solver, oracle, final), "kernels_held": held}, launches


def dynamic_sessions(device, seed: int) -> tuple[dict, dict]:
    """Phase 11e: dynamic_replan_session of one robot and fleet_dynamic_session
    of DYNAMIC["fleet"] robots on staggered lanes (one shared field) against
    the dynamic demo's oscillating disc, DEFAULT_PARAMETERS' field with 100
    pretraining iterations, circle oracle, 20 steps per cycle. Holds each
    f32 kernel once per step of each session and every active robot's
    executed poses clear of the true disc; then every kernel on each
    session's last inputs."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.solver import ConstrainedSolver, config_from_parameters
    from nfopp_tpu_torch.worlds import circle_collision

    demo = load_script("dynamic_replan_demo_torch")
    f = DYNAMIC
    solver = ConstrainedSolver(config_from_parameters(demo.demo_parameters()), circle_collision,
                               device=device)
    step_dist = 0.35 * 0.1
    out, launches = {}, {}
    for what, (starts, goals), cycles in (
            ("single", (demo.START[None], demo.GOAL[None]), f["cycles"]),
            ("fleet", demo.fleet_lanes(f["fleet"]), f["fleet_cycles"])):
        builder, xs = demo.session_world(cycles, 0.1, 0.0, device)
        states = demo.session_states(solver, builder, xs[0], starts, goals, seed)
        torch.cuda.synchronize()
        kernels.reset_launches()
        seconds, final, aux = demo.run_session(solver, states, builder, xs, goals, f["steps"],
                                               step_dist, seed + 1)
        counted = dict(kernels.LAUNCHES)
        check_launches(counted, MAIN_PATH, cycles * f["steps"], f"the dynamic session ({what})")
        for name in MAIN_PATH:
            launches[name] = launches.get(name, 0) + counted[name]
        check = demo.session_check(aux, 0.1)
        if check["collided"]:
            raise AssertionError(f"dynamic session ({what}): an executed pose within the robot's "
                                 f"radius of the true disc ({check['min_clearance_while_active']})")
        if not torch.isfinite(aux.plan).all():
            raise AssertionError(f"dynamic session ({what}): a non-finite plan")
        held = hold_path_kernels(f"dynamic session ({what})", solver, final, builder(xs[-1]),
                                 seed + 16)
        out[what] = {"robots": len(goals), "cycles": cycles, "steps_per_cycle": f["steps"],
                     "seconds": seconds, "per_cycle_ms": seconds / cycles * 1e3, **check,
                     "kernels_held": held}
    return out, launches


def anytime_server(device, seed: int) -> tuple[dict, dict]:
    """Phase 11f: the refilling bf16 batch server of
    scripts/anytime_server_torch.py (SERVER: B=256, a pool of 3 x 256, 12
    chunks of 50 steps). Holds each bf16 kernel once per step run, more
    than one completed solve and a pool that did not run dry (so the rate
    is a sustained one); then every kernel on the lanes' inputs."""
    from nfopp_tpu_torch import kernels

    f = SERVER
    script = load_script("anytime_server_torch")
    server = script.Server(f["batch"], f["pool_rounds"], seed, device)
    kernels.reset_launches()
    result = script.serve(server, f["chunks"])
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, MAIN_PATH_BF16, f["chunks"] * server.check_freq, "the anytime server")
    if result["completed_solves"] <= 0:
        raise AssertionError("anytime server: no solve completed")
    if result["pool_exhausted"]:
        raise AssertionError(f"anytime server: {result['warning']}")
    held = hold_path_kernels("anytime server", server.solver, server.states, server.oracle,
                             seed + 17)
    return {**result, "pool_rounds": f["pool_rounds"], "kernels_held": held}, launches


def fleet_service(device, seed: int) -> tuple[dict, dict]:
    """Phase 11g: the online fleet node, FleetReplanningService, through
    scripts/replan_latency_torch.py's host fleet loop (FLEET_SERVICE: 256
    robots on the car scene, f32, one shared field per 128, 20-step chunks
    within a 0.1 s budget, a warm-up and 4 timed cycles; between cycles each
    robot follows its plan). Holds each f32 kernel once per step run, every
    group's replicas bit-identical, and a finite path for every active
    robot; then every kernel on one group's inputs."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_rows

    latency = load_script("replan_latency_torch")
    f = FLEET_SERVICE
    solver, oracle, env = latency.car_setup(device)
    args = SimpleNamespace(fleet=f["robots"], group_size=f["group_size"], timeout=f["budget"],
                           steps_per_chunk=f["steps_per_chunk"], cycles=f["cycles"], seed=seed)
    torch.cuda.synchronize()
    kernels.reset_launches()
    result, svc, paths = latency.host_fleet(args, solver, oracle, env)
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, MAIN_PATH, result["steps_run"], "the fleet service",
                   {"field_grad": solver.config.init_collision_iteration})
    check_replicas((svc._states.field_params, svc._states.field_opt_state), f["group_size"])
    if sorted(paths) != list(range(f["robots"])):
        raise AssertionError(f"fleet service: paths for {len(paths)} of {f['robots']} robots")
    if not all(p.ndim == 2 and p.shape[1] == 3 and np.isfinite(p).all() for p in paths.values()):
        raise AssertionError("fleet service: a non-finite or malformed path")
    held = hold_path_kernels("fleet service", solver, tree_rows(svc._states, 0, f["group_size"]),
                             oracle, seed + 18)
    return {**result, "group_size": f["group_size"], "steps_per_chunk": f["steps_per_chunk"],
            "compute_dtype": "float32", "replicas_bit_identical": True,
            "kernels_held": held}, launches


# phase 12, the paper's comparison: GPMP2 (baselines/gpmp2.py) on phase 10's
# corridor worlds and on run_gpmp2_torch.py's movingai and forest suites (16
# problems each, as in BASELINE_MEASURED.md's comparison), the benchmark
# adapter and the results analysis, and the reference demo (run_planner_torch.py)
GPMP2_SUITES = {"movingai": 16, "forest": 16}
GPMP2_CHECK = 4  # problems of the one-iteration CUDA-vs-CPU check
DEMO_STEPS = 1000
# The tolerances of tests/test_torch_gpmp2.py: residuals rtol 1e-6 (atol
# 1e-6 x the largest); the Jacobian rtol 1e-5, atol 1e-9 / fix_sigma; J^T J
# and J^T r within 1e-5 of |J|^T |J| and |J|^T |r| of an f64 product; the step
# of an f32 LU solve against an f64 solve of the same system at backward
# error 1e-6 and forward error 1e-3.
GPMP2_TOL = {"residuals": 1e-6, "jacobian": 1e-5, "normal": 1e-5, "backward": 1e-6,
             "forward": 1e-3}
ENDPOINT_TOL = 0.1  # fix_sigma pins the endpoints (tests/test_gpmp2.py:35-36)


def gpmp2_normal_errors(flat, problem, config) -> dict:
    """One Gauss-Newton iteration's pieces at `flat` and their errors against
    f64: (r, J, J^T J, J^T r, step) and {name: max error over its bound}."""
    import torch

    from nfopp_tpu_torch.baselines import gpmp2

    args = (problem.start, problem.goal, problem.sdf, config, problem.whitener)
    r, jtj, jtr = gpmp2._normal_equations(flat, problem, config)
    jac = gpmp2._jacobian(flat, *args)
    j64, r64 = jac.double(), r.double()
    jt = j64.transpose(1, 2)
    ratio = {
        "jtj": float(((jtj.double() - jt @ j64).abs()
                      / (jt.abs() @ j64.abs()).clamp_min(1e-30)).max()),
        "jtr": float(((jtr.double() - (jt @ r64[..., None])[..., 0]).abs()
                      / (jt.abs() @ r64.abs()[..., None])[..., 0].clamp_min(1e-30)).max()),
    }
    step = gpmp2._step(jtj, jtr, config)
    damped = jtj + config.damping * torch.diag_embed(torch.diagonal(jtj, dim1=1, dim2=2))
    a64 = (damped + 1e-8 * torch.eye(jtj.shape[-1], device=jtj.device)).double()
    b64, d64 = jtr.double(), step.double()
    exact = torch.linalg.solve(a64, b64)
    residual = (a64 @ d64[..., None])[..., 0] - b64
    ratio["backward"] = float((residual.abs().amax(-1) / (
        a64.abs().sum(-1).amax(-1) * d64.abs().amax(-1) + b64.abs().amax(-1))).max())
    ratio["forward"] = float(((d64 - exact).norm(dim=-1) / exact.norm(dim=-1)).max())
    return (r, jac, step), ratio


def gpmp2_agreement(sdf, starts, goals, init_xy, config) -> dict:
    """12a's check of one iteration on GPMP2_CHECK problems: residuals and
    Jacobian on CUDA against the CPU's at the same states, J^T J, J^T r and
    the LU step of each device against f64, at GPMP2_TOL."""
    from nfopp_tpu_torch.baselines import gpmp2

    k = GPMP2_CHECK
    sdf_k = gpmp2.SDF(*(x[:k] for x in sdf))
    flat, problem = gpmp2._setup(sdf_k, starts[:k], goals[:k], config, init_xy[:k])
    cpu_problem = gpmp2._Problem(*(x.cpu() for x in problem[:2]),
                                 gpmp2.SDF(*(x.cpu() for x in sdf_k)), problem.whitener.cpu())
    (r, jac, step), ratios = gpmp2_normal_errors(flat, problem, config)
    (r_cpu, jac_cpu, step_cpu), cpu_ratios = gpmp2_normal_errors(flat.cpu(), cpu_problem, config)
    r, jac = r.cpu(), jac.cpu()
    scale = r_cpu.abs().amax(dim=1, keepdim=True)
    out = {
        "problems": k,
        "residuals_rel": float(((r - r_cpu).abs() / (r_cpu.abs() + scale)).max()),
        "jacobian_max_abs": float((jac - jac_cpu).abs().max()),
        "cuda": ratios, "cpu": cpu_ratios,
        "step_cuda_vs_cpu_rel": float(((step.cpu() - step_cpu).norm(dim=-1)
                                       / step_cpu.norm(dim=-1)).max()),
    }
    if not ((r - r_cpu).abs() <= GPMP2_TOL["residuals"] * (r_cpu.abs() + scale)).all():
        raise AssertionError(f"gpmp2: CUDA residuals differ from the CPU's: {out}")
    if not ((jac - jac_cpu).abs() <= GPMP2_TOL["jacobian"] * jac_cpu.abs()
            + 1e-9 / config.fix_sigma).all():
        raise AssertionError(f"gpmp2: CUDA Jacobian differs from the CPU's: {out}")
    for device, errors in (("cuda", ratios), ("cpu", cpu_ratios)):
        for name, tol in (("jtj", "normal"), ("jtr", "normal"), ("backward", "backward"),
                          ("forward", "forward")):
            if errors[name] > GPMP2_TOL[tol]:
                raise AssertionError(f"gpmp2: {device} {name} error {errors[name]} over "
                                     f"{GPMP2_TOL[tol]}: {out}")
    return out


def gpmp2_solve(what: str, script, sdf, starts, goals, init_xy, config) -> tuple:
    """gpmp2_plan as run_gpmp2_torch.py runs it (`plan`, timed after a
    one-iteration warm-up), then its iterations again one by one with each
    problem's cost. Holds: no kernel of the port launched, every state
    finite, the endpoints within ENDPOINT_TOL of start and goal, no problem's
    cost rising over an iteration, the stepwise run equal to the plan.
    Returns (states, wall seconds, metrics)."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.baselines import gpmp2

    script.plan(sdf, starts, goals, config._replace(iterations=1), init_xy)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    states, wall = script.plan(sdf, starts, goals, config, init_xy)
    peak = torch.cuda.max_memory_allocated() - base
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"{what}: GPMP2 launched the port's kernels: {kernels.LAUNCHES}")

    flat, problem = gpmp2._setup(sdf, starts, goals, config, init_xy)
    costs = [gpmp2.gpmp2_cost(flat, problem.start, problem.goal, sdf, config, problem.whitener)]
    for _ in range(config.iterations):
        flat = gpmp2._gn_step(flat, problem, config)
        costs.append(gpmp2.gpmp2_cost(flat, problem.start, problem.goal, sdf, config,
                                      problem.whitener))
    costs = torch.stack(costs, dim=1)
    stepwise = flat.reshape(states.shape)
    batch = states.shape[0]
    if tuple(states.shape) != (batch, config.num_steps, 4) or not torch.isfinite(states).all():
        raise AssertionError(f"{what}: bad GPMP2 states, shape {tuple(states.shape)}")
    for got, want, end in ((states[:, 0, :2], starts, "start"), (states[:, -1, :2], goals, "goal")):
        miss = float((got - want).abs().max())
        if miss > ENDPOINT_TOL:
            raise AssertionError(f"{what}: a GPMP2 {end} is {miss} from its pin")
    if not (costs[:, 1:] <= costs[:, :-1]).all():
        raise AssertionError(f"{what}: a GPMP2 cost rose over an iteration")
    differ = float((stepwise - states).abs().max())
    if differ > 1e-3:
        raise AssertionError(f"{what}: the stepwise GPMP2 run differs from the plan by {differ}")
    metrics = {
        "problems": batch, "iterations": config.iterations, "num_steps": config.num_steps,
        "peak_memory_bytes": peak, "launches": 0,
        "endpoint_max_miss": float(max((states[:, 0, :2] - starts).abs().max(),
                                       (states[:, -1, :2] - goals).abs().max())),
        "cost_first_mean": float(costs[:, 0].mean()),
        "cost_final_mean": float(costs[:, -1].mean()),
        "steps_accepted_mean": float((costs[:, 1:] < costs[:, :-1]).float().sum(1).mean()),
        "stepwise_equals_plan": differ == 0.0,
    }
    return states, wall, metrics


def gpmp2_parts(sdf, starts, goals, init_xy, config) -> dict:
    """ms of one Gauss-Newton iteration's parts at the initial states (CUDA
    events, 3 calls each after a warm-up): the residuals, the per-problem
    Jacobians, J^T J and J^T r, and the LU step."""
    from nfopp_tpu_torch.baselines import gpmp2
    from nfopp_tpu_torch.tools.scene import time_ms

    flat, problem = gpmp2._setup(sdf, starts, goals, config, init_xy)
    args = (problem.start, problem.goal, problem.sdf, config, problem.whitener)
    jac = gpmp2._jacobian(flat, *args)
    r = gpmp2._residuals(flat, *args)
    jac_t = jac.transpose(1, 2)
    jtj, jtr = jac_t @ jac, (jac_t @ r[..., None])[..., 0]
    return {
        "residuals": time_ms(lambda: gpmp2._residuals(flat, *args), iters=3, warmup=1),
        "jacobian": time_ms(lambda: gpmp2._jacobian(flat, *args), iters=3, warmup=1),
        "normal_products": time_ms(lambda: (jac_t @ jac, jac_t @ r[..., None]), iters=3,
                                   warmup=1),
        "lu_step": time_ms(lambda: gpmp2._step(jtj, jtr, config), iters=3, warmup=1),
    }


def gpmp2_corridor(device, scenarios, suite_result) -> tuple[dict, object, object]:
    """Phase 12a: GPMP2 on phase 10's corridor worlds (footprint 1.0, the
    wavefront init on the card, GPMP2Config(num_steps=100), 30 iterations),
    after the one-iteration CUDA-vs-CPU check; the comparison row beside
    phase 10's NFOPP numbers on the same worlds. Returns the metrics, the
    GPMP2 results log and the states [B, N, 4]."""
    import numpy as np

    from nfopp_tpu_torch.baselines import GPMP2Config

    script = load_script("run_gpmp2_torch")
    config = GPMP2Config(num_steps=100)
    t0 = time.perf_counter()
    oracles, sdf, starts, goals, init_xy = script.prepare(
        scenarios, SUITE_SOLVE["footprint_radius"], config, device)
    prepare_s = time.perf_counter() - t0
    agreement = gpmp2_agreement(sdf, starts, goals, init_xy, config)
    log(f"gpmp2 agreement CUDA vs CPU, one iteration of {GPMP2_CHECK} problems: {agreement}")
    states, wall, metrics = gpmp2_solve("gpmp2 corridor", script, sdf, starts, goals, init_xy,
                                        config)
    metrics["iteration_ms"] = gpmp2_parts(sdf, starts, goals, init_xy, config)
    gpmp2_log, collides, stats = script.evaluate(states, scenarios, oracles, wall, "corridor")
    row = script.summary("corridor", wall, collides, stats, device)
    nfopp = suite_result.stats
    metrics.update(row, prepare_s=prepare_s, agreement=agreement, nfopp={
        "problems": len(nfopp), "collision_free": int(suite_result.feasible.sum()),
        "mean_length": float(np.mean([s.path_length for s in nfopp])),
        "mean_smoothness": float(np.mean([s.smoothness for s in nfopp])),
        "s_per_problem": suite_result.wall_time / len(nfopp),
    })
    return metrics, gpmp2_log, states


def gpmp2_suites(device) -> dict:
    """Phase 12b: run_gpmp2_torch.py's functions on its movingai suite (the
    committed city map's first 16 .scen entries) and forest suite (16 seeds),
    with 12a's holds; each suite's JSON line as the script prints it."""
    from nfopp_tpu_torch.baselines import GPMP2Config

    script = load_script("run_gpmp2_torch")
    config = GPMP2Config(num_steps=100)
    out = {}
    for suite, seeds in GPMP2_SUITES.items():
        scenarios = script.build_scenarios(suite, seeds, 0.0)
        oracles, sdf, starts, goals, init_xy = script.prepare(scenarios, 1.0, config, device)
        states, wall, metrics = gpmp2_solve(f"gpmp2 {suite}", script, sdf, starts, goals,
                                            init_xy, config)
        _, collides, stats = script.evaluate(states, scenarios, oracles, wall, suite)
        line = script.summary(suite, wall, collides, stats, device)
        print(json.dumps(line), flush=True)
        out[suite] = {**line, **metrics}
    return out


def adapter_analysis(device, scenario, nfopp_path, gpmp2_path, nfopp_log, gpmp2_log) -> dict:
    """Phase 12c: a BenchmarkAdapter on one corridor world on the card (its
    collision answers against the dilated grid on obstacle cells and free
    cells, both planners' paths evaluated and saved), then phase 10's and
    12a's logs through analysis.load_results / merge_results /
    aggregate_stats / format_stats_table; the table is logged."""
    import tempfile

    import numpy as np

    from nfopp_tpu_torch.bench import BenchmarkAdapter, BenchmarkCollisionChecker, ResultsLog
    from nfopp_tpu_torch.bench import analysis
    from nfopp_tpu_torch.utils import Position2
    from nfopp_tpu_torch.worlds import dilate

    radius = SUITE_SOLVE["footprint_radius"]
    truth = dilate(scenario.blocked, int(np.ceil(radius / scenario.resolution)))
    rng = np.random.RandomState(0)
    blocked_cells = np.argwhere(scenario.blocked)
    free_cells = np.argwhere(~truth)
    cells = np.concatenate([blocked_cells[rng.choice(len(blocked_cells), 64, replace=False)],
                            free_cells[rng.choice(len(free_cells), 64, replace=False)]])
    ox, oy = scenario.origin
    poses = np.stack([ox + (cells[:, 1] + 0.5) * scenario.resolution,
                      oy + (cells[:, 0] + 0.5) * scenario.resolution,
                      rng.uniform(-np.pi, np.pi, len(cells))], axis=1).astype(np.float32)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = pathlib.Path(tmp)
        adapter = BenchmarkAdapter(scenario, radius, log_file=tmp / "adapter.json", device=device)
        want = truth[cells[:, 0], cells[:, 1]]
        if not np.array_equal(adapter.collides_positions(poses), want):
            raise AssertionError("adapter: collides_positions disagrees with the grid")
        if not np.array_equal(BenchmarkCollisionChecker(adapter).check_collision(poses), want):
            raise AssertionError("adapter: the collision checker disagrees with the grid")
        if not (adapter.is_collision(Position2.from_vec(poses[0]))
                and not adapter.is_collision(Position2.from_vec(poses[-1]))):
            raise AssertionError("adapter: is_collision disagrees with the grid")
        for path, name in ((nfopp_path, "constrained_onf_planner"), (gpmp2_path, "gpmp2_torch")):
            saved = adapter.evaluate_and_save_results(path, name)
        doc = ResultsLog.load(saved)
        plans = {name: run["plans"][name] for run in doc["runs"] for name in run["plans"]}
        evaluated = {name: {"path_collides": plan["stats"]["path_collides"],
                            "path_length": plan["stats"]["path_length"]}
                     for name, plan in plans.items()}
        if set(plans) != {"constrained_onf_planner", "gpmp2_torch"}:
            raise AssertionError(f"adapter: saved plans {sorted(plans)}")

        files = [nfopp_log.save(tmp / "nfopp.json"), gpmp2_log.save(tmp / "gpmp2.json")]
        merged = analysis.merge_results(files, tmp / "merged.json")
        document = analysis.load_results([merged])
        aggregated = analysis.aggregate_stats(document)
        table = analysis.format_stats_table(aggregated)
    counts = {planner: rows["path_length"]["count"] for planner, rows in aggregated.items()}
    if len(counts) != 2 or len(set(counts.values())) != 1:
        raise AssertionError(f"analysis: runs per planner {counts}")
    for line in table.splitlines():
        log("  " + line)
    return {"collision_answers": len(cells), "evaluated": evaluated, "runs": counts,
            "collision_free": {p: 1 - rows["path_collides"]["mean"]
                               for p, rows in aggregated.items()}}


def demo(device, seed: int) -> tuple[dict, dict]:
    """Phase 12d: run_planner_torch.py's functions, one car-scene problem for
    DEMO_STEPS steps in f32, no frames: each f32 kernel once per step, a
    finite final path with pinned endpoints; its feasibility is printed."""
    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels

    script = load_script("run_planner_torch")
    kernels.reset_launches()
    solver, state, oracle, g = script.build(seed, device)
    state, losses, elapsed = script.run(solver, state, oracle, g, DEMO_STEPS, log=lambda _: None)
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, MAIN_PATH, DEMO_STEPS, "the demo",
                   extra={"field_grad": solver.config.init_collision_iteration})
    path, collides, length = script.final_path(solver, state, oracle)
    if path.shape != (solver.config.trajectory_length + 2, 3) or not np.isfinite(path).all():
        raise AssertionError(f"demo: bad final path, shape {path.shape}")
    for got, want, end in ((path[0], state.start[0], "start"), (path[-1], state.goal[0], "goal")):
        if not np.allclose(got, want.cpu().numpy(), atol=1e-5):
            raise AssertionError(f"demo: the path's {end} is not pinned")
    if not all(np.isfinite(loss) for _, *pair in losses for loss in pair):
        raise AssertionError("demo: non-finite losses")
    torch.cuda.synchronize()
    return {"steps": DEMO_STEPS, "seconds": elapsed, "ms_per_step": elapsed / DEMO_STEPS * 1e3,
            "field_loss": losses[-1][1], "trajectory_loss": losses[-1][2],
            "length": length, "collision_free": not collides,
            "launches": {name: launches[name] for name in MAIN_PATH}}, launches


# phase 13, the merged field+trajectory step and the Jacobi order
# (experimental/merged_step.py, ExperimentalConstrainedSolver) on the car
# scene, and the suite and parity scripts through their functions at a few
# seeds and full width. MERGED_CELLS: (line, order, bf16, group size).
# SCRIPT_RUNS: each script's size; every solve runs the script's default
# budget of 1000 iterations but the sweep's (500). The reliability probe runs
# one seed (its three solves of 1000 steps, the shared one always to the
# end, take ~40 s a seed).
MERGED_CELLS = (("merged_path", "merged", False, 1), ("merged_path_bf16", "merged", True, 1),
                ("grouped_merged_path", "merged", False, GROUP_SIZE),
                ("jacobi_path", "jacobi", False, 1))
SCRIPT_RUNS = {"compare_suites": {"worlds": 16, "min_geodesic": 120.0, "iterations": 1000},
               "shortcut_gains": {"suite": "corridor"},
               "run_sweep": {"worlds": 16, "sigmas": (2.5, 5.0), "weights": (100.0,),
                             "iterations": 500},
               "two_walls_reliability": {"seeds": 1, "restarts": 8, "iterations": 1000},
               "compare_with_reference": {"seeds": 16, "iterations": 1000},
               "compare_holonomic": {"seeds": 4, "iterations": 1000}}


def order_solve(device, seed: int, batch: int, steps: int, order: str, bf16: bool,
                group_size: int) -> tuple[dict, dict]:
    """Phase 13: the car-scene solve in the merged or Jacobi order
    (ExperimentalConstrainedSolver), f32 or bf16, one field per problem
    (`run`) or one per group of `group_size` (`init_state(group_size)` +
    `run_grouped`). The merged step launches none of the port's kernels; the
    Jacobi order launches each f32 kernel once per step and is held against
    the plain versions on its own inputs (`hold_path_kernels`); a group's
    replicas end bit-identical. The feasible fraction is printed, not held."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.solver import evaluate_path, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    cfg = bf16_config(run_planner_config()) if bf16 else run_planner_config()
    oracle, start, goal, bounds = car_world(batch, device)
    solver = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=device,
                                           **{f"{order}_step": True})
    g = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle, group_size=group_size)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    if group_size > 1:
        state, aux = solver.run_grouped(state, oracle, steps, group_size, g)
    else:
        state, aux = solver.run(state, oracle, steps, g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    what = f"the {order} path ({cfg.onf.compute_dtype}, groups of {group_size})"
    check_launches(launches, MAIN_PATH if order == "jacobi" else (), steps, what)
    paths = solver.full_trajectory(state)
    check_finite_paths(paths, (batch, cfg.trajectory_length + 2, 3), what)
    if not torch.isfinite(aux.field_loss).all() or not torch.isfinite(aux.trajectory_loss).all():
        raise AssertionError(f"{what}: non-finite losses")
    if group_size > 1:
        check_replicas((state.field_params, state.field_opt_state), group_size)
    collides, length = evaluate_path(rectangle_collision, oracle, paths)
    feasible = float((~collides).float().mean())
    metrics = {
        "batch": batch, "steps": steps, "order": order, "compute_dtype": cfg.onf.compute_dtype,
        "group_size": group_size, "seconds": seconds,
        "us_per_step_per_problem": per_problem_us(seconds, steps, batch),
        "solves_per_s": batch / seconds, "feasible_fraction": feasible,
        "feasible_count": int((~collides).sum()),
        "mean_length_feasible": float(length[~collides].mean()) if feasible > 0 else None,
        "final_field_loss": float(aux.field_loss[:, -1].mean()),
        "launches_per_step": {name: count / steps for name, count in launches.items()},
    }
    if group_size > 1:
        metrics["replicas_bit_identical"] = True
    if order == "jacobi":
        metrics["kernels_held"] = hold_path_kernels("jacobi path", solver, state, oracle,
                                                    seed + 13)
    return metrics, launches


def by_x(points, ages):
    """A replay buffer [B, K, 3] and its ages as a set: rows sorted by x (the
    floor moves scores by < 1e-4 and may reorder two picks of near-equal
    score without changing which candidates are picked)."""
    import torch

    order = torch.argsort(points[..., 0], dim=1)
    return (torch.gather(points, 1, order[..., None].expand_as(points)),
            torch.gather(ages, 1, order))


def merged_agreement(device, seed: int) -> dict:
    """Phase 13: one step of 4 car-scene problems, 10 merged steps into a
    solve. (a) The merged step against the Jacobi order on the card, from the
    same state and noise, before the field's Adam update: the field loss and
    every parameter gradient at phase 3's field-gradient tolerances (with its
    ReLU-kink recomputation on the Jacobi order's training points), the
    trajectory loss rtol 1e-4, the trajectory and both multiplier vectors
    atol 1e-5, and the same replay buffer while no candidate's weight sits
    below buffer_weight_floor (the merged step has no floor,
    merged_step.py:274), compared as sets of picks (`by_x`). (b) One merged step on the card against the CPU,
    from the same state and noise, at agreement_check's tolerances: every
    tensor but the field parameters atol 1e-5 (losses rtol 1e-4), the field
    parameters atol 1e-4 (Adam's lr * g / (|g| + eps))."""
    import torch

    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.experimental.merged_step import merged_partial_step, onf_forward_acts
    from nfopp_tpu_torch.ops.sampling import GeneratorNoise
    from nfopp_tpu_torch.solver import run_planner_config
    from nfopp_tpu_torch.solver.field import buffer_log_weights, field_sample_pre
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map
    from nfopp_tpu_torch.worlds import rectangle_collision

    cfg = run_planner_config()
    oracle, start, goal, bounds = car_world(4, device)
    merged = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=device,
                                           merged_step=True)
    jacobi = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=device,
                                           jacobi_step=True)
    g = torch.Generator().manual_seed(seed)
    state = merged.init_state(g, start, goal, bounds, oracle)
    state, _ = merged.run(state, oracle, 10, GeneratorNoise(g))

    def noise():
        return GeneratorNoise(torch.Generator().manual_seed(seed + 1))

    # (a) merged against jacobi, before the field update
    m_state, m_grads, m_loss, m_traj_loss = merged_partial_step(merged, state, oracle, noise())
    j_noise = noise()
    sample, j_loss, j_grads = jacobi._field_grads(state, oracle, j_noise)
    j_state, j_traj_loss = jacobi._trajectory_step(state, j_noise)
    truth = jacobi.oracle_fn(oracle, sample.train_points)
    onf = cfg.onf
    errors = {
        "field_loss": hold("merged vs jacobi field loss", [m_loss], [j_loss], [(1e-5, 1e-6)]),
        "field_grads": hold("merged vs jacobi field gradients", tree_leaves(m_grads),
                            tree_leaves(j_grads), [(2e-4, 2e-5)] * len(tree_leaves(j_grads)),
                            kinks=(state.field_params, sample.train_points, onf,
                                   field_grad_f64(truth, onf))),
        "trajectory_loss": hold("merged vs jacobi trajectory loss", [m_traj_loss],
                                [j_traj_loss], [(1e-4, 1e-5)]),
    }
    for name in ("trajectory", "constraint_multipliers", "collision_multipliers"):
        errors[name] = hold(f"merged vs jacobi {name}", [getattr(m_state, name)],
                            [getattr(j_state, name)], [(0.0, 1e-5)])
    pre = field_sample_pre(cfg, noise(), state.prev_trajectory, state.bounds)
    candidates = torch.cat([state.buffer_points, pre.fine], dim=1)
    ages = torch.cat([state.buffer_ages, torch.zeros_like(pre.fine[..., 0])], dim=1)
    logits = onf_forward_acts(state.field_params, candidates, onf).logits[..., 0]
    log_w = buffer_log_weights(cfg, logits, ages, floor=False)
    below = int((log_w < math.log(cfg.buffer_weight_floor)).sum())
    if below == 0 and not all(torch.equal(*picks) for picks in zip(
            by_x(m_state.buffer_points, m_state.buffer_ages),
            by_x(sample.buffer_points, sample.buffer_ages))):
        raise AssertionError("merged vs jacobi: different replay buffers with every "
                             "candidate's weight above the floor")
    result = {"merged_vs_jacobi": errors, "candidates_below_floor": below,
              "buffers_compared": below == 0,
              "min_candidate_weight": float(log_w.min().exp())}

    # (b) one merged step, CUDA against the CPU
    outs = []
    for dev in (device, torch.device("cpu")):
        slv = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=dev,
                                            merged_step=True)
        st, aux = slv.step_static(tree_map(lambda x: x.to(dev), state), car_world(4, dev)[0],
                                  noise(), with_reparam=False)
        outs.append(tree_map(lambda x: x.cpu(), (st, aux)))
    (a, aux_a), (b, aux_b) = outs
    cuda_cpu = {}
    for name in ("trajectory", "collision_multipliers", "constraint_multipliers",
                 "buffer_points", "buffer_ages"):
        cuda_cpu[name] = hold(f"merged CUDA vs CPU {name}", [getattr(a, name)],
                              [getattr(b, name)], [(0.0, 1e-5)])
    for name in aux_a._fields:
        cuda_cpu[name] = hold(f"merged CUDA vs CPU {name}", [getattr(aux_a, name)],
                              [getattr(aux_b, name)], [(1e-4, 1e-5)])
    params = list(zip(tree_leaves(a.field_params), tree_leaves(b.field_params)))
    cuda_cpu["field_params"] = hold("merged CUDA vs CPU field_params", *zip(*params),
                                    [(0.0, 1e-4)] * len(params))
    result["merged_cuda_vs_cpu"] = cuda_cpu
    return result


def timed_script(name: str, fn) -> tuple[dict, dict]:
    """Run one script's functions with the kernel counts set to 0 just before
    and read just after; returns (its line with the wall seconds, launches)."""
    import torch

    from nfopp_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    line = fn()
    torch.cuda.synchronize()
    return {**line, "seconds": time.perf_counter() - t0}, dict(kernels.LAUNCHES)


def suite_scripts(device, seed: int) -> list:
    """Phase 13's script runs: [(line name, its line, launches)], each script
    driven through its functions on the card (SCRIPT_RUNS), ours side only
    where it compares with the reference planner."""
    import numpy as np
    import torch

    runs = []

    def compare_suites():
        script = load_script("compare_suites_torch")
        spec = SCRIPT_RUNS["compare_suites"]
        scenarios = script.build_scenarios("corridor", spec["worlds"], spec["min_geodesic"])
        paths, wall = script.ours_suite_run(scenarios, script.suite_parameters("corridor"),
                                            spec["iterations"], device=device)
        check_finite_paths(torch.as_tensor(paths), (len(scenarios), 102, 3),
                           "compare_suites_torch")
        evals = [ev(p) for ev, p in zip(script.grid_evaluators(scenarios, device), paths)]
        feasible = [not c for c, _ in evals]
        return {"suite": "corridor", "worlds": len(scenarios),
                "iterations": spec["iterations"], "wall_s": wall,
                "feasible": int(sum(feasible)),
                "mean_length_feasible": float(np.mean([length for (c, length) in evals
                                                       if not c])) if any(feasible) else None,
                "reference": "skipped"}

    def shortcut_gains():
        row = load_script("shortcut_gains_torch").suite_gains(
            SCRIPT_RUNS["shortcut_gains"]["suite"], smoke=True, device=device)
        if row["feasible_after_shortcut"] < row["feasible_raw"]:
            raise AssertionError(f"shortcut_gains_torch: the pass lost feasibility: {row}")
        return row

    def run_sweep():
        script = load_script("run_sweep_torch")
        spec = SCRIPT_RUNS["run_sweep"]
        rows = script.sweep(script.sweep_scenarios("corridor", spec["worlds"]), spec["sigmas"],
                            spec["weights"], spec["iterations"], device=device, log=log)
        if [r["total"] for r in rows] != [spec["worlds"]] * len(rows):
            raise AssertionError(f"run_sweep_torch: bad rows {rows}")
        return {"rows": rows}

    def two_walls():
        spec = SCRIPT_RUNS["two_walls_reliability"]
        return load_script("two_walls_reliability_torch").reliability(
            spec["seeds"], spec["restarts"], spec["iterations"], device, log=log)

    def compare_with_reference():
        script = load_script("compare_with_reference_torch")
        spec = SCRIPT_RUNS["compare_with_reference"]
        seeds = range(spec["seeds"])
        paths, wall = script.ours_run(seeds, spec["iterations"], device, seed)
        check_finite_paths(torch.as_tensor(paths), (len(seeds), 102, 3),
                           "compare_with_reference_torch")
        feasible, lengths = script.evaluate(paths, device)
        return {"seeds": len(seeds), "iterations": spec["iterations"], "wall_s_batched": wall,
                "feasible": int(feasible.sum()),
                "mean_length_feasible": (float(lengths[feasible].mean()) if feasible.any()
                                         else None), "reference": "skipped"}

    def compare_holonomic():
        script = load_script("compare_holonomic_torch")
        spec = SCRIPT_RUNS["compare_holonomic"]
        seeds = list(range(spec["seeds"]))
        ours = script.ours_run(seeds, spec["iterations"], device, seed)
        check_finite_paths(torch.as_tensor(ours[0]), (len(seeds), 102, 2),
                           "compare_holonomic_torch")
        return {**script.summary(seeds, ours, device), "iterations": spec["iterations"],
                "reference": "skipped"}

    for name, fn in (("compare_suites", compare_suites), ("shortcut_gains", shortcut_gains),
                     ("run_sweep", run_sweep), ("two_walls_reliability", two_walls),
                     ("compare_with_reference", compare_with_reference),
                     ("compare_holonomic", compare_holonomic)):
        line, launches = timed_script(name, fn)
        log(f"phase 13 script {name}: {line['seconds']:.1f}s")
        runs.append((f"script_{name}", line, launches))
    return runs


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
    started = time.perf_counter()
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
    log("HMMA instructions per kernel (cuobjdump -sass): "
        f"{tensor_core_kernels(sass_listing(build))}")

    # 3. kernels against their plain versions
    kernel_results = check_kernels(device, peaks, args.seed, BATCH)
    batch_results, multi_f32 = check_batch_kernels(device, peaks, args.seed, BATCH)
    kernel_results.update(batch_results)
    print(json.dumps({"multi_f32": multi_f32}), flush=True)
    log(f"kernels on the other field configs, max abs err: {check_configs(device, args.seed)}")

    # 4. main path
    agreement, drift = agreement_check(device, args.seed)
    log(f"agreement CUDA vs CPU, one step of 4 problems: {agreement}")
    metrics, launches = solve(device, args.seed, BATCH, STEPS, MAIN_PATH)
    metrics.update(build_s=build_s, agreement_max_abs=agreement, card=card,
                   drift_trajectory={d["step"]: d["trajectory"] for d in drift})
    print(json.dumps({"main_path": metrics}), flush=True)

    # 5. bf16 batch path
    agreement = bf16_agreement_check(device, args.seed, batch_path=True)
    log(f"agreement CUDA vs CPU, one bf16 batch step of 4 problems: {agreement}")
    batch_metrics, batch_launches = solve(device, args.seed, BATCH, STEPS, BATCH_PATH)
    batch_metrics.update(problems_per_program=PROBLEMS_PER_PROGRAM[-1], compute_dtype="bfloat16",
                         agreement_max_abs=agreement, card=card)
    print(json.dumps({"batch_path": batch_metrics}), flush=True)
    launches.update({name: batch_launches[name] for name in BATCH_PATH})

    # 6. bf16 main path
    agreement = bf16_agreement_check(device, args.seed, batch_path=False)
    log(f"agreement CUDA vs CPU, one bf16 main-path step of 4 problems: {agreement}")
    bf16_metrics, bf16_launches = solve(device, args.seed, BATCH, STEPS, MAIN_PATH_BF16)
    bf16_metrics.update(compute_dtype="bfloat16", agreement_max_abs=agreement, card=card)
    print(json.dumps({"main_path_bf16": bf16_metrics}), flush=True)
    # the collision kernels' bf16 mode runs on both bf16 paths; its launches
    # are the batch path's, which the line reported before this path existed
    launches.update({name: bf16_launches[name] for name in MAIN_PATH_BF16
                     if name not in BATCH_PATH})

    # 7. tracked (anytime) path, bf16
    tracked, _, resumable = tracked_solve(device, args.seed, BATCH)
    print(json.dumps({"tracked_path": {**tracked, "card": card}}), flush=True)

    # 8. shared-field grouped path, f32
    grouped, _ = grouped_solve(device, args.seed, BATCH, STEPS)
    print(json.dumps({"grouped_path": {**grouped, "card": card}}), flush=True)

    # 9. holonomic path, planner API, checkpoint
    holonomic = holonomic_solve(device, args.seed, BATCH, STEPS)
    print(json.dumps({"holonomic_path": {**holonomic, "card": card}}), flush=True)
    api = planner_api(device, args.seed, STEPS)
    print(json.dumps({"planner_api": {**api, "card": card}}), flush=True)
    checkpoint = checkpoint_round_trip(*resumable)
    print(json.dumps({"checkpoint": {**checkpoint, "card": card}}), flush=True)

    # 10. benchmark suite (run_grid_suite), f32: its launches join the f32 kernels' counts
    suite, suite_launches, suite_scenarios, suite_result = suite_solve(device, args.seed)
    print(json.dumps({"suite_path": {**suite, "card": card}}), flush=True)
    for name in MAIN_PATH:
        launches[name] += suite_launches[name]

    # 11. replanning services: their launches join the kernels' counts
    t0 = time.perf_counter()
    host, host_launches = host_service(device, args.seed)
    print(json.dumps({"host_service": {**host, "card": card}}), flush=True)
    fleet, fleet_launches = fleet_session(device, args.seed)
    print(json.dumps({"fleet_session": {**fleet, "card": card}}), flush=True)
    print(json.dumps({"subgroups": {**subgroups_schedule(device, args.seed), "card": card}}),
          flush=True)
    single, single_launches = single_session(device, args.seed)
    print(json.dumps({"single_session": {**single, "card": card}}), flush=True)
    dynamic, dynamic_launches = dynamic_sessions(device, args.seed)
    print(json.dumps({"dynamic_sessions": {**dynamic, "card": card}}), flush=True)
    server, server_launches = anytime_server(device, args.seed)
    print(json.dumps({"anytime_server": {**server, "card": card}}), flush=True)
    service, service_launches = fleet_service(device, args.seed)
    print(json.dumps({"fleet_service": {**service, "card": card}}), flush=True)
    for counted in (host_launches, fleet_launches, single_launches, dynamic_launches,
                    service_launches):
        for name in MAIN_PATH:
            launches[name] += counted[name]
    for name in MAIN_PATH_BF16:
        launches[name] += server_launches[name]
    log(f"phase 11: {time.perf_counter() - t0:.1f}s")

    # 12. the paper's comparison: GPMP2 on phase 10's worlds and the script's
    # suites, the adapter and analysis, and the demo, whose launches join the
    # f32 kernels' counts
    t0 = time.perf_counter()
    gpmp2, gpmp2_log, gpmp2_states = gpmp2_corridor(device, suite_scenarios, suite_result)
    print(json.dumps({"gpmp2_corridor": {**gpmp2, "card": card}}), flush=True)
    print(json.dumps({"gpmp2_suites": {**gpmp2_suites(device), "card": card}}), flush=True)
    gpmp2_paths, _ = load_script("run_gpmp2_torch").dense_paths(gpmp2_states[:1].cpu().numpy())
    adapter = adapter_analysis(device, suite_scenarios[0], suite_result.paths[0], gpmp2_paths[0],
                               suite_result.log, gpmp2_log)
    print(json.dumps({"adapter_analysis": {**adapter, "card": card}}), flush=True)
    demo_metrics, demo_launches = demo(device, args.seed)
    print(json.dumps({"demo": {**demo_metrics, "card": card}}), flush=True)
    for name in MAIN_PATH:
        launches[name] += demo_launches[name]
    log(f"phase 12: {time.perf_counter() - t0:.1f}s")

    # 13. the merged step and the Jacobi order, then the suite and parity
    # scripts: their launches join the f32 kernels' counts
    t0 = time.perf_counter()
    for line, order, bf16, group_size in MERGED_CELLS:
        metrics, order_launches = order_solve(device, args.seed, BATCH, STEPS, order, bf16,
                                              group_size)
        print(json.dumps({line: {**metrics, "card": card}}), flush=True)
        for name in MAIN_PATH:
            launches[name] += order_launches[name]
    agreement = merged_agreement(device, args.seed)
    print(json.dumps({"merged_agreement": {**agreement, "card": card}}), flush=True)
    for line, metrics, script_launches in suite_scripts(device, args.seed):
        print(json.dumps({line: {**metrics, "card": card}}), flush=True)
        for name in MAIN_PATH:
            launches[name] += script_launches[name]
    log(f"phase 13: {time.perf_counter() - t0:.1f}s")

    entries = []
    for name, res in kernel_results.items():
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    log(f"chip_smoke: {time.perf_counter() - started:.1f}s in all")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
