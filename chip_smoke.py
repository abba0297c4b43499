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
     then the optimizer's kernel (kernels/adam.py) bit for bit against its
     plain version over 1000 successive updates of the car field (B=256)
     and of the trajectory, and over 20 of the field at B=255 with its
     inputs one float off 16-byte alignment, timed as captured launches
     beside its bytes bound;
  4. main path: the batched car-scene solve (run_planner_config, f32,
     B=256 x 1000 steps, seeded) through the port's entry points, after a
     one-step CUDA-vs-CPU agreement check on 4 problems (then 100 more steps
     of both, whose drift is logged, not held); each of its four kernels must
     launch once per step, and the feasible fraction must reach 0.98. On
     this path and every other one below the Adam kernel launches twice per
     step (the field's update and the trajectory's, one launch per tree) and
     once per pretraining iteration, counted with the path's kernels;
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
     steps, with their endpoints pinned (the planner pretrains and steps
     through its captured programs; its first step call captures the chunk
     program); and a checkpoint of phase 7's tracked solve, restored and
     resumed bit for bit;
 10. benchmark suite: run_grid_suite on the corridor suite as its users run
     it (256 worlds of scripts/run_benchmark_torch.py, geodesic >= 120,
     bench_parameters, f32, 8 restarts per failure, 128 shortcut trials,
     the native evaluator); each f32 kernel launches once per step run of
     each solve and the field-gradient kernel also once per pretraining
     iteration of each init, paths are finite with pinned endpoints, the
     feasible fraction after the restart round must reach 0.98, and the
     wavefront init on the card must equal its CPU run bit for bit; then
     the same worlds with aot=True (captured programs, as
     run_benchmark_torch.py --aot): its solve and restart seconds, every
     problem's feasibility, iterations and path equal to the eager run's
     bit for bit, 0.98 feasible, its launches held alike; both runs' launches join the f32 kernels' counts
     in the kernel line.
 11. replanning services (nfopp_tpu_torch.service, through the three driver
     scripts' functions), each f32 kernel (bf16 in f) launched once per step
     run: (a) the dynamic demo's host loop, 40 ticks of WorldState ->
     ReplanningService with a 0.08 s budget, clear of the true disc, each
     raw path from the pose it was fed to the goal (its planner captures
     its pretraining at set_goal and its chunk program in the first cycle);
     (b) fleet_replan_session in the users' serving shape (256 robots, 2
     sub-fleets of 128 with one
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
 14. program capture (solver.with_aot, utils/aot.py: each 10-step chunk of
     the static schedule captured once into a CUDA graph and replayed):
     (a) phases 4 and 6 again, f32 and bf16, B=256 x 1000 steps, same seed
     and inputs, the program captured before the timed window; each kernel
     of the path counted 1000 times through the replays, feasible >= 0.98,
     and the final state bit-identical to the eager phase's; then the f32
     batch again as a program whose Adam is PyTorch's elementwise kernels
     (`plain_adam`), its final state bit-identical to the kernel's; (b) phase 8's
     grouped path through BatchPlanner(aot_prefix=...), held the same way;
     (c) phase 11g's fleet service with replan_latency_torch's --aot, its
     cycle p50 / p99 beside 11g's; (d) tools/profile_step.py eager and with
     --aot, f32 and bf16: host and busy ms per step, idle share, graph
     replays per step; (e) scripts/profile_step2_torch.py's parts of the
     step at B=256, eager and captured. The launches of (a)-(c) join the
     kernels' counts; (d) and (e) time the step and are not counted.
 15. the problem mesh (parallel/mesh.py over torch.distributed, one process
     per rank, each a run of this script's --mesh-worker mode, which drives
     scripts/run_multihost_torch.py's `run` and then holds kernels 1-3b
     against their plain versions on its rank's own next-step inputs): (a)
     phase 4's cell (car scene, f32, B=256 x 1000 steps) through
     BatchPlanner(solver, problem_mesh()) in a world of 1 over nccl, its
     final state bit-identical to phase 4's, its time beside phase 4's; (b)
     two ranks sharing the card over gloo (--batch-per-host 128, --device
     cuda:0) against (a) as the 1-process run of the same 256 problems:
     every problem's feasibility equal, the global feasible fraction at
     least 0.98, the mean loss within the CPU test's rel 1e-4, then 100
     steps with one field spanning both ranks (--group-size 256), its
     replicas bit-identical, gathered; s per 1000 steps per rank, collectives
     per step and their host ms; (c) nfopp_tpu_torch.graft_entry.
     dryrun_multichip(2) with both ranks on cuda:0, every stage passing; (d)
     (b) over nccl on two cards where there are two, else a line saying why
     not; (e) every shared-field layout and step order on two ranks
     sharing the card over gloo (this script's --mesh-cases mode, car scene,
     f32, 100 steps each, eager and through BatchPlanner(aot_prefix=...),
     the captured run bit for bit against the eager one): (i) one field
     over both ranks (B=256, 128 per rank), s per 1000 steps, collectives
     and their host seconds per step, replays per step; (ii) 15 queries x 16
     restarts (B=240, 120 per rank, groups of 16: group 7 straddles the
     ranks) against the 1-process run of the same 240 problems, every
     problem's feasibility equal and the mean loss within rel 1e-4; (iii)
     the Jacobi and merged orders on independent problems, each rank's rows
     bit-identical to the same rows run alone in this process (rank r of 2
     without a process group: the rank's draws and batch size), and against
     the 1-process run of all 256, every problem's feasibility equal
     (Jacobi's rows bit-identical; the merged order's PyTorch reductions
     and batched products sum in an order that follows the batch size, so
     its first step before Adam is held at the field tolerances, and the
     1-process run from an init one float up is printed beside it), and
     the merged order with one field over both ranks (replicas equal); (iv) fleet_replan_session of 240 robots in 3
     sub-fleets of 80 (sub-fleet 1 straddles the ranks), one field per
     sub-fleet, 2 goals x 5 cycles of 20 steps: cycle ms, feasible plans and
     the least clearance. Kernels 1-3b launched once per step on
     every rank of (i)-(ii). The launches of (a), (b) and (e) join the
     kernels' counts.
 16. the bench on the card (bench_torch.py, the counterpart of bench.py):
     (a) the script as a subprocess, as its users run it, B=256 x 1000 steps
     in six modes: the default (bf16, captured) with --feas-sweep 3
     --anytime, --f32, --f32 --eager, --multi 8, --jacobi and --merged; each
     prints one JSON line, at least 0.98 feasible, each of its mode's
     kernels once per timed step and no other (--merged none); (b) captured
     against eager, B=256 x 100 steps from one init and one generator seed,
     every leaf of the final state bit-identical: run_batch P=8 (bf16), the
     Jacobi order (f32), the merged order (f32 and bf16) and grouped merged
     (groups of 8); then kernels 4 and 5 and the collision kernels' bf16
     mode held against their plain versions on the captured run_batch's own
     next-step inputs; (c) scripts/profile_step_torch.py's five ablation
     variants with --aot, B=256 x 50 steps. The launches of (a)'s timed
     loops and of (b)'s captured runs join the kernels' counts.
 17. the dynamic schedule and pretraining as captured programs
     (`solver.with_aot`: one program per step, one per pretraining
     iteration): (a) the car scene in f32 and bf16 and the holonomic
     two-walls scene, B=256, entering off the chunk (5 steps, then 100
     timed) and 7 steps from a chunk's start, the Jacobi and merged orders at
     B=64 (5, then 20), each captured run bit-identical to its eager run
     (`same_state`), each of its kernels once per step; then
     tools/profile_step.py --aot off the chunk (host and busy ms per step);
     (b) BatchPlanner(aot_prefix=...)'s init at the suite's config (100
     iterations on 200 points, phase 10's 256 corridor worlds) and the
     holonomic demo config's init (400 iterations, B=256), each captured
     twice and bit-identical to the eager init, its generator left where the
     eager init leaves it; (c) NFOPPlanner (the dynamic demo's parameters on
     the car scene) through init, step(7), step(13) and step(1000), after
     each call bit-identical to the eager solver driven alike; then phase
     11a's host loop again, its planner's programs from the store: cycle p50
     and p99 against the 0.08 s budget, steps per cycle; then a stored
     program replayed for a second solver after the capturing one is gone
     and its freed blocks hold NaN, bit for bit against eager; (d) kernels
     1, 2, 3a and 3b on the inputs the next step of (a)'s captured states
     gives them (car f32 and bf16, holonomic), and kernel 2 at
     pretraining's shapes (M=100 and 200 on the car fields, the holonomic
     2-wide points), each held against its plain version and timed beside
     its bound. The launches of (a)-(c)'s captured runs and inits join the
     kernels' counts.
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
import contextlib
import gc
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
# the optimizer's kernel (kernels/adam.py), f32 on every path and in both
# precisions: one launch per field update and one per trajectory update (two
# per step: every path here trains its field every step), one per
# pretraining iteration
ADAM = "adam"
ADAM_PER_STEP = 2
ADAM_UPDATES = 1000  # successive updates of phase 3's chains, a solve's
ADAM_OFFSET_UPDATES = 20  # of the chain whose first inputs sit one float off 16 bytes
# the kernels whose launches the summary line adds up over the phases
COUNTED = MAIN_PATH + (ADAM,)
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
    ADAM: "none (XLA fuses optax's update)",
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
    ADAM: "nfopp_tpu_torch/kernels/csrc/adam.cu",
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


def kernel_bound(name: str, onf, batch: int, n_params: int, m: int, dim: int, peaks) -> dict:
    """The least time kernel `name` could take on B problems of a field of
    `n_params` parameters each and M points of width `dim`: the larger of its
    operations over the peak of their type (f32 CUDA cores, or bf16 tensor
    cores for the bf16 kernels) and the bytes it must move over the memory
    rate. Returns bound_ms, bound_by and gflop."""
    _, f32_peak, bf16_peak, bytes_rate = peaks
    param_bytes = 4 * batch * n_params
    points_bytes = 4 * batch * m * dim
    moved = {
        "onf_forward": param_bytes + points_bytes + 4 * batch * m,
        "field_grad": 2 * param_bytes + points_bytes + 4 * batch * m + 4 * batch,
        "collision_fwd": param_bytes + points_bytes + 4 * batch * m + 8 * batch,
        "collision_bwd": param_bytes + 2 * points_bytes + 8 * batch * m + 8 * batch,
    }[COUNTERPART.get(name, name)]
    flops = 2.0 * field_macs(onf)[name] * batch * m
    peak = f32_peak if name in MAIN_PATH else bf16_peak
    t_ops, t_bytes = flops / peak * 1e3, moved / bytes_rate * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "gflop": flops / 1e9}


def add_bounds(results: dict, inputs: KernelInputs, peaks) -> None:
    """bound_ms of each kernel in `results` (`kernel_bound`) for this run's
    shapes."""
    for name, res in results.items():
        m = inputs.shapes[name]
        res.update(kernel_bound(name, inputs.onf, inputs.batch, inputs.n_params, m, 3, peaks))
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


@contextlib.contextmanager
def plain_adam():
    """Inside, every `solver.adam_update` runs the plain version of the Adam
    kernel (`kernels.adam_leaves_plain`) on the card: the plain-Adam
    program, PyTorch's 14 elementwise kernels per leaf."""
    from nfopp_tpu_torch.kernels import adam_leaves_plain
    from nfopp_tpu_torch.solver import adam as solver_adam

    kernel = solver_adam.adam_leaves
    solver_adam.adam_leaves = adam_leaves_plain
    try:
        yield
    finally:
        solver_adam.adam_leaves = kernel


def adam_chain(what: str, params, rates: tuple, eps: float, updates: int, seed: int,
               layout=None) -> int:
    """`updates` successive Adam updates of `params` (rows starting at step
    counts 0-6) by fresh gradients of changing scale (1e-2, 1, 1e-6, and
    zero every 100th update), through the kernel and, from the same start,
    through the plain version: every leaf of the two chains' parameters and
    states equal bit for bit after every update. `layout` places the first
    update's inputs and every gradient (the offset chain). Returns the number
    of updates held."""
    import torch

    from nfopp_tpu_torch.solver import adam_init, adam_update
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map

    lr, (b1, b2) = rates
    place = layout or (lambda t: t)
    device = tree_leaves(params)[0].device
    g = torch.Generator(device=device).manual_seed(seed)
    state = adam_init(params)
    rows = torch.arange(state.count.shape[0], dtype=torch.int32, device=device)
    start = tree_map(place, (tree_map(torch.clone, params), state._replace(count=rows % 7)))
    chains = {"kernel": start, "plain": start}
    differ = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(updates):
        scale = 0.0 if i % 100 == 99 else (1e-2, 1.0, 1e-6)[i % 3]
        grads = tree_map(lambda p: place(scale * torch.randn(p.shape, generator=g, device=device)),
                         params)
        for name, (p, s) in chains.items():
            with plain_adam() if name == "plain" else contextlib.nullcontext():
                chains[name] = adam_update(grads, s, p, lr, b1, b2, eps)
        for a, b in zip(tree_leaves(chains["kernel"]), tree_leaves(chains["plain"])):
            differ += (a.view(torch.int32) != b.view(torch.int32)).sum()
    if int(differ):
        raise AssertionError(f"{what}: the Adam kernel differs from its plain version in "
                             f"{int(differ)} elements over {updates} updates")
    return updates


def graph_ms(fn, calls: int = 10) -> float:
    """ms per call of `fn`, captured `calls` times in a row into one CUDA
    graph and replayed (`time_ms`): the device's time, as a captured step
    runs it, without the host's time to launch it."""
    import torch

    from nfopp_tpu_torch.tools.scene import time_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay) / calls


def check_adam(device, peaks, seed: int, batch: int) -> dict:
    """Phase 3, the optimizer: the Adam kernel bit for bit against its plain
    version over ADAM_UPDATES successive updates of the car field (B
    problems, its 9 leaves) and of the trajectory [B, N, 3], each at its
    solver's rates; the field again at B - 1 rows with its first inputs and
    every gradient one float off 16-byte alignment (element-wise quads, rows
    straddling quads, a short last quad); two launches giving identical bits;
    each tree timed as captured launches (`graph_ms`, ms) and eagerly, beside
    its plain version and its bound, 28 bytes per element (g, m, v and p
    read, m', v' and p' written) over the memory rate."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.models import init_onf_params
    from nfopp_tpu_torch.solver import run_planner_config
    from nfopp_tpu_torch.tools.scene import time_ms
    from nfopp_tpu_torch.utils.device import device_constant
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = run_planner_config()
    g = torch.Generator(device=device).manual_seed(seed + 3)
    trees = {"field": (init_onf_params(g, cfg.onf, batch, device),
                       (cfg.collision_lr, cfg.collision_betas)),
             "trajectory": (torch.randn((batch, cfg.trajectory_length, 3), generator=g,
                                        device=device),
                            (cfg.trajectory_lr, cfg.trajectory_betas))}

    def off_by_one_float(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    cases = {}
    for name, (params, rates) in trees.items():
        held = adam_chain(f"adam {name}", params, rates, cfg.adam_eps, ADAM_UPDATES, seed + 4)
        lr, (b1, b2) = rates
        grads = tree_map(lambda p: 1e-2 * torch.randn(p.shape, generator=g, device=device), params)
        moments = tree_map(lambda p: 1e-2 * torch.randn(p.shape, generator=g, device=device),
                           (params, params))
        mu, nu = moments[0], tree_map(lambda t: t * t, moments[1])
        steps = (1 + torch.arange(batch, device=device) % 7).to(torch.float32)
        bc1, bc2 = (1 - torch.pow(device_constant(b, device), steps) for b in (b1, b2))
        args = (grads, mu, nu, params, bc1, bc2, lr, b1, b2, cfg.adam_eps)
        same_bits(f"adam {name}", lambda: kernels.adam_leaves(*args))
        elements = sum(p.numel() for p in tree_leaves(params))
        cases[name] = {
            "leaves": len(tree_leaves(params)), "elements": elements, "updates_held": held,
            "ms": graph_ms(lambda: kernels.adam_leaves(*args)),
            "plain_ms": graph_ms(lambda: kernels.adam_leaves_plain(*args)),
            "eager_ms": time_ms(lambda: kernels.adam_leaves(*args)),
            "plain_eager_ms": time_ms(lambda: kernels.adam_leaves_plain(*args)),
            "bound_ms": 28 * elements / peaks[3] * 1e3, "bound_by": "bytes",
        }
        log(f"kernel adam ({name}): {cases[name]}")
    params = tree_map(lambda t: t[1:].contiguous(), trees["field"][0])
    cases["field"]["offset_updates_held"] = adam_chain(
        "adam field, one float off", params, trees["field"][1], cfg.adam_eps,
        ADAM_OFFSET_UPDATES, seed + 5, layout=off_by_one_float)
    return {ADAM: {"max_abs_err": 0.0, **cases["field"], "trajectory": cases["trajectory"]}}


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


def solve(device, seed: int, batch: int, steps: int, path: tuple, aot: str | None = None,
          adam_per_step: int = ADAM_PER_STEP):
    """The B x steps car-scene solve through the kernels of `path`: the f32 or
    bf16 main path (ConstrainedSolver.run) or the bf16 batch path (run_batch,
    P=8). Each kernel of `path` must launch once per step and no other kernel
    at all. With `aot` (a program prefix; main paths only) the solver runs as
    replays of its captured chunk program (`solver.with_aot`), captured
    before the timed window by one chunk from another generator, and the
    launches are counted through the replays. Returns the metrics, the
    launches and the final state."""
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
    if aot is not None:
        solver = solver.with_aot(aot)
    g = torch.Generator(device=device).manual_seed(seed)
    state = solver.init_state(g, start, goal, bounds, oracle)
    if aot is not None:
        solver.run(state, oracle, cfg.reparametrize_trajectory_freq,
                   torch.Generator(device=device).manual_seed(seed + 1))
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

    check_launches(launches, path, steps, "the solve", adam_per_step=adam_per_step)
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
    if aot is not None:
        metrics["programs"] = solver.aot_events
    if feasible < 0.98:
        raise AssertionError(f"feasible fraction {feasible} below the 0.98 floor")
    return metrics, launches, state


def check_launches(launches: dict, path: tuple, steps: int, what: str,
                   extra: dict | None = None, adam_per_step: int = ADAM_PER_STEP) -> None:
    """Each kernel of `path` launched once per step (`steps` times) and
    extra[name] times more (pretraining: `pretrain_launches`), the Adam
    kernel `adam_per_step` times per step (the field's and the trajectory's
    update, on every path) and extra["adam"] times more, every other kernel
    never."""
    extra = extra or {}
    for name, count in launches.items():
        if name == ADAM:
            want = adam_per_step * steps + extra.get(ADAM, 0)
        else:
            want = steps + extra.get(name, 0) if name in path else 0
        if count != want:
            raise AssertionError(f"kernel {name} launched {count} times in {steps} steps of "
                                 f"{what} (path {path}, besides {extra})")


def pretrain_launches(iterations: int) -> dict:
    """`check_launches`' extra launches of `iterations` pretraining
    iterations: one of the field-gradient kernel and one of the Adam kernel
    each."""
    return {"field_grad": iterations, ADAM: iterations}


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


def time_kernel(name: str, fn, plain, onf, params, m: int, dim: int, peaks) -> dict:
    """ms per call of a kernel's wrapper `fn` and of its plain version
    (CUDA events over 20 calls), beside the kernel's bound at this shape
    (`kernel_bound`: B problems of `params`, M points of width `dim`)."""
    from nfopp_tpu_torch.tools.scene import time_ms
    from nfopp_tpu_torch.utils.tree import tree_leaves

    leaves = tree_leaves(params)
    batch = leaves[0].shape[0]
    n_params = sum(p.numel() for p in leaves) // batch
    return {"m": m, "dim": dim, "ms": time_ms(fn), "plain_ms": time_ms(plain),
            **kernel_bound(name, onf, batch, n_params, m, dim, peaks)}


def hold_path_kernels(what: str, solver, state, oracle, seed: int,
                      problems_per_program: int | None = None, peaks=None) -> dict:
    """Each kernel of `solver`'s path against its plain version on the inputs
    one more step from `state` would give it (noise from a generator seeded
    with `seed`): the field's parameters, the candidates it scores [B, K+N-1,
    d] (onf_forward), its training points and their oracle labels [B, (N-1)
    +K+R, d] (field_grad), and the trajectory's collision points with their
    multipliers, beta and the trajectory loss's cotangents (collision terms,
    forward and backward; zero multipliers and beta 1 on a holonomic path).
    With `problems_per_program` (the batch path, `run_batch`) the field's two
    passes are the multi-problem kernels' (onf_multi, field_grad_multi, their
    bf16 casts "multi"). Phase 3's tolerances, its ReLU-kink recomputation
    and, in bf16, the path's casts and the tie allowance. Returns the largest
    difference of each kernel; with `peaks` (the main paths) also each
    kernel's and its plain version's time on these inputs beside its bound
    (`time_kernel`)."""
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
    if problems_per_program is None:
        score, name = kernels.onf_forward(params, candidates, onf), "onf_forward"
        plain, score_casts = kernels.onf_forward_plain(params, candidates, onf), casts
    else:
        score = kernels.onf_multi(params, candidates, onf, problems_per_program)
        name, plain = "onf_multi", kernels.onf_multi_plain(params, candidates, onf)
        score_casts = "multi" if bf16 else None
    errors = {name: hold(f"{what} {name}", [score], [plain], [(1e-4, 2e-4)],
                         kinks=(params, candidates, onf, logits_f64(onf, score_casts)),
                         bf16=bf16)}

    sample = field_sample_post(cfg, pre, score[..., 0], candidates, ages)
    points = sample.train_points
    errors["field_grad" if problems_per_program is None else "field_grad_multi"] = (
        hold_field_grad(what, params, points, solver.oracle_fn(oracle, points), onf,
                        problems_per_program))

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
    shapes = {name: candidates.shape, "field_grad": points.shape, "collision": x.shape}
    log(f"{what}: kernels held on the path's own inputs {dict(shapes)}: {errors}")
    held = {"max_abs_err": errors,
            "shapes": {name: list(shape) for name, shape in shapes.items()}}
    if peaks is not None and problems_per_program is None:
        from nfopp_tpu_torch.kernels.collision_terms import collision_bwd, collision_fwd

        suffix = "_bf16" if bf16 else ""
        dim = x.shape[-1]
        truth = solver.oracle_fn(oracle, points)
        cotangents = weights.expand(batch, 2).contiguous()
        held["timings"] = {
            "onf_forward" + suffix: time_kernel(
                "onf_forward" + suffix, lambda: kernels.onf_forward(params, candidates, onf),
                lambda: kernels.onf_forward_plain(params, candidates, onf), onf, params,
                candidates.shape[1], dim, peaks),
            "field_grad" + suffix: time_kernel(
                "field_grad" + suffix, lambda: kernels.field_grad(params, points, truth, onf),
                lambda: kernels.field_grad_plain(params, points, truth, onf), onf, params,
                points.shape[1], dim, peaks),
            "collision_fwd" + suffix: time_kernel(
                "collision_fwd" + suffix, lambda: collision_fwd(params, x, mult, onf, beta),
                lambda: kernels.collision_terms_plain(params, x, mult, onf, beta), onf, params,
                x.shape[1], dim, peaks),
            "collision_bwd" + suffix: time_kernel(
                "collision_bwd" + suffix,
                lambda: collision_bwd(params, x, mult, cotangents, onf, beta),
                lambda: collision_grads(kernels.collision_terms_plain, params, x, mult, onf, beta,
                                        weights), onf, params, x.shape[1], dim, peaks),
        }
        log(f"{what}: kernel times on the path's own inputs: {held['timings']}")
    return held


def hold_field_grad(what: str, params, points, truth, onf,
                    problems_per_program: int | None = None) -> float:
    """The field-gradient kernel (loss and every parameter gradient) against
    its plain version on training points [B, M, d] and their labels, with
    phase 3's tolerances and ReLU-kink recomputation (bf16: onf_apply's
    casts and the tie allowance); with `problems_per_program`, the
    multi-problem kernel (its casts "multi"). Returns the largest
    difference."""
    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_leaves

    bf16 = onf.compute_dtype == "bfloat16"
    if problems_per_program is None:
        name, casts = "field_grad", "apply" if bf16 else None
        loss, grads = kernels.field_grad(params, points, truth, onf)
        ref_loss, ref_grads = kernels.field_grad_plain(params, points, truth, onf)
    else:
        name, casts = "field_grad_multi", "multi" if bf16 else None
        loss, grads = kernels.field_grad_multi(params, points, truth, onf, problems_per_program)
        ref_loss, ref_grads = kernels.field_grad_multi_plain(params, points, truth, onf)
    return max(
        hold(f"{what} {name} loss", [loss], [ref_loss], [(1e-5, 1e-6)], bf16=bf16),
        hold(f"{what} {name} gradients", tree_leaves(grads), tree_leaves(ref_grads),
             [(2e-4, 2e-5)] * len(tree_leaves(grads)),
             kinks=(params, points, onf, field_grad_f64(truth, onf, casts)), bf16=bf16))


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


def grouped_solve(device, seed: int, batch: int, steps: int, aot_prefix: str | None = None):
    """Phase 8: the shared-field portfolio, init_state(group_size=8) and
    run_grouped_with_tracking in f32 on the car scene, `batch` problems (batch
    / 8 groups of 8 restarts of the car query); each f32 kernel launches once
    per step, and every group's replicas end bit-identical. With
    `aot_prefix` (phase 14b) the solve goes through
    `BatchPlanner(aot_prefix=...)`, its program captured before the timed
    window. Returns the metrics, the launches and the TrackingResult."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.parallel import BatchPlanner
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
    planner = None
    if aot_prefix is not None:
        planner = BatchPlanner(solver, aot_prefix=aot_prefix)
        planner.run_grouped(state, oracle, solver.config.reparametrize_trajectory_freq,
                            GROUP_SIZE, torch.Generator(device=device).manual_seed(seed + 1))
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    if planner is None:
        result = run_grouped_with_tracking(
            solver, state, oracle, GROUP_SIZE, g, max_iterations=steps,
            min_iterations=ANYTIME["min_iterations"], check_freq=ANYTIME["check_freq"],
            samples_per_segment=ANYTIME["samples_per_segment"])
    else:
        result = planner.solve_grouped_tracked(
            state, oracle, GROUP_SIZE, g, max_iterations=steps,
            min_iterations=ANYTIME["min_iterations"], check_freq=ANYTIME["check_freq"])
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
        **({"programs": planner.aot_events} if planner is not None else {}),
    }
    if feasible < 0.98:
        raise AssertionError(f"grouped path: feasible fraction {feasible} below the 0.98 floor")
    return metrics, launches, result


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
        "launches": {name: launches[name] for name in COUNTED},
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
    field-gradient kernel also on pretraining's 200 points). Then the same
    worlds once more with aot=True (captured programs): its solve and
    restart seconds, every problem's feasibility, iterations and path equal
    to the eager run's bit for bit, the same 0.98 floor, its launches held
    alike. Returns the
    metrics, both runs' launches, the scenarios and the eager SuiteResult
    (phase 12 plans the same worlds with GPMP2)."""
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

    pretraining = int(parameters.planner.init_collision_iteration)

    def check_suite_launches(what, probe, launches):
        """Each f32 kernel once per step of each solve, kernel 2 also once
        per pretraining iteration of each init; the Adam kernel twice per
        step and once per pretraining iteration."""
        steps_run = [info["steps_run"] for _, info in probe.parts("solve")]
        inits = probe.parts("init")
        for name, count in launches.items():
            if name == ADAM:
                want = ADAM_PER_STEP * sum(steps_run) + pretraining * len(inits)
            elif name in MAIN_PATH:
                want = sum(steps_run) + (pretraining * len(inits) if name == "field_grad" else 0)
            else:
                want = 0
            if count != want:
                raise AssertionError(f"{what}: kernel {name} launched {count} times, want "
                                     f"{want} (solves of {steps_run} steps, {len(inits)} inits)")
        return steps_run

    inits, solves = probe.parts("init"), probe.parts("solve")
    shortcuts = probe.parts("shortcut")
    steps_run = check_suite_launches("suite path", probe, launches)

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
        "launches": {name: launches[name] for name in COUNTED},
        "kernels_held": held,
    }
    if feasible < 0.98:
        raise AssertionError(f"suite path: feasible fraction {feasible} below the 0.98 floor")

    # the same worlds once more as replays of captured programs, as
    # run_benchmark_torch.py --aot runs them; its launches join the suite's
    with SuiteProbe(runner) as probe:
        kernels.reset_launches()
        t0 = time.perf_counter()
        captured = runner.run_grid_suite(scenarios, parameters, seed=seed, device=device,
                                         aot=True, **SUITE_SOLVE)
        torch.cuda.synchronize()
        captured_s = time.perf_counter() - t0
        captured_launches = dict(kernels.LAUNCHES)
    check_suite_launches("captured suite path", probe, captured_launches)
    restart = probe.parts("init")[1:] + probe.parts("solve")[1:] + probe.parts("shortcut")[1:]
    metrics["captured"] = {
        "run_grid_suite": captured_s, "init": probe.parts("init")[0][0],
        "solve": probe.parts("solve")[0][0], "restart": total(restart),
        "feasible_after_restarts": float(captured.feasible.mean()),
        "decisions_equal": bool(np.array_equal(captured.feasible, result.feasible)
                                and np.array_equal(captured.iterations, result.iterations)),
        "paths_bit_identical": bool(np.array_equal(captured.paths, result.paths)),
    }
    if metrics["captured"]["feasible_after_restarts"] < 0.98:
        raise AssertionError("captured suite path: feasible fraction "
                             f"{metrics['captured']['feasible_after_restarts']} below the 0.98 "
                             "floor")
    if not (metrics["captured"]["decisions_equal"] and metrics["captured"]["paths_bit_identical"]):
        raise AssertionError("captured suite path: feasibility, iterations or paths differ from "
                             "the eager suite's")
    for name in COUNTED:
        launches[name] += captured_launches[name]
    return metrics, launches, scenarios, result


def host_service(device, seed: int) -> tuple[dict, dict]:
    """Phase 11a: the dynamic demo's host loop (scripts/dynamic_replan_demo_torch.py)
    for HOST_TICKS ticks: WorldState's sensor points of the oscillating disc
    -> update_world, update_robot_pose -> replan_cycle within HOST_BUDGET s
    with a PathPostprocessor. Holds the executed poses clear of the true
    disc, finite paths, each raw planner path starting at the pose it was
    fed and ending at the goal, and each f32 kernel launched once per step
    run (the field-gradient kernel also once per pretraining iteration). The
    planner pretrains and steps through captured programs (NFOPPlanner's
    `with_aot("planner")`), listed under "programs": captured in the first
    run (phase 11a), taken from the process's store in a second (17c)."""
    import numpy as np

    from nfopp_tpu_torch import kernels

    demo = load_script("dynamic_replan_demo_torch")
    kernels.reset_launches()
    result, traces = demo.host_loop(HOST_TICKS, 0.1, 0.35, HOST_BUDGET, device, seed)
    launches = dict(kernels.LAUNCHES)
    steps = sum(traces["steps"])
    pretraining = int(demo.demo_parameters().planner.init_collision_iteration)
    check_launches(launches, MAIN_PATH, steps, "the host service", pretrain_launches(pretraining))
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
            "launches": {name: launches[name] for name in COUNTED},
            "programs": traces["planner"].aot_events}, launches


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
        for name in COUNTED:
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


def fleet_service(device, seed: int, aot: bool = False) -> tuple[dict, dict]:
    """Phase 11g: the online fleet node, FleetReplanningService, through
    scripts/replan_latency_torch.py's host fleet loop (FLEET_SERVICE: 256
    robots on the car scene, f32, one shared field per 128, 20-step chunks
    within a 0.1 s budget, a warm-up and 4 timed cycles; between cycles each
    robot follows its plan). Holds each f32 kernel once per step run, every
    group's replicas bit-identical, and a finite path for every active
    robot; then every kernel on one group's inputs. With `aot` (phase 14c)
    the script's --aot: the bursts replay captured chunk programs, the first
    captured in the warm-up cycle."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.utils.tree import tree_rows

    latency = load_script("replan_latency_torch")
    f = FLEET_SERVICE
    solver, oracle, env = latency.car_setup(device, aot=aot)
    args = SimpleNamespace(fleet=f["robots"], group_size=f["group_size"], timeout=f["budget"],
                           steps_per_chunk=f["steps_per_chunk"], cycles=f["cycles"], seed=seed)
    torch.cuda.synchronize()
    kernels.reset_launches()
    result, svc, paths = latency.host_fleet(args, solver, oracle, env)
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, MAIN_PATH, result["steps_run"], "the fleet service",
                   pretrain_launches(solver.config.init_collision_iteration))
    check_replicas((svc._states.field_params, svc._states.field_opt_state), f["group_size"])
    if sorted(paths) != list(range(f["robots"])):
        raise AssertionError(f"fleet service: paths for {len(paths)} of {f['robots']} robots")
    if not all(p.ndim == 2 and p.shape[1] == 3 and np.isfinite(p).all() for p in paths.values()):
        raise AssertionError("fleet service: a non-finite or malformed path")
    held = hold_path_kernels("fleet service", solver, tree_rows(svc._states, 0, f["group_size"]),
                             oracle, seed + 18)
    return {**result, "group_size": f["group_size"], "steps_per_chunk": f["steps_per_chunk"],
            "compute_dtype": "float32", "replicas_bit_identical": True,
            "kernels_held": held, **({"programs": solver.aot_events} if aot else {})}, launches


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
    finite final path with pinned endpoints; its feasibility is printed. The
    script's solver is a with_aot copy: its time includes the capture of its
    chunk program (listed under "programs")."""
    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels

    script = load_script("run_planner_torch")
    kernels.reset_launches()
    solver, state, oracle, g = script.build(seed, device)
    state, losses, elapsed = script.run(solver, state, oracle, g, DEMO_STEPS, log=lambda _: None)
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, MAIN_PATH, DEMO_STEPS, "the demo",
                   extra=pretrain_launches(solver.config.init_collision_iteration))
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
            "launches": {name: launches[name] for name in COUNTED},
            "programs": solver.aot_events}, launches


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


# phase 14, program capture: the step as one captured CUDA graph per chunk
# (solver.with_aot, utils/aot.py)
PROFILE = {"warmup": 20, "steps": 20}  # tools/profile_step.py's defaults, at BATCH
PARTS_STEPS = 20  # calls per part and mode of scripts/profile_step2_torch.py


def same_state(what: str, eager, captured) -> dict:
    """Hold a captured run's result (its final trajectories, field parameters
    and every other leaf) bit for bit against the eager run's; raises naming
    each leaf that differs and by how much."""
    import torch

    from nfopp_tpu_torch.utils.tree import tree_named_leaves

    pairs = list(zip(tree_named_leaves(eager), tree_named_leaves(captured)))
    differ = {name: float((a.double() - b.double()).abs().max())
              for (name, a), (_, b) in pairs if not torch.equal(a, b)}
    if differ:
        raise AssertionError(f"{what}: the captured run differs from the eager run: {differ}")
    return {"leaves": len(pairs), "bit_identical": True}


def profile_orders(seed: int) -> dict:
    """Phase 14d: tools/profile_step.py eagerly and with --aot, in f32 and
    bf16, at BATCH: host ms and device busy ms per step, kernels, launch
    calls and graph replays per step."""
    import tempfile
    from types import SimpleNamespace

    from nfopp_tpu_torch.tools import profile_step

    keys = ("host_ms_per_step", "device_busy_ms_per_step", "kernels_per_step",
            "launch_calls_per_step", "graph_replays_per_step", "port_kernel_launches_per_step")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for bf16, aot in itertools.product((False, True), (False, True)):
            result = profile_step.profile(SimpleNamespace(
                batch=BATCH, seed=seed, bf16=bf16, order="default", aot=aot,
                trace=pathlib.Path(tmp) / "trace.json", **PROFILE))
            out[f"{'bf16' if bf16 else 'f32'}_{'captured' if aot else 'eager'}"] = {
                k: result[k] for k in keys}
    return out


# phase 15, the problem mesh: each rank a process of this script's --mesh-worker mode
MESH_STEPS, MESH_GROUPED_STEPS = STEPS, 100
MESH_TIMEOUT = 300  # seconds for a rank's process, and 120 for each collective
MESH_LOSS_RTOL = 1e-4  # tests/test_torch_multihost.py's 2 ranks against 1 process


def state_digest(state) -> dict:
    """sha256 of every leaf's bytes, by leaf name: two states are bit-identical
    iff their digests are."""
    import hashlib

    from nfopp_tpu_torch.utils.tree import tree_named_leaves

    return {name: hashlib.sha256(leaf.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
            for name, leaf in tree_named_leaves(state)}


def mesh_worker(out: str, seed: int, script_args: list) -> int:
    """One rank of phase 15: scripts/run_multihost_torch.py's `run` with
    `script_args`, its kernels' launches counted from 0 around the solve,
    then kernels 1-3b held on this rank's own next-step inputs, its state's
    digest and the digests of its blocks of BATCH // 2 global rows; writes
    {result, launches, kernels_held, digest, blocks} to `out`."""
    import torch.distributed as dist

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.kernels import build

    build.load_library()
    script = load_script("run_multihost_torch")
    args = script.parse_args(script_args)
    kernels.reset_launches()
    result, context = script.run(args)
    launches = dict(kernels.LAUNCHES)
    mesh = context["mesh"]
    held = hold_path_kernels(f"phase 15 rank {mesh.rank} of {mesh.size}",
                             context["planner"].solver, context["states"], context["oracle"],
                             seed + 1)
    from nfopp_tpu_torch.utils.tree import tree_rows

    states, block = context["states"], BATCH // 2
    first = mesh.rank * states.start.shape[0]
    blocks = {f"{lo}:{lo + block}": state_digest(tree_rows(states, lo - first, lo - first + block))
              for lo in range(first, first + states.start.shape[0], block)}
    pathlib.Path(out).write_text(json.dumps({
        "result": result, "launches": launches, "kernels_held": held,
        "digest": state_digest(states), "blocks": blocks}))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def mesh_ranks(tmp: pathlib.Path, name: str, seed: int, ranks: list) -> list:
    """Run one process per entry of `ranks` (each the script's arguments of
    one rank), all at once; returns each rank's worker JSON. Raises with the
    log's tail if a rank fails or outlives MESH_TIMEOUT."""
    import subprocess

    procs, outs, logs = [], [], []
    for i, script_args in enumerate(ranks):
        outs.append(tmp / f"{name}-{i}.json")
        logs.append(tmp / f"{name}-{i}.log")
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed), "--mesh-worker",
             str(outs[-1]), "--", *script_args, "--seed", str(seed), "--timeout", "120"],
            cwd=str(ROOT), stdout=logs[-1].open("w"), stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=MESH_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        text = logs[i].read_text()
        for line in text.splitlines():
            if "backend" in line or "kernels held" in line:
                log(f"  {name} rank {i}: {line.strip()}")
        if p.returncode != 0:
            raise AssertionError(f"phase 15 {name}: rank {i} failed (rc {p.returncode}):\n"
                                 + "\n".join(text.splitlines()[-30:]))
    return [json.loads(o.read_text()) for o in outs]


def mesh_pair(tmp, name: str, seed: int, backend: str, extra: tuple, per_rank: int,
              steps: int, devices: tuple) -> list:
    """Two ranks of run_multihost_torch over `backend`, one per device."""
    return mesh_ranks(tmp, name, seed, [
        ["--num-processes", "2", "--process-id", str(i), "--init-file",
         str(tmp / f"rendezvous-{name}"), "--backend", backend, "--device", devices[i],
         "--batch-per-host", str(per_rank), "--steps", str(steps), *extra]
        for i in range(2)])


def mesh_phase(seed: int, main_digest: dict, eager_f32: float, card: str) -> tuple[dict, dict]:
    """Phase 15 (see the module): returns its metrics and the launches of
    the ranks' solves (15a, 15b and 15e), summed."""
    import tempfile

    import torch

    launches = {name: 0 for name in COUNTED}
    metrics = {}
    with tempfile.TemporaryDirectory(prefix="mesh-", dir=ROOT) as tmp:
        tmp = pathlib.Path(tmp)
        # (a) world of 1 over nccl, phase 4's cell
        t0 = time.perf_counter()
        (one,) = mesh_ranks(tmp, "15a", seed, [[
            "--num-processes", "1", "--process-id", "0", "--init-file", str(tmp / "rdv-15a"),
            "--backend", "nccl", "--batch-per-host", str(BATCH), "--steps", str(MESH_STEPS)]])
        if one["digest"] != main_digest:
            differ = sorted(k for k in main_digest if one["digest"].get(k) != main_digest[k])
            raise AssertionError(f"phase 15a: the mesh run's final state differs from phase 4's "
                                 f"in {differ}")
        check_launches(one["launches"], MAIN_PATH, MESH_STEPS, "phase 15a")
        r = one["result"]
        metrics["15a"] = {
            "world": 1, "backend": r["backend"], "batch": r["total_batch"],
            "s_per_1000_steps": r["s_per_1000_steps"],
            "phase4_eager_s_per_1000_steps": eager_f32 / STEPS * 1000,
            "feasible_fraction": r["feasible_fraction"], "state": "bit-identical to phase 4",
            "collectives": r["collectives"], "collective_ms": r["collective_ms"],
            "kernels_held": one["kernels_held"]["max_abs_err"],
            "process_s": time.perf_counter() - t0}
        for name in COUNTED:
            launches[name] += one["launches"][name]

        # (b) two ranks on the one card over gloo, against (a)
        t0 = time.perf_counter()
        pair = mesh_pair(tmp, "15b", seed, "gloo", (), BATCH // 2, MESH_STEPS,
                         ("cuda:0", "cuda:0"))
        grouped = mesh_pair(tmp, "15b-grouped", seed, "gloo", ("--group-size", str(BATCH)),
                            BATCH // 2, MESH_GROUPED_STEPS, ("cuda:0", "cuda:0"))
        metrics["15b"] = mesh_pair_metrics("15b", pair, grouped, one)
        metrics["15b"]["process_s"] = time.perf_counter() - t0
        for rank in pair + grouped:
            check_launches(rank["launches"], MAIN_PATH, rank["result"]["steps"], "phase 15b")
            for name in COUNTED:
                launches[name] += rank["launches"][name]

        # (c) the dry run of the multi-chip entry, both ranks on cuda:0
        from nfopp_tpu_torch import graft_entry

        t0 = time.perf_counter()
        verdict = graft_entry.dryrun_multichip(2)
        metrics["15c"] = {"stages": verdict, "seconds": time.perf_counter() - t0}

        # (d) nccl over two cards, where there are two
        if torch.cuda.device_count() >= 2:
            t0 = time.perf_counter()
            nccl = mesh_pair(tmp, "15d", seed, "nccl", (), BATCH // 2, MESH_STEPS,
                             ("cuda:0", "cuda:1"))
            nccl_grouped = mesh_pair(tmp, "15d-grouped", seed, "nccl",
                                     ("--group-size", str(BATCH)), BATCH // 2,
                                     MESH_GROUPED_STEPS, ("cuda:0", "cuda:1"))
            metrics["15d"] = mesh_pair_metrics("15d", nccl, nccl_grouped, one)
            metrics["15d"]["process_s"] = time.perf_counter() - t0
        else:
            print(json.dumps({"nccl_world2": f"not run: {torch.cuda.device_count()} card"}),
                  flush=True)
            metrics["15d"] = f"not run: {torch.cuda.device_count()} card"

        # (e) every shared-field layout and step order, eager and captured
        t0 = time.perf_counter()
        metrics["15e"], case_launches = mesh_cases(
            tmp, seed, metrics["15b"]["grouped"]["s_per_1000_steps_per_rank"])
        metrics["15e"]["process_s"] = time.perf_counter() - t0
        for name in COUNTED:
            launches[name] += case_launches[name]
    return metrics, launches


def mesh_pair_metrics(name: str, pair: list, grouped: list, one: dict) -> dict:
    """Hold a 2-rank run (and its grouped run) against the 1-process run
    `one` of the same 256 problems, and read its numbers."""
    r0, r1 = (rank["result"] for rank in pair)
    single = one["result"]
    if not r0["feasible"] == r1["feasible"] == single["feasible"]:
        raise AssertionError(f"phase {name}: per-problem feasibility differs from 1 process")
    if r0["feasible_fraction"] < 0.98:
        raise AssertionError(f"phase {name}: feasible fraction {r0['feasible_fraction']} "
                             "below the 0.98 floor")
    if abs(r0["mean_loss"] - single["mean_loss"]) > MESH_LOSS_RTOL * abs(single["mean_loss"]):
        raise AssertionError(f"phase {name}: mean loss {r0['mean_loss']} against "
                             f"{single['mean_loss']} of 1 process")
    g = [rank["result"] for rank in grouped]
    if not all(r["replicas_equal"] for r in g):
        raise AssertionError(f"phase {name}: a field spanning both ranks has unequal replicas")
    return {
        "ranks": 2, "backend": r0["backend"], "devices": [r0["device"], r1["device"]],
        "batch_per_rank": r0["total_batch"] // 2,
        "s_per_1000_steps_per_rank": [r0["s_per_1000_steps"], r1["s_per_1000_steps"]],
        "one_process_s_per_1000_steps": single["s_per_1000_steps"],
        "feasible_fraction": r0["feasible_fraction"], "decisions_equal": True,
        "mean_loss": r0["mean_loss"], "one_process_mean_loss": single["mean_loss"],
        # printed, not held: the 2-rank rows' final states against the 1-process run's
        "state_bit_identical_to_one_process": all(
            digest == one["blocks"].get(rows) for rank in pair
            for rows, digest in rank["blocks"].items()),
        "collectives_per_step": r0["collectives_per_step"],
        "collective_ms": [r0["collective_ms"], r1["collective_ms"]],
        "grouped": {"steps": g[0]["steps"], "group_size": g[0]["group_size"],
                    "replicas_equal": True,
                    "s_per_1000_steps_per_rank": [r["s_per_1000_steps"] for r in g],
                    "collectives_per_step": g[0]["collectives_per_step"],
                    "collective_ms": [r["collective_ms"] for r in g],
                    "mean_loss": g[0]["mean_loss"], "feasible_fraction": g[0]["feasible_fraction"]},
        "kernels_held": {f"rank{i}": rank["kernels_held"]["max_abs_err"]
                         for i, rank in enumerate(pair + grouped)},
    }


# phase 15e: every shared-field layout and step order on two ranks sharing
# cuda:0 over gloo, each rank a process of this script's --mesh-cases mode
MESH_CASE_STEPS = 100
MESH_STRADDLE = (240, 16)  # 15 queries x 16 restarts: group 7, rows 112-127, straddles
MESH_ORDERS = (("jacobi", 1), ("merged", 1), ("merged", BATCH))  # (order, group size)
MESH_FLEET = {"robots": 240, "subgroups": 3, "group_size": 80, "steps": 20, "goals": 2,
              "cycles": 5}
MESH_DEVICE = "cuda:0"  # both ranks' card, and the 1-process runs'


def mesh_case(mesh, seed: int, name: str, solver, batch: int, group_size: int) -> dict:
    """One 15e case on this rank: MESH_CASE_STEPS steps of `run_grouped` (of
    `run` for group_size 1) from BatchPlanner's init of `batch` copies of the
    car query, eager and then captured (its program captured from another
    generator first); returns its numbers, the eager run's final state and
    aux, and whether the captured run's equal them bit for bit."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.parallel import BatchPlanner, gather_batch, mean_over_problems
    from nfopp_tpu_torch.parallel.mesh import COLLECTIVES, barrier, reset_collectives
    from nfopp_tpu_torch.solver import evaluate_path
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.utils.tree import tree_leaves
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, starts, goals, bounds = car_world(batch, mesh.device)
    steps, freq = MESH_CASE_STEPS, solver.config.reparametrize_trajectory_freq
    runs = {}
    for mode in ("eager", "captured"):
        planner = BatchPlanner(solver, mesh, aot_prefix=None if mode == "eager" else f"15e-{name}")
        generator = torch.Generator(device=mesh.device).manual_seed(seed)
        if group_size == 1:
            state = planner.init_batch(generator, starts, goals, bounds, oracle)
            run = partial(planner.run, oracle_params=oracle, num_steps=steps)
        else:
            state = planner.init_batch_grouped(generator, starts, goals, bounds, oracle,
                                               group_size)
            run = partial(planner.run_grouped, oracle_params=oracle, num_steps=steps,
                          group_size=group_size)
        if mode == "captured":
            run(state, noise=torch.Generator(device=mesh.device).manual_seed(seed + 99))
        torch.cuda.synchronize()
        barrier(mesh)
        reset_collectives()
        kernels.reset_launches()
        t0 = time.perf_counter()
        final, aux = run(state, noise=generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        collectives, launches = dict(COLLECTIVES), dict(kernels.LAUNCHES)
        runs[mode] = {"final": final, "aux": aux, "numbers": {
            "s_per_1000_steps": seconds / steps * 1000,
            "collectives_per_step": collectives["count"] / steps,
            "collective_host_ms_per_step": 1e3 * collectives["seconds"] / steps,
            "launches": launches}}
        if mode == "captured":
            chunk = [e for e in planner.aot_events if e["program"].startswith("chunk")]
            runs[mode]["numbers"]["replays_per_step"] = chunk[0].get("segments", 1) / freq
    eager = runs["eager"]
    digest = state_digest((eager["final"], eager["aux"]))
    collides, _ = evaluate_path(rectangle_collision, oracle,
                                gather_batch(solver.full_trajectory(eager["final"]), mesh))
    replicas = None
    if group_size > 1:
        field = gather_batch((eager["final"].field_params, eager["final"].field_opt_state), mesh)
        replicas = all(bool(torch.equal(g, g[:, :1].expand_as(g))) for leaf in tree_leaves(field)
                       for g in [leaf.reshape((-1, group_size) + tuple(leaf.shape[1:]))])
    return {
        "name": name, "batch": batch, "group_size": group_size, "steps": steps,
        "eager": eager["numbers"], "captured": runs["captured"]["numbers"],
        "captured_equals_eager": digest == state_digest((runs["captured"]["final"],
                                                         runs["captured"]["aux"])),
        "replicas_equal": replicas,
        "feasible": [bool(f) for f in (~collides).cpu().numpy()],
        "mean_loss": float(mean_over_problems(eager["aux"].trajectory_loss[:, -1], mesh)),
        "rows_digest": state_digest(eager["final"]),
    }


def least_clearance(paths, samples: int = 5) -> float:
    """The least distance from the car scene's obstacle points to any of
    `samples` points per segment of `paths` [B, M, 3] (the footprint's
    center)."""
    import numpy as np
    import torch

    from nfopp_tpu_torch.worlds import car_environment

    obstacles = torch.tensor(np.asarray(car_environment().obstacle_points, np.float32),
                             device=paths.device)[:, :2]
    t = torch.arange(samples, device=paths.device, dtype=paths.dtype) / samples
    xy = paths[..., :2]
    dense = (xy[:, :-1, None] + t[:, None] * (xy[:, 1:, None] - xy[:, :-1, None])).reshape(-1, 2)
    return float(torch.cdist(dense, obstacles).min())


def mesh_fleet(mesh, seed: int) -> dict:
    """15e (iv): fleet_replan_session of MESH_FLEET on this rank, eager and
    captured (its burst programs captured by a one-cycle session first)."""
    import numpy as np
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.parallel import BatchPlanner, gather_batch
    from nfopp_tpu_torch.parallel.mesh import COLLECTIVES, barrier, reset_collectives
    from nfopp_tpu_torch.service import fleet_replan_session, subfleet_generators
    from nfopp_tpu_torch.solver import ConstrainedSolver, evaluate_path, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import car_environment, rectangle_collision

    f = MESH_FLEET
    latency = load_script("replan_latency_torch")
    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=mesh.device)
    oracle, starts, goals, bounds = car_world(f["robots"], mesh.device)
    rows = latency.goal_rows(car_environment(), f["robots"], f["goals"])
    out = {}
    for mode in ("eager", "captured"):
        planner = BatchPlanner(solver, mesh, aot_prefix=None if mode == "eager" else "15e-fleet")

        def session(s, goal_rows, cycles):
            states = planner.init_batch_grouped(
                torch.Generator(device=mesh.device).manual_seed(s), starts, goals, bounds,
                oracle, f["group_size"])
            torch.cuda.synchronize()
            barrier(mesh)
            reset_collectives()
            kernels.reset_launches()
            t0 = time.perf_counter()
            final, aux = fleet_replan_session(
                planner.solver, states, oracle, goal_rows, cycles, f["steps"], f["group_size"],
                subfleet_generators(s + 1, f["subgroups"], mesh.device),
                subgroups=f["subgroups"])
            torch.cuda.synchronize()
            return time.perf_counter() - t0, final, aux

        if mode == "captured":
            session(seed + 50, rows[:1], 1)
        seconds, final, aux = session(seed, rows, f["cycles"])
        cycles = f["goals"] * f["cycles"]
        paths = gather_batch(solver.full_trajectory(final), mesh)
        collides, _ = evaluate_path(solver.oracle_fn, oracle, paths)
        out[mode] = {"cycle_ms": seconds / cycles * 1e3,
                     "collectives_per_cycle": COLLECTIVES["count"] / cycles,
                     "launches": dict(kernels.LAUNCHES),
                     "digest": state_digest((gather_batch(final, mesh), aux)),
                     "reached_feasible": float((~collides).float().mean()),
                     "least_clearance": least_clearance(paths),
                     "goals_equal": bool(np.array_equal(
                         gather_batch(final.goal, mesh).cpu().numpy(), rows[-1]))}
    out["captured_equals_eager"] = out["eager"].pop("digest") == out["captured"].pop("digest")
    return {**f, **out}


def mesh_cases_worker(out: str, seed: int, rank: int, init_file: str) -> int:
    """One rank of phase 15e: cases (i)-(iv) over gloo on cuda:0; writes
    their numbers to `out`."""
    import torch.distributed as dist

    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.kernels import build
    from nfopp_tpu_torch.parallel import initialize_distributed, problem_mesh
    from nfopp_tpu_torch.parallel.mesh import barrier
    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.worlds import rectangle_collision

    build.load_library()
    initialize_distributed(None, 2, rank, "gloo",
                           init_method=pathlib.Path(init_file).resolve().as_uri(), timeout=120)
    mesh = problem_mesh(device=MESH_DEVICE)
    barrier(mesh)  # the first collective sets up gloo's pair: not timed
    config = run_planner_config()
    solver = ConstrainedSolver(config, rectangle_collision, device=mesh.device)
    cases = [mesh_case(mesh, seed, "crossing", solver, BATCH, BATCH),
             mesh_case(mesh, seed, "straddle", solver, *MESH_STRADDLE)]
    for order, group_size in MESH_ORDERS:
        solver = ExperimentalConstrainedSolver(config, rectangle_collision,
                                               device=mesh.device, **{f"{order}_step": True})
        cases.append(mesh_case(mesh, seed, f"{order}-g{group_size}", solver, BATCH, group_size))
    fleet = mesh_fleet(mesh, seed)
    pathlib.Path(out).write_text(json.dumps({"rank": mesh.rank, "cases": cases, "fleet": fleet}))
    dist.destroy_process_group()
    return 0


def one_process_case(device, seed: int, solver, batch: int, group_size: int,
                     rank: int | None = None, nudge: bool = False):
    """A 15e case's eager run in this process alone: its final state and aux.
    `rank` runs only that rank's rows of the two, laid out as rank `rank` of
    2 without a process group (the mesh's draws and batch size; for groups
    inside the ranks, which make no collective); `nudge` moves every
    waypoint of the init one float up before the run."""
    import torch

    from nfopp_tpu_torch.parallel import BatchPlanner
    from nfopp_tpu_torch.parallel.mesh import ProblemMesh
    from nfopp_tpu_torch.tools.scene import car_world

    oracle, starts, goals, bounds = car_world(batch, device)
    mesh = None if rank is None else ProblemMesh(None, rank, 2, device)
    planner = BatchPlanner(solver if mesh is None else solver.with_mesh(mesh), mesh)
    generator = torch.Generator(device=device).manual_seed(seed)
    if group_size == 1:
        state = planner.init_batch(generator, starts, goals, bounds, oracle)
        if nudge:
            state = state._replace(trajectory=torch.nextafter(
                state.trajectory, torch.full_like(state.trajectory, torch.inf)))
        return planner.run(state, oracle, MESH_CASE_STEPS, generator)
    state = planner.init_batch_grouped(generator, starts, goals, bounds, oracle, group_size)
    return planner.run_grouped(state, oracle, MESH_CASE_STEPS, group_size, generator)


def merged_step_rows(device, seed: int, config) -> dict:
    """The merged order's first step of BATCH problems in this process
    against the same step of each half of them alone, laid out as rank r of
    2 without a process group (the mesh's draws, no collective): the field
    gradients and both losses before any Adam update (which can turn a
    rounding difference in a near-zero gradient into one of lr) within
    tests/test_field_grad_fused.py's tolerances (rtol 2e-4, atol 2e-5); the
    largest difference, whether the bits are equal, and how many problems
    resampled another replay buffer."""
    import numpy as np
    import torch

    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.experimental.merged_step import merged_partial_step
    from nfopp_tpu_torch.parallel import BatchPlanner
    from nfopp_tpu_torch.parallel.mesh import ProblemMesh
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.utils.tree import tree_leaves, tree_rows
    from nfopp_tpu_torch.worlds import rectangle_collision

    solver = ExperimentalConstrainedSolver(config, rectangle_collision, device=device,
                                           merged_step=True)
    oracle, starts, goals, bounds = car_world(BATCH, device)
    state = BatchPlanner(solver).init_batch(torch.Generator(device=device).manual_seed(seed),
                                            starts, goals, bounds, oracle)

    def step(s, on):
        noise = on._noise(torch.Generator(device=device).manual_seed(seed + 1),
                          s.start.shape[0])
        new, grads, field_loss, traj_loss = merged_partial_step(on, s, oracle, noise)
        return (grads, field_loss, traj_loss), new.buffer_points

    (whole, buffers), half = step(state, solver), BATCH // 2
    worst, bits, resampled = 0.0, True, 0
    for r in range(2):
        rows = slice(r * half, (r + 1) * half)
        got, got_buffers = step(tree_rows(state, rows.start, rows.stop),
                                solver.with_mesh(ProblemMesh(None, r, 2, device)))
        resampled += int((got_buffers != buffers[rows]).flatten(1).any(1).sum())
        for a, b in zip(tree_leaves(got), tree_leaves(tree_rows(whole, rows.start, rows.stop))):
            a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
            bits &= bool(np.array_equal(a, b))
            worst = max(worst, float(np.abs(a - b).max()))
            if not np.allclose(a, b, rtol=2e-4, atol=2e-5):
                raise AssertionError(f"phase 15e merged: the first step of rows {rows.start}:"
                                     f"{rows.stop} alone differs from the whole batch's "
                                     f"({float(np.abs(a - b).max())})")
    return {"max_abs_diff": worst, "bit_identical": bits,
            "problems_with_another_buffer": resampled}


def mesh_cases(tmp: pathlib.Path, seed: int, grouped_eager: list) -> tuple[dict, dict]:
    """Phase 15e (see the module): two --mesh-cases ranks, then the holds
    against eager runs in this process. `grouped_eager`: 15b-grouped's s
    per 1000 steps per rank. Returns the metrics and the launches summed."""
    import subprocess

    outs = [tmp / f"15e-{r}.json" for r in range(2)]
    logs = [tmp / f"15e-{r}.log" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed), "--mesh-cases",
         str(outs[r]), "--rank", str(r), "--init-file", str(tmp / "rdv-15e")],
        cwd=str(ROOT), stdout=logs[r].open("w"), stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=MESH_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"phase 15e: rank {r} failed (rc {p.returncode}):\n"
                                 + "\n".join(logs[r].read_text().splitlines()[-30:]))
    return hold_mesh_cases([json.loads(o.read_text()) for o in outs], seed, grouped_eager)


def hold_mesh_cases(ranks: list, seed: int, grouped_eager: list) -> tuple[dict, dict]:
    """Phase 15e's holds on the ranks' numbers `ranks`, and its metrics and
    launches."""
    import numpy as np
    import torch

    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.solver import ConstrainedSolver, evaluate_path, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.utils.tree import tree_rows
    from nfopp_tpu_torch.worlds import rectangle_collision

    device = torch.device(MESH_DEVICE)
    config = run_planner_config()
    launches = {name: 0 for name in COUNTED}
    metrics = {}
    for i, case in enumerate(ranks[0]["cases"]):
        pair = [rank["cases"][i] for rank in ranks]
        name, what = case["name"], f"phase 15e {case['name']}"
        for r, c in enumerate(pair):
            if not c["captured_equals_eager"]:
                raise AssertionError(f"{what}: rank {r}'s captured run differs from its eager run")
            if c["replicas_equal"] is False:
                raise AssertionError(f"{what}: a shared field's replicas differ")
            if name in ("crossing", "straddle"):
                for mode in ("eager", "captured"):
                    check_launches(c[mode]["launches"], MAIN_PATH, c["steps"],
                                   f"{what} rank {r} {mode}")
            if c["eager"]["collectives_per_step"] != c["captured"]["collectives_per_step"]:
                raise AssertionError(f"{what}: rank {r} makes {c['captured']} collectives per "
                                     f"step captured, {c['eager']} eager")
            for mode in ("eager", "captured"):
                for k in COUNTED:
                    launches[k] += c[mode]["launches"][k]
        row = {"batch": case["batch"], "group_size": case["group_size"], "steps": case["steps"],
               "captured_equals_eager": True, "replicas_equal": case["replicas_equal"],
               **{f"{mode}_{key}": [c[mode][key] for c in pair]
                  for mode in ("eager", "captured")
                  for key in ("s_per_1000_steps", "collectives_per_step",
                              "collective_host_ms_per_step")},
               "replays_per_step": [c["captured"]["replays_per_step"] for c in pair],
               "feasible_fraction": float(np.mean(case["feasible"])),
               "mean_loss": case["mean_loss"]}
        if name == "crossing":
            row["grouped_15b_eager_s_per_1000_steps"] = grouped_eager
        def against_one_process(solver):
            """The case's eager run in this process alone: every problem's
            feasibility equal, and (but for the merged order, below) the
            mean loss within MESH_LOSS_RTOL."""
            final, aux = one_process_case(device, seed, solver, case["batch"],
                                          case["group_size"])
            oracle = car_world(case["batch"], device)[0]
            collides, _ = evaluate_path(rectangle_collision, oracle, torch.cat(
                [final.start[:, None], final.trajectory, final.goal[:, None]], dim=1))
            one_loss = float(aux.trajectory_loss[:, -1].mean())
            if case["feasible"] != [bool(f) for f in (~collides).cpu().numpy()]:
                raise AssertionError(f"{what}: per-problem feasibility differs from 1 process")
            if (abs(case["mean_loss"] - one_loss) > MESH_LOSS_RTOL * abs(one_loss)
                    and not name.startswith("merged")):
                raise AssertionError(f"{what}: mean loss {case['mean_loss']} against "
                                     f"{one_loss} of 1 process")
            row.update(decisions_equal=True, one_process_mean_loss=one_loss)
            return final, aux

        if name == "straddle":
            against_one_process(ConstrainedSolver(config, rectangle_collision, device=device))
        if name.endswith("-g1"):
            order = name.split("-")[0]
            solver = ExperimentalConstrainedSolver(config, rectangle_collision, device=device,
                                                   **{f"{order}_step": True})
            # the mesh's witness: each rank's rows run alone in this process
            # at the rank's batch size, with the rank's draws; no group
            # crosses the ranks, so the rows must be the same bits
            for r, c in enumerate(pair):
                if c["rows_digest"] != state_digest(one_process_case(
                        device, seed, solver, case["batch"], 1, rank=r)[0]):
                    raise AssertionError(f"{what}: rank {r}'s rows differ from the same rows "
                                         "run alone in one process")
            row["rows_bit_identical_to_each_rank_alone"] = True
            final, aux = against_one_process(solver)
            half = case["batch"] // 2
            differ = [r for r, c in enumerate(pair)
                      if c["rows_digest"] != state_digest(tree_rows(final, r * half,
                                                                   (r + 1) * half))]
            row["rows_bit_identical_to_one_process"] = not differ
            # the Jacobi order's field passes are the port's kernels, one CTA
            # per problem, so a rank's rows are the whole batch's; the merged
            # order's are PyTorch reductions and cuBLAS batched products,
            # whose summation order follows the batch size (128 rows against
            # 256). Its rows are held against each rank alone (above) and
            # its first step against the whole batch's; the whole batch run
            # from an init one float away shows how far such runs part
            if differ and order == "jacobi":
                raise AssertionError(f"{what}: rank(s) {differ}'s rows differ from the "
                                     "1-process run's")
            if order == "merged":
                row["first_step_against_one_process"] = merged_step_rows(device, seed, config)
                losses = aux.trajectory_loss[:, -1]
                nudged = one_process_case(device, seed, solver, case["batch"], 1,
                                          nudge=True)[1].trajectory_loss[:, -1]
                row["one_process_init_one_float_up"] = {
                    "mean_loss": float(nudged.mean()),
                    "max_abs_loss_diff": float((nudged - losses).abs().max())}
        metrics[name] = row
        log(f"phase 15e {name}: {json.dumps(row)}")
    fleet = [rank["fleet"] for rank in ranks]
    for r, f in enumerate(fleet):
        if not (f["captured_equals_eager"] and f["eager"]["goals_equal"]):
            raise AssertionError(f"phase 15e fleet: rank {r}'s captured session differs from "
                                 "its eager one, or the goals are not the last goal row")
        local, sub = f["robots"] // 2, f["robots"] // f["subgroups"]
        held = sum(max(s * sub, r * local) < min((s + 1) * sub, (r + 1) * local)
                   for s in range(f["subgroups"]))  # the sub-fleets rank r runs bursts of
        for mode in ("eager", "captured"):
            check_launches(f[mode]["launches"], MAIN_PATH,
                           f["goals"] * f["cycles"] * held * f["steps"],
                           f"phase 15e fleet rank {r}")
            for k in COUNTED:
                launches[k] += f[mode]["launches"][k]
    metrics["fleet"] = {**{k: fleet[0][k] for k in MESH_FLEET}, "captured_equals_eager": True,
                        **{f"{mode}_{key}": [f[mode][key] for f in fleet]
                           for mode in ("eager", "captured")
                           for key in ("cycle_ms", "collectives_per_cycle")},
                        "reached_feasible": fleet[0]["eager"]["reached_feasible"],
                        "least_clearance": fleet[0]["eager"]["least_clearance"]}
    log(f"phase 15e fleet: {json.dumps(metrics['fleet'])}")
    return metrics, launches


# phase 16, the bench on the card: bench_torch.py in six modes as its users run
# it (B=256 x 1000 steps), captured against eager for run_batch and the
# experimental orders, and scripts/profile_step_torch.py --aot.
# BENCH_MODES: (line, bench_torch.py's flags, the mode's kernels, captured).
BENCH_MODES = (("bench_default", ("--feas-sweep", "3", "--anytime"), MAIN_PATH_BF16, True),
               ("bench_f32", ("--f32",), MAIN_PATH, True),
               ("bench_f32_eager", ("--f32", "--eager"), MAIN_PATH, False),
               ("bench_multi8", ("--multi", "8"), BATCH_PATH, True),
               ("bench_jacobi", ("--jacobi",), MAIN_PATH_BF16, True),
               ("bench_merged", ("--merged",), (), True))
BENCH_TIMEOUT = 600  # seconds for one bench process
BENCH_FLOOR = 0.98  # the feasible fraction every mode must reach, as phases 4-6
# CAPTURE_CELLS: (name, order, bf16, group size): captured against eager,
# B=256 x CAPTURE_STEPS from one init and one generator seed
CAPTURE_STEPS = 100
CAPTURE_CELLS = (("batch_p8_bf16", "batch", True, 1), ("jacobi_f32", "jacobi", False, 1),
                 ("merged_f32", "merged", False, 1), ("merged_bf16", "merged", True, 1),
                 ("grouped_merged_f32_g8", "merged", False, GROUP_SIZE))
ABLATION_STEPS = 50  # scripts/profile_step_torch.py's default


def bench_modes(seed: int, card: str) -> tuple[list, dict]:
    """Phase 16a: bench_torch.py as a subprocess in each of BENCH_MODES, one
    after another. Each prints one JSON line, at least 0.98 feasible, the
    card's line under `device`, each of the mode's kernels launched once per
    timed step and no other kernel, captured (its one-step p50 too) unless
    --eager; the default mode's seed sweep and anytime solve are there, its
    anytime file written.
    Returns the (line, JSON) pairs and each kernel's launches in the timed
    loops (launches per step x steps)."""
    import subprocess
    import tempfile

    lines, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        anytime_out = pathlib.Path(tmp) / "anytime.json"
        for line, flags, path, captured in BENCH_MODES:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "bench_torch.py"), *flags, "--seed", str(seed),
                 "--anytime-out", str(anytime_out)],
                cwd=str(ROOT), capture_output=True, text=True, timeout=BENCH_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(f"phase 16a {line}: bench_torch.py failed (rc "
                                     f"{proc.returncode}):\n{proc.stderr[-3000:]}")
            out = proc.stdout.strip().splitlines()
            if len(out) != 1:
                raise AssertionError(f"phase 16a {line}: {len(out)} lines on stdout, not one")
            result = json.loads(out[0])
            for text in proc.stderr.splitlines():
                log(f"  {line}: {text}")
            what = f"phase 16a {line}"
            if result["feasible_fraction"] < BENCH_FLOOR:
                raise AssertionError(f"{what}: feasible fraction {result['feasible_fraction']} "
                                     f"below the {BENCH_FLOOR} floor")
            path_of_p50 = "captured" if captured else "eager"  # the one-step program
            if (result["device"] != card or result["captured"] != captured
                    or result["p50_step_path"] != path_of_p50):
                raise AssertionError(f"{what}: device {result['device']!r}, captured "
                                     f"{result['captured']}, p50 {result['p50_step_path']}")
            for name, per_step in result["launches_per_step"].items():
                if per_step != (ADAM_PER_STEP if name == ADAM else 1.0 if name in path else 0.0):
                    raise AssertionError(f"{what}: kernel {name} launched {per_step} times per "
                                         f"step (path {path})")
                launches[name] = launches.get(name, 0) + round(per_step * STEPS)
            if "--anytime" in flags:
                written = json.loads(anytime_out.read_text())
                if result["anytime"]["iterations_max"] > STEPS or written["device"] != card:
                    raise AssertionError(f"{what}: anytime {result['anytime']}")
                if len(result["feas_sweep"]["feasible_fractions"]) != 4:
                    raise AssertionError(f"{what}: feas sweep {result['feas_sweep']}")
            result["process_s"] = time.perf_counter() - t0
            lines.append((line, result))
    return lines, launches


def capture_agreement(device, seed: int) -> tuple[dict, dict]:
    """Phase 16b: each of CAPTURE_CELLS eagerly and through a `with_aot` copy,
    B=256 x CAPTURE_STEPS on the car scene from one init and a generator of
    one seed each: every leaf of the final state bit-identical, twice (the
    first captured run captures, the second replays the stored program), the
    same kernels launched (BATCH_PATH for run_batch P=8, MAIN_PATH for Jacobi
    f32, none for merged), the eager run timed beside the captured one (its
    capture included, and after it); then kernels 4 and 5 (and the collision
    kernels' bf16 mode) held against their plain versions on the captured
    run_batch's own next-step inputs. Returns the metrics and the captured
    runs' launches."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.solver import run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    p = PROBLEMS_PER_PROGRAM[-1]
    oracle, start, goal, bounds = car_world(BATCH, device)
    metrics, launches = {}, {}
    for name, order, bf16, group_size in CAPTURE_CELLS:
        cfg = bf16_config(run_planner_config()) if bf16 else run_planner_config()
        flags = {} if order == "batch" else {f"{order}_step": True}
        solver = ExperimentalConstrainedSolver(cfg, rectangle_collision, device=device, **flags)
        state = solver.init_state(torch.Generator(device=device).manual_seed(seed), start, goal,
                                  bounds, oracle, group_size=group_size)
        path = BATCH_PATH if order == "batch" else MAIN_PATH if order == "jacobi" else ()

        def run(slv):
            g = torch.Generator(device=device).manual_seed(seed + 1)
            if order == "batch":
                return slv.run_batch(state, oracle, CAPTURE_STEPS, g, problems_per_program=p)
            if group_size > 1:
                return slv.run_grouped(state, oracle, CAPTURE_STEPS, group_size, g)
            return slv.run(state, oracle, CAPTURE_STEPS, g)

        captured_solver = solver.with_aot(f"agree-{name}")
        seconds, finals = {}, {}
        for mode, slv in (("eager", solver), ("captured", captured_solver),
                          ("captured_again", captured_solver)):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            finals[mode], _ = run(slv)
            torch.cuda.synchronize()
            seconds[mode] = time.perf_counter() - t0
            check_launches(dict(kernels.LAUNCHES), path, CAPTURE_STEPS, f"phase 16b {name} {mode}")
            if mode != "eager":
                for k, n in kernels.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + n
        held = same_state(f"phase 16b {name}", finals["eager"], finals["captured"])
        same_state(f"phase 16b {name} (replayed again)", finals["eager"], finals["captured_again"])
        metrics[name] = {
            "order": order, "compute_dtype": cfg.onf.compute_dtype, "group_size": group_size,
            "steps": CAPTURE_STEPS, "eager_s": seconds["eager"],
            "captured_s_with_capture": seconds["captured"],
            "captured_s": seconds["captured_again"], "programs": captured_solver.aot_events,
            "launches_per_step": {k: n / CAPTURE_STEPS for k, n in kernels.LAUNCHES.items() if n},
            "against_eager": held,
        }
        if order == "batch":
            metrics[name]["kernels_held"] = hold_path_kernels(
                "phase 16b captured run_batch", captured_solver, finals["captured"], oracle,
                seed + 16, problems_per_program=p)
        log(f"phase 16b {name}: eager {seconds['eager']:.3f}s, captured "
            f"{seconds['captured_again']:.3f}s per {CAPTURE_STEPS} steps, bit-identical")
    return metrics, launches


# phase 17, the dynamic schedule and pretraining as captured programs: a
# `run` entered off a chunk's start (DYNAMIC_ENTRY steps, then DYNAMIC_STEPS)
# and one of DYNAMIC_ALIGNED steps from a chunk's start replay the one-step
# program; the Jacobi and merged orders at ORDER_BATCH x ORDER_STEPS; the
# planner's step counts (PLANNER_STEPS); kernel 2 at pretraining's M on the
# car config (PRETRAIN_POINTS)
DYNAMIC_ENTRY, DYNAMIC_STEPS, DYNAMIC_ALIGNED = 5, 100, 7
ORDER_BATCH, ORDER_STEPS = 64, 20
PLANNER_STEPS = (7, 13, 1000)
PRETRAIN_POINTS = (100, 200)
DYNAMIC_PROFILE = {"warmup": 25, "steps": 20}  # 25 warm-up steps leave the state off the chunk


def dynamic_pair(what: str, solver, state, oracle, seed: int, path: tuple, prefix: str,
                 steps: int = DYNAMIC_STEPS) -> tuple[dict, dict, object]:
    """`solver` eagerly and through `solver.with_aot(prefix)`, each from
    `state` with a generator seeded `seed`: DYNAMIC_ENTRY steps (the
    captured copy's first call captures its one-step program), then
    `steps` steps entered off the chunk, timed, each kernel of `path`
    launched once per step; then DYNAMIC_ALIGNED steps from `state` (a
    chunk's start) with another generator. Every leaf of both final states
    bit-identical to the eager run's. Returns the metrics, the captured
    off-chunk run's launches and its final state."""
    import torch

    from nfopp_tpu_torch import kernels

    captured_solver = solver.with_aot(prefix)
    finals, aligned, seconds = {}, {}, {}
    for mode, slv in (("eager", solver), ("captured", captured_solver)):
        g = torch.Generator(device=solver.device).manual_seed(seed)
        entered, _ = slv.run(state, oracle, DYNAMIC_ENTRY, g)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        finals[mode], _ = slv.run(entered, oracle, steps, g)
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - t0
        check_launches(dict(kernels.LAUNCHES), path, steps, f"phase 17 {what} {mode}")
        if mode == "captured":
            launches = dict(kernels.LAUNCHES)
        g = torch.Generator(device=solver.device).manual_seed(seed + 1)
        aligned[mode], _ = slv.run(state, oracle, DYNAMIC_ALIGNED, g)
    held = same_state(f"phase 17 {what} off the chunk", finals["eager"], finals["captured"])
    same_state(f"phase 17 {what} {DYNAMIC_ALIGNED} steps", aligned["eager"], aligned["captured"])
    batch = state.start.shape[0]
    log(f"phase 17 {what}: {steps} steps off the chunk, eager {seconds['eager']:.3f}s, "
        f"captured {seconds['captured']:.3f}s, bit-identical")
    return {
        "batch": batch, "compute_dtype": solver.config.onf.compute_dtype,
        "entered_at": DYNAMIC_ENTRY, "steps": steps, "aligned_steps": DYNAMIC_ALIGNED,
        "eager_s": seconds["eager"], "captured_s": seconds["captured"],
        "captured_host_ms_per_step": seconds["captured"] / steps * 1e3,
        "captured_us_per_step_per_problem": per_problem_us(seconds["captured"], steps,
                                                           batch),
        "programs": captured_solver.aot_events, "launches_per_step": {
            k: n / steps for k, n in launches.items() if n},
        "against_eager": held,
    }, launches, finals["captured"]


def dynamic_schedule(device, seed: int) -> tuple[dict, dict, dict]:
    """Phase 17a: the dynamic schedule captured (`dynamic_pair`): the car
    scene in f32 and bf16 and the holonomic two-walls scene
    (make_onf_planner's config, 400 pretraining iterations in the eager
    init) at BATCH; the Jacobi (f32) and merged (f32) orders at ORDER_BATCH
    x ORDER_STEPS; then tools/profile_step.py --aot on a run off the chunk
    (f32 and bf16): host and busy ms per step. Returns the metrics, the
    captured runs' launches and the captured states off the chunk (for 17d)."""
    import tempfile
    from types import SimpleNamespace

    import torch

    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.solver import ConstrainedSolver, PlannerFactory, run_planner_config
    from nfopp_tpu_torch.tools import profile_step
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import circle_collision, rectangle_collision

    metrics, launches, states = {}, {}, {}

    def add(counted):
        for k, n in counted.items():
            launches[k] = launches.get(k, 0) + n

    car, start, goal, bounds = car_world(BATCH, device)
    for dtype, path in (("f32", MAIN_PATH), ("bf16", MAIN_PATH_BF16)):
        cfg = run_planner_config() if dtype == "f32" else bf16_config(run_planner_config())
        solver = ConstrainedSolver(cfg, rectangle_collision, device=device)
        state = solver.init_state(torch.Generator(device=device).manual_seed(seed), start, goal,
                                  bounds, car)
        metrics[f"car_{dtype}"], counted, final = dynamic_pair(
            f"car {dtype}", solver, state, car, seed + 1, path, f"dynamic-{dtype}")
        states[f"car_{dtype}"] = (solver, final, car)
        add(counted)

    walls, start2, goal2, bounds2 = two_walls_world(BATCH, device)
    solver = PlannerFactory.make_onf_planner(circle_collision, walls, device=device).solver
    state = solver.init_state(torch.Generator(device=device).manual_seed(seed), start2, goal2,
                              bounds2, walls)
    metrics["holonomic_f32"], counted, final = dynamic_pair(
        "holonomic f32", solver, state, walls, seed + 1, MAIN_PATH, "dynamic-holonomic")
    states["holonomic_f32"] = (solver, final, walls)
    add(counted)

    car, start, goal, bounds = car_world(ORDER_BATCH, device)
    for order, path in (("jacobi", MAIN_PATH), ("merged", ())):
        solver = ExperimentalConstrainedSolver(run_planner_config(), rectangle_collision,
                                               device=device, **{f"{order}_step": True})
        state = solver.init_state(torch.Generator(device=device).manual_seed(seed), start, goal,
                                  bounds, car)
        metrics[f"{order}_f32"], counted, _ = dynamic_pair(
            f"{order} f32", solver, state, car, seed + 1, path, f"dynamic-{order}", ORDER_STEPS)
        add(counted)

    keys = ("host_ms_per_step", "device_busy_ms_per_step", "kernels_per_step",
            "launch_calls_per_step", "graph_replays_per_step", "host_launch_ms_per_step",
            "host_launch_ms_per_step_by_call", "port_kernel_launches_per_step", "aot_events")
    with tempfile.TemporaryDirectory() as tmp:
        for bf16 in (False, True):
            result = profile_step.profile(SimpleNamespace(
                batch=BATCH, seed=seed, bf16=bf16, order="default", aot=True,
                trace=pathlib.Path(tmp) / "trace.json", **DYNAMIC_PROFILE))
            metrics[f"profile_{'bf16' if bf16 else 'f32'}_off_chunk"] = {
                k: result[k] for k in keys}
    return metrics, launches, states


def init_pair(what: str, device, seed: int, eager_init, captured_init, iterations: int,
              path: tuple, events: list) -> tuple[dict, dict]:
    """An init with pretraining eagerly (`eager_init(generator)`) and through
    its captured program twice (`captured_init(generator)`: the first call
    captures it, the second replays the stored program), each from a
    generator seeded `seed`: every leaf bit-identical to the eager init's,
    each generator ending where the eager init leaves its own, and the
    kernels of `path` launched `iterations` times by each init. Returns the
    metrics and the captured inits' launches."""
    import torch

    from nfopp_tpu_torch import kernels

    seconds, states, generators, launches = {}, {}, {}, {}
    for mode, init in (("eager", eager_init), ("captured", captured_init),
                       ("captured_again", captured_init)):
        generators[mode] = torch.Generator(device=device).manual_seed(seed)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[mode] = init(generators[mode])
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - t0
        check_launches(dict(kernels.LAUNCHES), path, 0, f"phase 17b {what} {mode}",
                       pretrain_launches(iterations))
        if mode != "eager":
            for k, n in kernels.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + n
    for mode in ("captured", "captured_again"):
        held = same_state(f"phase 17b {what} ({mode})", states["eager"], states[mode])
        if not torch.equal(generators[mode].get_state(), generators["eager"].get_state()):
            raise AssertionError(f"phase 17b {what}: the {mode} init leaves its generator "
                                 "elsewhere than the eager init")
    log(f"phase 17b {what}: eager {seconds['eager']:.3f}s, captured {seconds['captured']:.3f}s "
        f"(with its capture), again {seconds['captured_again']:.3f}s, bit-identical")
    return {"iterations": iterations, "eager_s": seconds["eager"],
            "captured_s_with_capture": seconds["captured"],
            "captured_s": seconds["captured_again"], "programs": events,
            "against_eager": {**held, "generator_equal": True}}, launches


def pretraining(device, seed: int, scenarios) -> tuple[dict, dict]:
    """Phase 17b: pretraining as its captured program (`init_pair`):
    BatchPlanner(aot_prefix=...)'s init_batch at the suite's config
    (bench_parameters: 100 iterations on 200 points) on phase 10's 256
    corridor worlds, and HolonomicSolver.init_state with make_onf_planner's
    demo config (400 iterations) on the two-walls scene, B=BATCH, each
    against its eager init. Returns the metrics and the captured inits'
    launches."""
    import numpy as np
    import torch

    from nfopp_tpu_torch.bench.runner import _stack_oracles
    from nfopp_tpu_torch.parallel import BatchPlanner
    from nfopp_tpu_torch.solver import ConstrainedSolver, PlannerFactory, config_from_parameters
    from nfopp_tpu_torch.worlds import circle_collision, grid_collision

    config = config_from_parameters(load_script("run_benchmark_torch").bench_parameters())
    solver = ConstrainedSolver(config, grid_collision, device=device)
    oracles = _stack_oracles([s.oracle(SUITE_SOLVE["footprint_radius"], device)
                              for s in scenarios])
    ends = [torch.tensor(np.stack([np.asarray(getattr(s, name), np.float32) for s in scenarios]),
                         device=device) for name in ("start", "goal", "bounds")]
    plain, captured = BatchPlanner(solver), BatchPlanner(solver, aot_prefix="pretrain")
    metrics, launches = {}, {}
    metrics["suite"], counted = init_pair(
        f"suite init (B={len(scenarios)}, M={config.init_collision_points})", device, seed,
        lambda g: plain.init_batch(g, *ends, oracles),
        lambda g: captured.init_batch(g, *ends, oracles),
        config.init_collision_iteration, ("field_grad",), captured.aot_events)
    metrics["suite"].update(batch=len(scenarios), points=config.init_collision_points)
    launches.update(counted)

    walls, start, goal, bounds = two_walls_world(BATCH, device)
    solver = PlannerFactory.make_onf_planner(circle_collision, walls, device=device).solver
    captured_solver = solver.with_aot("pretrain-holonomic")
    metrics["holonomic"], counted = init_pair(
        f"holonomic init (B={BATCH}, M={solver.config.init_collision_points})", device, seed,
        lambda g: solver.init_state(g, start, goal, bounds, walls),
        lambda g: captured_solver.init_state(g, start, goal, bounds, walls),
        solver.config.init_collision_iteration, ("field_grad",), captured_solver.aot_events)
    metrics["holonomic"].update(batch=BATCH, points=solver.config.init_collision_points)
    for k, n in counted.items():
        launches[k] = launches.get(k, 0) + n
    return metrics, launches


def planner_capture(device, seed: int) -> tuple[dict, dict]:
    """Phase 17c (i): NFOPPlanner on the car scene with the dynamic demo's
    parameters (DEFAULT_PARAMETERS, 100 pretraining iterations), one
    problem: init, then step(n) for n in PLANNER_STEPS (7 and 13 off the
    chunk: the one-step program; 1000 from step 20: the chunk program),
    against the eager solver driven as the planner drives it (one generator
    seeded alike, init then `run` with its noise): after each call every leaf
    of the state and the aux bit-identical; each f32 kernel launched by the
    planner once per step (kernel 2 also once per pretraining iteration).
    Returns the metrics and the planner's launches."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.ops.sampling import GeneratorNoise
    from nfopp_tpu_torch.solver import PlannerFactory
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    demo = load_script("dynamic_replan_demo_torch")
    car, start, goal, bounds = car_world(1, device)
    planner = PlannerFactory.make_constrained_onf_planner(
        rectangle_collision, car, demo.demo_parameters(), seed=seed, device=device)
    solver = planner.solver
    g = torch.Generator(device=device).manual_seed(seed)
    calls = [("init", lambda: planner.init(start[0], goal[0], bounds[0]),
              lambda: solver.init_state(g, start, goal, bounds, car))]
    eager = {}
    for n in PLANNER_STEPS:
        calls.append((f"step({n})", lambda n=n: planner.step(n),
                      lambda n=n: solver.run(eager["state"], car, n, GeneratorNoise(g))))
    seconds, eager_seconds, launches = {}, {}, {}
    for name, call, twin in calls:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = call()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        for k, n in kernels.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + n
        t0 = time.perf_counter()
        out = twin()
        torch.cuda.synchronize()
        eager_seconds[name] = time.perf_counter() - t0
        if name == "init":
            eager["state"] = out
            same_state("phase 17c planner init", out, planner.state)
        else:
            eager["state"] = out[0]
            same_state(f"phase 17c planner {name}", out, (planner.state, aux))
    pretraining_iterations = solver.config.init_collision_iteration
    check_launches(launches, MAIN_PATH, sum(PLANNER_STEPS), "phase 17c the planner",
                   pretrain_launches(pretraining_iterations))
    log(f"phase 17c planner: captured {seconds}, eager {eager_seconds}, bit-identical")
    return {"steps": list(PLANNER_STEPS), "pretraining_iterations": pretraining_iterations,
            "captured_s": seconds, "eager_s": eager_seconds, "programs": planner.aot_events,
            "against_eager": {"bit_identical": True, "calls": len(calls)}}, launches


def stored_program_check(device, seed: int) -> dict:
    """Phase 17c (iii): a program taken from the store for a second solver
    of its key after the capturing solver is gone: the graph reads the
    capturing solver's constants (its inverse Hessian), which the program
    keeps alive (`utils/aot.py`). The first solver captures the car scene's
    chunk program (B=4, f32) and is dropped, its freed blocks are taken by
    tensors of NaN, and the second solver's replayed run must equal its eager
    run bit for bit."""
    import torch

    from nfopp_tpu_torch.solver import ConstrainedSolver, run_planner_config
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    oracle, start, goal, bounds = car_world(4, device)

    def run(solver):
        g = torch.Generator(device=device).manual_seed(seed)
        state = solver.init_state(g, start, goal, bounds, oracle)
        return solver.run(state, oracle, 10, g)

    first = ConstrainedSolver(run_planner_config(), rectangle_collision,
                              device=device).with_aot("stored")
    run(first)
    del first
    gc.collect()
    n = run_planner_config().trajectory_length
    junk = [torch.full((n, n), float("nan"), device=device) for _ in range(4000)]
    solver = ConstrainedSolver(run_planner_config(), rectangle_collision, device=device)
    second = solver.with_aot("stored")
    held = same_state("phase 17c stored program for a second solver", run(solver), run(second))
    del junk
    if not second.aot_events[0]["loaded"]:
        raise AssertionError("phase 17c: the second solver captured its own program")
    return {**held, "programs": second.aot_events}


def pretraining_field_grad(what: str, solver, state, oracle, m: int, seed: int,
                           peaks) -> dict:
    """Kernel 2 at a pretraining shape: M uniform points in the state's
    bounds (2-wide on a holonomic state), labelled by the oracle, on the
    state's field, held against its plain version (`hold_field_grad`) and
    timed beside its bound (`time_kernel`)."""
    import torch

    from nfopp_tpu_torch import kernels
    from nfopp_tpu_torch.ops.sampling import uniform_box_points

    onf, params = solver.config.onf, state.field_params
    batch, dim = state.start.shape
    g = torch.Generator(device=solver.device).manual_seed(seed)
    u = torch.rand((batch, m, dim), generator=g, device=solver.device)
    points = uniform_box_points(u, state.bounds, dim == 3)
    truth = solver.oracle_fn(oracle, points)
    name = "field_grad" + ("_bf16" if onf.compute_dtype == "bfloat16" else "")
    return {"max_abs_err": hold_field_grad(f"{what} M={m}", params, points, truth, onf),
            **time_kernel(name, lambda: kernels.field_grad(params, points, truth, onf),
                          lambda: kernels.field_grad_plain(params, points, truth, onf), onf,
                          params, m, dim, peaks)}


def dynamic_kernels(seed: int, states: dict, peaks) -> dict:
    """Phase 17d: kernels 1, 2, 3a and 3b held against their plain versions
    and timed beside their bounds (`hold_path_kernels` with `peaks`) on the
    inputs the next step of each of 17a's captured states off the chunk
    gives them: the car scene in f32 and bf16, the holonomic path's 2-wide
    points; then kernel 2 at pretraining's shapes on the same fields: M in
    PRETRAIN_POINTS on the car's, init_collision_points on the holonomic
    one's (`pretraining_field_grad`)."""
    out = {}
    for name, (solver, state, oracle) in states.items():
        out[name] = hold_path_kernels(f"phase 17d {name}", solver, state, oracle, seed + 17,
                                      peaks=peaks)
        sizes = (PRETRAIN_POINTS if name.startswith("car")
                 else (solver.config.init_collision_points,))
        out[name]["pretraining_field_grad"] = {
            f"M={m}": pretraining_field_grad(f"phase 17d {name} pretraining field_grad", solver,
                                             state, oracle, m, seed + 18, peaks)
            for m in sizes}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of weights, data and noise")
    parser.add_argument("--mesh-worker", default=None, metavar="OUT",
                        help="run one rank of phase 15 (the script's arguments follow --)")
    parser.add_argument("--mesh-cases", default=None, metavar="OUT",
                        help="run one rank of phase 15e (with --rank and --init-file)")
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    parser.add_argument("script_args", nargs="*", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script measures the card and has no CPU mode")
        return 2
    sys.path.insert(0, str(ROOT))
    if args.mesh_worker is not None:
        return mesh_worker(args.mesh_worker, args.seed, args.script_args)
    if args.mesh_cases is not None:
        return mesh_cases_worker(args.mesh_cases, args.seed, args.rank, args.init_file)
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
    kernel_results.update(check_adam(device, peaks, args.seed, BATCH))

    # 4. main path
    agreement, drift = agreement_check(device, args.seed)
    log(f"agreement CUDA vs CPU, one step of 4 problems: {agreement}")
    metrics, launches, main_state = solve(device, args.seed, BATCH, STEPS, MAIN_PATH)
    eager_seconds = {"f32": metrics["seconds"]}
    main_digest = state_digest(main_state)  # phase 15a holds its mesh run against it
    metrics.update(build_s=build_s, agreement_max_abs=agreement, card=card,
                   drift_trajectory={d["step"]: d["trajectory"] for d in drift})
    print(json.dumps({"main_path": metrics}), flush=True)

    # 5. bf16 batch path
    agreement = bf16_agreement_check(device, args.seed, batch_path=True)
    log(f"agreement CUDA vs CPU, one bf16 batch step of 4 problems: {agreement}")
    batch_metrics, batch_launches, _ = solve(device, args.seed, BATCH, STEPS, BATCH_PATH)
    batch_metrics.update(problems_per_program=PROBLEMS_PER_PROGRAM[-1], compute_dtype="bfloat16",
                         agreement_max_abs=agreement, card=card)
    print(json.dumps({"batch_path": batch_metrics}), flush=True)
    launches.update({name: batch_launches[name] for name in BATCH_PATH})

    # 6. bf16 main path
    agreement = bf16_agreement_check(device, args.seed, batch_path=False)
    log(f"agreement CUDA vs CPU, one bf16 main-path step of 4 problems: {agreement}")
    bf16_metrics, bf16_launches, bf16_state = solve(device, args.seed, BATCH, STEPS,
                                                    MAIN_PATH_BF16)
    eager_seconds["bf16"] = bf16_metrics["seconds"]
    bf16_metrics.update(compute_dtype="bfloat16", agreement_max_abs=agreement, card=card)
    print(json.dumps({"main_path_bf16": bf16_metrics}), flush=True)
    # the collision kernels' bf16 mode runs on both bf16 paths; its launches
    # are the batch path's, which the line reported before this path existed
    launches.update({name: bf16_launches[name] for name in MAIN_PATH_BF16
                     if name not in BATCH_PATH})
    launches[ADAM] += batch_launches[ADAM] + bf16_launches[ADAM]

    # 7. tracked (anytime) path, bf16
    tracked, _, resumable = tracked_solve(device, args.seed, BATCH)
    print(json.dumps({"tracked_path": {**tracked, "card": card}}), flush=True)

    # 8. shared-field grouped path, f32
    grouped, _, grouped_result = grouped_solve(device, args.seed, BATCH, STEPS)
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
    for name in COUNTED:
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
        for name in COUNTED:
            launches[name] += counted[name]
    for name in MAIN_PATH_BF16 + (ADAM,):
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
    for name in COUNTED:
        launches[name] += demo_launches[name]
    log(f"phase 12: {time.perf_counter() - t0:.1f}s")

    # 13. the merged step and the Jacobi order, then the suite and parity
    # scripts: their launches join the f32 kernels' counts
    t0 = time.perf_counter()
    for line, order, bf16, group_size in MERGED_CELLS:
        metrics, order_launches = order_solve(device, args.seed, BATCH, STEPS, order, bf16,
                                              group_size)
        print(json.dumps({line: {**metrics, "card": card}}), flush=True)
        for name in COUNTED:
            launches[name] += order_launches[name]
    agreement = merged_agreement(device, args.seed)
    print(json.dumps({"merged_agreement": {**agreement, "card": card}}), flush=True)
    for line, metrics, script_launches in suite_scripts(device, args.seed):
        print(json.dumps({line: {**metrics, "card": card}}), flush=True)
        for name in COUNTED:
            launches[name] += script_launches[name]
    log(f"phase 13: {time.perf_counter() - t0:.1f}s")

    # 14. program capture: the main paths, the grouped path and the fleet
    # service as replays of captured chunk programs, held against their eager
    # phases; their launches join the kernels' counts
    t0 = time.perf_counter()
    captured_states, captured_seconds = {}, {}
    for line, path, eager_state, dtype in (("captured_path", MAIN_PATH, main_state, "f32"),
                                           ("captured_path_bf16", MAIN_PATH_BF16, bf16_state,
                                            "bf16")):
        captured, captured_launches, captured_states[dtype] = solve(
            device, args.seed, BATCH, STEPS, path, aot=f"car-{dtype}")
        captured.update(against_eager=same_state(line, eager_state, captured_states[dtype]),
                        eager_seconds=eager_seconds[dtype],
                        launches={name: captured_launches[name] for name in path + (ADAM,)},
                        card=card)
        captured_seconds[dtype] = captured["seconds"]
        print(json.dumps({line: captured}), flush=True)
        for name in path + (ADAM,):
            launches[name] += captured_launches[name]
    del main_state, bf16_state
    # the same captured batch with PyTorch's elementwise Adam in the program
    # in place of the kernel: the final state bit for bit
    with plain_adam():
        plain, _, plain_state = solve(device, args.seed, BATCH, STEPS, MAIN_PATH,
                                      aot="car-f32-plain-adam", adam_per_step=0)
    plain.update(against_kernel=same_state("captured path, plain Adam against the kernel",
                                           captured_states["f32"], plain_state),
                 kernel_seconds=captured_seconds["f32"], card=card)
    print(json.dumps({"captured_path_plain_adam": plain}), flush=True)
    del captured_states, plain_state
    captured, captured_launches, captured_result = grouped_solve(device, args.seed, BATCH, STEPS,
                                                                 aot_prefix="grouped")
    captured.update(against_eager=same_state("captured grouped path", grouped_result,
                                             captured_result),
                    eager_seconds=grouped["seconds"],
                    launches={name: captured_launches[name] for name in MAIN_PATH}, card=card)
    print(json.dumps({"captured_grouped_path": captured}), flush=True)
    del grouped_result, captured_result
    service_aot, service_aot_launches = fleet_service(device, args.seed, aot=True)
    print(json.dumps({"captured_fleet_service": {
        **service_aot, "eager": {k: service[k] for k in ("p50_ms", "p99_ms", "mean_steps_per_cycle")},
        "card": card}}), flush=True)
    for counted in (captured_launches, service_aot_launches):
        for name in COUNTED:
            launches[name] += counted[name]
    print(json.dumps({"step_profiles": {**profile_orders(args.seed), "card": card}}), flush=True)
    parts = load_script("profile_step2_torch").profile_parts(device, BATCH, PARTS_STEPS, args.seed)
    print(json.dumps({"step_parts": {"batch": BATCH, "calls": PARTS_STEPS, "parts": parts,
                                     "card": card}}), flush=True)
    log(f"phase 14: {time.perf_counter() - t0:.1f}s")

    # 15. the problem mesh: its ranks' launches join the kernels' counts
    t0 = time.perf_counter()
    mesh, mesh_launches = mesh_phase(args.seed, main_digest, eager_seconds["f32"], card)
    print(json.dumps({"mesh": {**mesh, "card": card}}), flush=True)
    for name in COUNTED:
        launches[name] += mesh_launches[name]
    log(f"phase 15: {time.perf_counter() - t0:.1f}s")

    # 16. the bench on the card: its timed loops' launches and the captured
    # runs' join the kernels' counts
    t0 = time.perf_counter()
    bench_lines, bench_launches = bench_modes(args.seed, card)
    for line, result in bench_lines:
        print(json.dumps({line: result}), flush=True)
    agreement, agreement_launches = capture_agreement(device, args.seed)
    print(json.dumps({"capture_agreement": {**agreement, "card": card}}), flush=True)
    ablation = load_script("profile_step_torch").profile_variants(
        device, BATCH, ABLATION_STEPS, True, args.seed)
    print(json.dumps({"step_ablation": {"batch": BATCH, "steps": ABLATION_STEPS,
                                        "variants": ablation, "card": card}}), flush=True)
    for counted in (bench_launches, agreement_launches):
        for name, n in counted.items():
            launches[name] += n
    log(f"phase 16: {time.perf_counter() - t0:.1f}s")

    # 17. the dynamic schedule and pretraining as captured programs, the
    # planner and the host service over them: the captured runs' launches
    # join the kernels' counts
    t0 = time.perf_counter()
    dynamic, dynamic_launches, off_chunk = dynamic_schedule(device, args.seed)
    print(json.dumps({"dynamic_schedule": {**dynamic, "card": card}}), flush=True)
    pretrained, pretraining_launches = pretraining(device, args.seed, suite_scenarios)
    print(json.dumps({"pretraining": {**pretrained, "card": card}}), flush=True)
    planner_metrics, planner_launches = planner_capture(device, args.seed)
    print(json.dumps({"planner_capture": {**planner_metrics, "card": card}}), flush=True)
    # phase 11a's planner is gone: release the cached blocks, so that a stored
    # program reading its solver's freed constants faults here
    gc.collect()
    torch.cuda.empty_cache()
    host_again, host_again_launches = host_service(device, args.seed)
    print(json.dumps({"host_service_captured": {
        **host_again, "first_run": {k: host[k] for k in ("cycle_ms_p50", "cycle_ms_p99")},
        "card": card}}), flush=True)
    print(json.dumps({"stored_program": {**stored_program_check(device, args.seed),
                                         "card": card}}), flush=True)
    print(json.dumps({"dynamic_kernels": {**dynamic_kernels(args.seed, off_chunk, peaks),
                                          "card": card}}), flush=True)
    del off_chunk
    for counted in (dynamic_launches, pretraining_launches, planner_launches,
                    host_again_launches):
        for name, n in counted.items():
            launches[name] += n
    log(f"phase 17: {time.perf_counter() - t0:.1f}s")

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
