"""The captured programs' routes through the solvers (solver.with_aot)
against the eager runs, bit for bit, on the CPU, where a program is its
function itself: the same `step_static` / `step` steps and pretraining
iterations, the body's copy-back into its input buffers and the aux written
replay by replay into [B, steps] buffers must change no bit. Covers
ConstrainedSolver.run (f32 and bf16), run_grouped, HolonomicSolver.run, a
field trained every 10th step (whose prev_trajectory is the chunk's input
trajectory), the tracked loops, the dynamic schedule's one-step program
(off the chunk and of a step count off it; constrained, holonomic, Jacobi,
merged), pretraining's one-iteration program (grouped and not, holonomic),
the experimental orders (Jacobi, merged, grouped merged, run_batch's own
program) and the keys that keep their programs apart,
BatchPlanner(aot_prefix=...), NFOPPlanner and run_grid_suite(aot=True). The
capture on the card is held by chip_smoke.py phases 14, 16b and 17. B=4, 20
steps, the car scene, hidden 16.
"""
import numpy as np
import pytest
import torch

from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.ops.sampling import GeneratorNoise
from nfopp_tpu_torch.parallel import BatchPlanner
from nfopp_tpu_torch.solver import (
    ConstrainedSolver,
    HolonomicSolver,
    SolverConfig,
    run_grouped_with_tracking,
    run_with_tracking,
)
from nfopp_tpu_torch.tools.scene import car_world
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import CircleOracle, circle_collision, rectangle_collision

B, STEPS = 4, 20
CFG = SolverConfig(trajectory_length=12, collision_point_count=12, random_field_points=4,
                   onf=ONFConfig(angle_encoding=True, hidden=16), angle_offset=0.3,
                   init_collision_iteration=5, init_collision_points=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Long loops of small tensor ops: one intra-op thread, so that test
    workers sharing the cores do not spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def car(cfg=CFG, group_size=1):
    oracle, start, goal, bounds = car_world(B, "cpu")
    solver = ConstrainedSolver(cfg, rectangle_collision, device="cpu")
    state = solver.init_state(gen(0), start, goal, bounds, oracle, group_size=group_size)
    return solver, state, oracle


def leaves_copy(tree):
    return [x.clone() for x in tree_leaves(tree)]


@pytest.mark.parametrize("cfg", [
    CFG,
    CFG._replace(onf=CFG.onf._replace(compute_dtype="bfloat16")),
    CFG._replace(optimize_collision_model_freq=10),
    CFG._replace(optimize_collision_model_freq=5),
], ids=["f32", "bf16", "field-every-10th", "field-every-5th"])
def test_run_through_the_chunk_program_equals_run(cfg):
    solver, state, oracle = car(cfg)
    before = leaves_copy(state)
    want = solver.run(state, oracle, STEPS, gen(1))
    captured = solver.with_aot("test")
    g = gen(1)
    got = captured.run(state, oracle, STEPS, g)
    assert same(want, got)
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(state)))  # input untouched
    assert captured.aot_events == [{"program": f"chunk-b{B}", "loaded": False, "seconds": 0.0}]
    assert solver.aot_prefix is None and not hasattr(solver, "aot_events")


def test_generator_ends_where_the_eager_run_leaves_it():
    solver, state, oracle = car()
    g_eager, g_captured = gen(3), gen(3)
    solver.run(state, oracle, STEPS, g_eager)
    solver.with_aot("test").run(state, oracle, STEPS, GeneratorNoise(g_captured))
    assert torch.equal(g_eager.get_state(), g_captured.get_state())


def test_run_grouped_through_the_chunk_program_equals_run_grouped():
    solver, state, oracle = car(group_size=2)
    want = solver.run_grouped(state, oracle, STEPS, 2, gen(1))
    captured = solver.with_aot("test")
    assert same(want, captured.run_grouped(state, oracle, STEPS, 2, gen(1)))
    assert captured.aot_events[0]["program"] == f"chunk-b{B}-g2"


def holonomic():
    cfg = CFG._replace(onf=CFG.onf._replace(angle_encoding=False))
    oracle = CircleOracle(torch.tensor([[[1.5, 1.5]]]), torch.tensor([[True]]),
                          torch.tensor([0.3]), torch.tensor([[0.0, 3.0, 0.0, 3.0]]))
    solver = HolonomicSolver(cfg, circle_collision, device="cpu")
    state = solver.init_state(gen(0), np.tile([[0.2, 0.2]], (B, 1)), np.tile([[2.8, 2.8]], (B, 1)),
                              np.tile([[0.0, 3.0, 0.0, 3.0]], (B, 1)), oracle)
    return solver, state, oracle


def test_holonomic_run_through_the_chunk_program_equals_run():
    solver, state, oracle = holonomic()
    want = solver.run(state, oracle, STEPS, gen(1))
    assert same(want, solver.with_aot("test").run(state, oracle, STEPS, gen(1)))


def test_tracked_loops_through_the_chunk_program_equal_the_eager_loops():
    solver, state, oracle = car()
    kw = dict(max_iterations=40, min_iterations=10, check_freq=10)
    want = run_with_tracking(solver, state, oracle, gen(1), **kw)
    assert same(want, run_with_tracking(solver.with_aot("test"), state, oracle, gen(1), **kw))
    solver, state, oracle = car(group_size=2)
    want = run_grouped_with_tracking(solver, state, oracle, 2, gen(1), **kw)
    got = run_grouped_with_tracking(solver.with_aot("test"), state, oracle, 2, gen(1), **kw)
    assert same(want, got)


@pytest.mark.parametrize("cfg", [
    CFG,
    CFG._replace(onf=CFG.onf._replace(compute_dtype="bfloat16")),
    CFG._replace(optimize_collision_model_freq=3),
], ids=["f32", "bf16", "field-every-3rd"])
def test_the_dynamic_schedule_runs_through_the_step_program(cfg):
    """A state off a chunk's start (10 steps from step 5), and 7 steps from
    a chunk's start, run the per-step schedule: on a with_aot copy as
    replays of the one-step program, equal to the eager run bit for bit,
    the generator ending where the eager run leaves it and the input
    untouched. A field trained every 3rd step (3 does not divide 10) is
    computed every step and kept where due, in the program as eagerly."""
    solver, state, oracle = car(cfg)
    off_chunk, _ = solver.run(state, oracle, 5, gen(2))
    captured = solver.with_aot("test")
    for start, steps in ((off_chunk, 10), (state, 7)):
        before = leaves_copy(start)
        g_eager, g_captured = gen(1), gen(1)
        want = solver.run(start, oracle, steps, g_eager)
        assert same(want, captured.run(start, oracle, steps, GeneratorNoise(g_captured)))
        assert torch.equal(g_eager.get_state(), g_captured.get_state())
        assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(start)))
    assert captured.aot_events == [{"program": f"step-b{B}", "loaded": False, "seconds": 0.0}]


def test_the_step_and_chunk_programs_have_distinct_keys():
    """One solver, one prefix, one batch: the dynamic schedule's one-step
    program and the static schedule's chunk program are two programs."""
    solver, state, oracle = car()
    captured = solver.with_aot("test")
    captured.run(state, oracle, 10, gen(1))
    captured.run(state, oracle, 3, gen(1))
    assert [e["program"] for e in captured.aot_events] == [f"chunk-b{B}", f"step-b{B}"]
    chunk, step = sorted(captured._aot_keys)
    assert chunk.startswith(f"test-chunk-b{B}-") and step.startswith(f"test-step-b{B}-")


def test_holonomic_dynamic_run_through_the_step_program_equals_run():
    solver, state, oracle = holonomic()
    off_chunk, _ = solver.run(state, oracle, 5, gen(2))
    captured = solver.with_aot("test")
    for start, steps in ((off_chunk, 10), (state, 7)):
        assert same(solver.run(start, oracle, steps, gen(1)),
                    captured.run(start, oracle, steps, gen(1)))
    assert captured.aot_events == [{"program": f"step-b{B}", "loaded": False, "seconds": 0.0}]


@pytest.mark.parametrize("group_size", [1, 2])
def test_pretraining_through_its_program_equals_the_eager_init(group_size):
    """init_state with pretraining (5 iterations) on a with_aot copy replays
    the one-iteration program: the state equals the eager init's bit for
    bit, and the generator ends where the eager init leaves it."""
    oracle, start, goal, bounds = car_world(B, "cpu")
    solver = ConstrainedSolver(CFG, rectangle_collision, device="cpu")
    captured = solver.with_aot("test")
    g_eager, g_captured = gen(0), gen(0)
    want = solver.init_state(g_eager, start, goal, bounds, oracle, group_size=group_size)
    got = captured.init_state(g_captured, start, goal, bounds, oracle, group_size=group_size)
    assert same(want, got)
    assert torch.equal(g_eager.get_state(), g_captured.get_state())
    rows = B // group_size
    name = f"pretrain-b{rows}" + (f"-g{group_size}" if group_size > 1 else "")
    assert captured.aot_events == [{"program": name, "loaded": False, "seconds": 0.0}]


def test_holonomic_pretraining_through_its_program_equals_the_eager_init():
    solver, state, oracle = holonomic()
    captured = solver.with_aot("test")
    args = (np.tile([[0.2, 0.2]], (B, 1)), np.tile([[2.8, 2.8]], (B, 1)),
            np.tile([[0.0, 3.0, 0.0, 3.0]], (B, 1)), oracle)
    assert same(state, captured.init_state(gen(0), *args))
    assert captured.aot_events == [{"program": f"pretrain-b{B}", "loaded": False,
                                    "seconds": 0.0}]


def experimental(flag=None, cfg=CFG, group_size=1, batch=B):
    oracle, start, goal, bounds = car_world(batch, "cpu")
    solver = ExperimentalConstrainedSolver(cfg, rectangle_collision, device="cpu",
                                           **({flag: True} if flag else {}))
    state = solver.init_state(gen(0), start, goal, bounds, oracle, group_size=group_size)
    return solver, state, oracle


@pytest.mark.parametrize("flag", ["jacobi_step", "merged_step", "use_fused_field_grad"])
def test_with_aot_admits_each_experimental_order_and_equals_its_eager_run(flag):
    solver, state, oracle = experimental(flag)
    want = solver.run(state, oracle, STEPS, gen(1))
    captured = solver.with_aot("test")
    assert captured.aot_prefix == "test"
    assert same(want, captured.run(state, oracle, STEPS, gen(1)))
    assert captured.aot_events == [{"program": f"chunk-b{B}", "loaded": False, "seconds": 0.0}]


@pytest.mark.parametrize("flag", ["jacobi_step", "merged_step"])
def test_each_experimental_order_s_dynamic_run_through_the_step_program(flag):
    solver, state, oracle = experimental(flag)
    off_chunk, _ = solver.run(state, oracle, 5, gen(2))
    captured = solver.with_aot("test")
    for start, steps in ((off_chunk, 10), (state, 7)):
        assert same(solver.run(start, oracle, steps, gen(1)),
                    captured.run(start, oracle, steps, gen(1)))
    assert captured.aot_events == [{"program": f"step-b{B}", "loaded": False, "seconds": 0.0}]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_batch_through_its_program_equals_run_batch(dtype):
    cfg = CFG._replace(onf=CFG.onf._replace(compute_dtype=dtype))
    solver, state, oracle = experimental(cfg=cfg)
    before = leaves_copy(state)
    g_eager, g_captured = gen(1), gen(1)
    want = solver.run_batch(state, oracle, STEPS, g_eager, problems_per_program=2)
    captured = solver.with_aot("test")
    got = captured.run_batch(state, oracle, STEPS, GeneratorNoise(g_captured),
                             problems_per_program=2)
    assert same(want, got)
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(state)))  # input untouched
    assert torch.equal(g_eager.get_state(), g_captured.get_state())
    assert captured.aot_events == [{"program": f"batch-b{B}-p2", "loaded": False,
                                    "seconds": 0.0}]


def test_grouped_merged_through_the_program_equals_run_grouped():
    solver, state, oracle = experimental("merged_step", group_size=2)
    want = solver.run_grouped(state, oracle, STEPS, 2, gen(1))
    captured = solver.with_aot("test")
    assert same(want, captured.run_grouped(state, oracle, STEPS, 2, gen(1)))
    assert captured.aot_events[0]["program"] == f"chunk-b{B}-g2"


def test_the_default_jacobi_merged_and_batch_programs_have_distinct_keys():
    """One config, one batch of 8 and one prefix: the default, Jacobi and
    merged chunk programs share a name, so only their keys keep them apart in
    the process's store; run_batch's P=8 program has its own."""
    keys = {}
    for label, flag in (("default", None), ("jacobi", "jacobi_step"),
                        ("merged", "merged_step"), ("batch", None)):
        solver, state, oracle = experimental(flag, batch=8)
        captured = solver.with_aot("test")
        if label == "batch":
            captured.run_batch(state, oracle, 10, gen(1), problems_per_program=8)
        else:
            captured.run(state, oracle, 10, gen(1))
        (keys[label],) = captured._aot_keys
        assert captured._step_order() == ("default" if label == "batch" else label)
    assert len(set(keys.values())) == 4, keys
    assert [key.rsplit("-", 1)[0] for key in keys.values()] == ["test-chunk-b8"] * 3 + [
        "test-batch-b8-p8"]


def test_batch_planner_aot_prefix_matches_the_plain_planner():
    solver, state, oracle = car()
    plain, captured = BatchPlanner(solver), BatchPlanner(solver, aot_prefix="suite")
    assert plain.aot_events == [] and captured.solver is not solver
    kw = dict(max_iterations=40, min_iterations=10, check_freq=10)
    assert same(plain.solve(state, oracle, gen(1), **kw),
                captured.solve(state, oracle, gen(1), **kw))
    assert same(plain.run(state, oracle, STEPS, gen(1)), captured.run(state, oracle, STEPS, gen(1)))
    assert captured.aot_events == [{"program": f"chunk-b{B}", "loaded": False, "seconds": 0.0}]
    _, grouped, _ = car(group_size=2)
    assert same(plain.solve_grouped_tracked(grouped, oracle, 2, gen(1), **kw),
                captured.solve_grouped_tracked(grouped, oracle, 2, gen(1), **kw))
    assert [e["program"] for e in captured.aot_events] == [f"chunk-b{B}", f"chunk-b{B}-g2"]


def test_batch_planner_aot_prefix_pretrains_through_its_program():
    """init_batch and init_batch_grouped of BatchPlanner(aot_prefix=...)
    replay the pretraining program and equal the plain planner's bit for
    bit; aot_events names the program of each row count and group size."""
    oracle, start, goal, bounds = car_world(B, "cpu")
    solver = ConstrainedSolver(CFG, rectangle_collision, device="cpu")
    plain, captured = BatchPlanner(solver), BatchPlanner(solver, aot_prefix="suite")
    assert same(plain.init_batch(gen(0), start, goal, bounds, oracle),
                captured.init_batch(gen(0), start, goal, bounds, oracle))
    assert same(plain.init_batch_grouped(gen(0), start, goal, bounds, oracle, 2),
                captured.init_batch_grouped(gen(0), start, goal, bounds, oracle, 2))
    assert [e["program"] for e in captured.aot_events] == [f"pretrain-b{B}",
                                                           f"pretrain-b{B // 2}-g2"]


def test_planner_api_steps_and_inits_through_its_programs_as_the_eager_solver():
    """NFOPPlanner inits and steps through solver.with_aot("planner"): on the
    CPU its path after init, step(7), step(13) (off the chunk) and step(10)
    equals the eager solver's on the same generator bit for bit, and it
    resolved the pretraining, step and chunk programs."""
    from nfopp_tpu_torch.solver import NFOPPlanner

    oracle, start, goal, bounds = car_world(1, "cpu")
    solver = ConstrainedSolver(CFG, rectangle_collision, device="cpu")
    planner = NFOPPlanner(solver, oracle, seed=4)
    planner.init(start[0], goal[0], bounds[0])
    g = gen(4)
    state = solver.init_state(g, start, goal, bounds, oracle)
    assert same(state, planner.state)
    for steps in (7, 13, 10):
        aux = planner.step(steps)
        state, want = solver.run(state, oracle, steps, GeneratorNoise(g))
        assert same(want, aux) and same(state, planner.state)
    np.testing.assert_array_equal(planner.get_path(), solver.full_trajectory(state)[0].numpy())
    assert [e["program"] for e in planner.aot_events] == ["pretrain-b1", "step-b1", "chunk-b1"]
    assert planner.solver is solver


def test_run_grid_suite_aot_matches_the_plain_suite_and_logs_its_programs():
    from test_torch_suite import FAST, small_parameters, wall_scenario

    from nfopp_tpu_torch.bench.runner import run_grid_suite

    worlds = [wall_scenario(), wall_scenario()]
    fast = dict(FAST, check_freq=20)  # chunks of whole 10-step programs
    plain = run_grid_suite(worlds, small_parameters(), device="cpu", **fast)
    captured = run_grid_suite(worlds, small_parameters(), device="cpu", aot=True, **fast)
    for name in ("paths", "feasible", "lengths", "iterations"):
        np.testing.assert_array_equal(getattr(plain, name), getattr(captured, name))
    assert "aot_events" not in plain.log.settings["suite"]
    events = captured.log.settings["suite"]["aot_events"]
    assert events == [{"program": "pretrain-b2", "loaded": False, "seconds": 0.0},
                      {"program": "chunk-b2", "loaded": False, "seconds": 0.0}]
