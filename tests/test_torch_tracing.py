"""The port's spans (`nfopp_tpu_torch.utils.profiling.span`) on the CPU: they
record only under a torch.profiler profile, with their parents, in a buffer
of bounded size, and appear as `nfopp_tpu_torch.*` ranges in the exported
Chrome trace; a `run` of a `with_aot` solver records one `run`, `sync`,
`program` and `run.outputs` span and one `replay` per program call, and no
`capture` (on the CPU a program is its eager function). B=4, the car scene,
hidden 16."""
import json

import pytest
import torch

from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.parallel.mesh import any_over_problems
from nfopp_tpu_torch.solver import ConstrainedSolver, SolverConfig, evaluate_path
from nfopp_tpu_torch.tools.scene import car_world
from nfopp_tpu_torch.utils import profiling
from nfopp_tpu_torch.worlds import rectangle_collision

B = 4
CFG = SolverConfig(trajectory_length=12, collision_point_count=12, random_field_points=4,
                   onf=ONFConfig(angle_encoding=True, hidden=16), angle_offset=0.3)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def names(records) -> list:
    return [r.name for r in records]


def solver_and_state(prefix="spans", pretrain=0):
    oracle, start, goal, bounds = car_world(B, "cpu")
    cfg = CFG._replace(init_collision_iteration=pretrain, init_collision_points=16)
    solver = ConstrainedSolver(cfg, rectangle_collision, device="cpu").with_aot(prefix)
    g = torch.Generator().manual_seed(0)
    return solver, solver.init_state(g, start, goal, bounds, oracle), oracle, g


def test_no_span_records_without_a_profiler():
    with profiling.span("outer", steps=3) as outer:
        with profiling.span("inner") as inner:
            pass
    assert outer is None and inner is None
    assert profiling.spans() == []
    # off, a span is one shared do-nothing context: nothing is allocated for it
    assert profiling.span("a") is profiling.span("b")
    solver, state, oracle, g = solver_and_state()
    solver.run(state, oracle, 10, g)
    assert profiling.spans() == []


def test_spans_record_with_their_parents_and_reach_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as out:
        with profiling.span("outer", steps=3) as outer:
            outer.attrs["schedule"] = "static"
            with profiling.span("inner"):
                torch.ones(3).sum()
            with profiling.span("inner"):
                pass
        with profiling.span("after"):
            pass
    records = profiling.spans()
    assert names(records) == ["outer", "inner", "inner", "after"]
    first, a, b, after = records
    assert first.parent is None and after.parent is None
    assert a.parent == first.id and b.parent == first.id
    assert first.attrs == {"steps": 3, "schedule": "static"}
    assert first.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= first.end_ns
    assert first.end_ns <= after.start_ns
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    ranges = [e["name"] for e in events if e.get("name", "").startswith("nfopp_tpu_torch.")]
    assert sorted(ranges) == sorted(f"nfopp_tpu_torch.{n}" for n in names(records))
    # the records are a copy; clear_spans empties the buffer
    records[0].attrs["schedule"] = "dynamic"
    assert profiling.spans()[0].attrs["schedule"] == "static"
    profiling.clear_spans()
    assert profiling.spans() == []


def test_the_buffer_cap_holds(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 5)
    with torch.profiler.profile(activities=CPU) as prof:
        for i in range(8):
            with profiling.span("step", index=i) as span:
                assert span is not None  # past the cap a span still opens its range
    assert [r.attrs["index"] for r in profiling.spans()] == [0, 1, 2, 3, 4]
    opened = [e for e in prof.events() if e.name == "nfopp_tpu_torch.step"]
    assert len(opened) == 8


@pytest.mark.parametrize("steps", [10, 30])
def test_a_run_of_a_captured_solver_records_its_run_loop(steps):
    solver, state, oracle, g = solver_and_state()
    freq = CFG.reparametrize_trajectory_freq
    with torch.profiler.profile(activities=CPU):
        solver.run(state, oracle, steps, g)
    records = profiling.spans()
    assert names(records) == ["run", "sync", "program"] + ["replay"] * (steps // freq) + [
        "run.outputs"]
    run = records[0]
    assert run.attrs == {"steps": steps, "batch": B, "schedule": "static"}
    assert all(r.parent == run.id for r in records[1:])
    assert records[2].attrs == {"program": "spans-chunk-b4", "loaded": False}
    assert "capture" not in names(records)


def test_the_dynamic_schedule_replays_one_step_programs():
    solver, state, oracle, g = solver_and_state()
    state, _ = solver.run(state, oracle, 3, g)  # off the chunk's start
    with torch.profiler.profile(activities=CPU):
        solver.run(state, oracle, 4, g)
    records = profiling.spans()
    assert names(records) == ["run", "sync", "program"] + ["replay"] * 4 + ["run.outputs"]
    assert records[0].attrs["schedule"] == "dynamic"
    assert records[2].attrs["program"] == "spans-step-b4"


def test_init_pretraining_and_evaluation_are_spans():
    with torch.profiler.profile(activities=CPU):
        solver, state, oracle, g = solver_and_state(pretrain=3)
        evaluate_path(rectangle_collision, oracle, solver.full_trajectory(state))
    records = profiling.spans()
    assert names(records) == ["init", "pretrain", "program"] + ["evaluate"]
    init, pretrain, program, evaluate = records
    assert init.attrs == {"batch": B} and pretrain.parent == init.id
    assert program.parent == pretrain.id and program.attrs["program"] == "spans-pretrain-b4"
    assert evaluate.parent is None and evaluate.attrs == {"batch": B}


def test_a_host_decision_is_one_sync_span():
    with torch.profiler.profile(activities=CPU):
        assert any_over_problems(torch.tensor([False, True]), None)
        assert not any_over_problems(torch.tensor([False, False]), None)
    assert names(profiling.spans()) == ["sync", "sync"]
