"""bench_torch.py, the port's counterpart of bench.py, on the CPU: its
workload equals bench.py's leaf for leaf (built through the JAX package's own
car_environment, pad_obstacle_points, RectangleOracle and
run_planner_config), its solver choice and its --field-freq refusal follow
bench.py's, a --timed-steps off the chunk runs the one-step program, one
run of the script (B=2, 20 steps in chunks of 10, a seed sweep, the anytime
solve, a floor it cannot reach) prints bench.py's keys less the dropped
ones and exits non-zero after printing, the anytime dict
gives null where nothing is feasible and scales the reference by the
iterations run (each against bench.py's own formula on one input), and the
bench refuses to start without a card unless asked for the CPU. The card's
runs are chip_smoke.py phase 16's."""
import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.solver import run_planner_config as jax_run_planner_config
from nfopp_tpu.worlds import RectangleOracle as JaxRectangleOracle
from nfopp_tpu.worlds import car_environment as jax_car_environment
from nfopp_tpu.worlds import pad_obstacle_points as jax_pad_obstacle_points
from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
from nfopp_tpu_torch.solver import ConstrainedSolver
from test_torch_capture_scripts import FORBIDDEN

ROOT = pathlib.Path(__file__).resolve().parent.parent
DROPPED = {"outer_unroll", "aot_loaded", "claim_wait_s"}
ADDED = {"p50_step_path", "captured", "capture_s", "launches_per_step", "feas_sweep"}


def load_bench():
    spec = importlib.util.spec_from_file_location("bench_torch", ROOT / "bench_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench = load_bench()


def bench_py_keys(name: str) -> set:
    """The string keys bench.py gives the dict it builds as `name`: its
    literal, then every `name["key"] = ...` after it."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == name and isinstance(node.value,
                                                                                ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                    and target.value.id == name and isinstance(target.slice, ast.Constant)):
                keys.add(target.slice.value)
    return keys


def config_dict(config) -> dict:
    return {**config._asdict(), "onf": config.onf._asdict()}


def test_workload_equals_bench_py_s_leaf_for_leaf():
    batch = 3
    env = jax_car_environment()
    pts, mask = jax_pad_obstacle_points(env.obstacle_points.astype(np.float32), 64)
    oracle = JaxRectangleOracle(
        jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray([-0.3, 0.2, -0.3, 0.2], jnp.float32),
        jnp.asarray([0.0, 3.0, 0.0, 3.0], jnp.float32),
    )
    want = {
        "oracle": jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (batch,) + (1,) * x.ndim),
                                         oracle),
        "starts": jnp.tile(jnp.asarray(env.start)[None], (batch, 1)),
        "goals": jnp.tile(jnp.asarray(env.goal)[None], (batch, 1)),
        "bounds": jnp.tile(jnp.asarray(env.bounds, jnp.float32)[None], (batch, 1)),
    }
    got = bench.workload(batch, "cpu")
    assert got.oracle._fields == want["oracle"]._fields
    pairs = list(zip(got.oracle, want["oracle"])) + [
        (getattr(got, name), want[name]) for name in ("starts", "goals", "bounds")]
    for g, w in pairs:
        w = np.asarray(w)
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("f32", [False, True])
def test_solver_config_equals_bench_py_s(f32):
    want = jax_run_planner_config()
    if not f32:
        want = want._replace(onf=want.onf._replace(compute_dtype="bfloat16"))
    assert config_dict(bench.solver_config(f32, 1)) == config_dict(want)
    assert bench.solver_config(f32, 5).optimize_collision_model_freq == 5


@pytest.mark.parametrize("flag", ["", "fused", "jacobi", "merged", "multi"])
def test_solver_choice_follows_bench_py(flag):
    args = bench.parse_args(["--device", "cpu"] + ([f"--{flag}"] if flag else [])
                            + (["8"] if flag == "multi" else []))
    solver = bench.make_solver(bench.solver_config(False, 1), args, "cpu")
    if not flag:
        assert type(solver) is ConstrainedSolver
        return
    assert isinstance(solver, ExperimentalConstrainedSolver)
    assert (solver.jacobi_step, solver.merged_step, solver.use_fused_field_grad) == (
        flag == "jacobi", flag == "merged", flag == "fused")


def test_field_freq_3_is_refused_as_bench_py_refuses_it():
    rule = "--field-freq 3 does not divide the reparam freq 10"
    jax_bench = subprocess.run(
        [sys.executable, str(ROOT / "bench.py"), "--cpu", "--batch", "2", "--field-freq", "3"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"},
    )
    assert jax_bench.returncode != 0 and rule in jax_bench.stderr, jax_bench.stderr[-2000:]
    with pytest.raises(SystemExit, match=rule):
        bench.main(["--device", "cpu", "--batch", "2", "--field-freq", "3"])


def test_an_off_chunk_timed_steps_runs_the_step_program(capsys):
    """--timed-steps 15 (off the 10-step chunk) is accepted: the warm-up and
    every timed call run the dynamic schedule, on the bench's with_aot copy
    the one-step program (`step-b2`; on the CPU the step itself). --multi
    refuses it, as run_batch has the static schedule only."""
    with pytest.raises(SystemExit, match="run_batch has the static schedule only"):
        bench.main(["--device", "cpu", "--batch", "2", "--multi", "2", "--timed-steps", "15"])
    assert bench.main(["--device", "cpu", "--batch", "2", "--steps", "15", "--timed-steps",
                       "15", "--feasibility-floor", "0"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert result["iterations_per_solve"] == 15 and result["p50_step_path"] == "eager"
    assert "programs [{'program': 'step-b2', 'loaded': False, 'seconds': 0.0}]" in err
    assert "chunk-b2" not in err


def test_bench_py_s_anytime_artifact_is_never_written():
    with pytest.raises(SystemExit, match="bench.py's artifact"):
        bench.main(["--device", "cpu", "--anytime", "--anytime-out",
                    str(ROOT / "artifacts" / "anytime_bench.json")])


def test_without_cuda_the_bench_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch", "2"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of the script on the CPU: (returncode, stdout lines, stderr,
    the anytime file)."""
    out = tmp_path_factory.mktemp("bench") / "anytime.json"
    result = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--device", "cpu", "--batch", "2",
         "--steps", "20", "--timed-steps", "10", "--feas-sweep", "1", "--anytime",
         "--anytime-out", str(out), "--feasibility-floor", "1.01"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"},
    )
    return result.returncode, result.stdout.strip().splitlines(), result.stderr, out


def test_the_script_prints_bench_py_s_keys_less_the_dropped_ones(run):
    _, lines, stderr, _ = run
    assert len(lines) == 1, stderr[-2000:]
    result = json.loads(lines[0])
    assert DROPPED <= bench_py_keys("result")
    assert set(result) == bench_py_keys("result") - DROPPED | ADDED
    assert set(result["anytime"]) == bench_py_keys("anytime") - {"aot_loaded"}
    assert result["p50_step_path"] == "eager" and result["device"] == "cpu"
    assert not result["captured"] and result["capture_s"] is None
    assert result["launches_per_step"] and not any(result["launches_per_step"].values())
    assert result["batch"] == 2 and result["iterations_per_solve"] == 20
    assert result["value"] == pytest.approx(result["vs_baseline"] / 7.966)
    sweep = result["feas_sweep"]
    assert sweep["seeds"] == [0, 1] and len(sweep["feasible_fractions"]) == 2
    assert sweep["min"] <= sweep["mean"] <= sweep["max"]


def test_below_the_floor_the_script_prints_its_line_then_fails(run):
    returncode, lines, stderr, _ = run
    assert returncode != 0
    result = json.loads(lines[0])
    assert result["feasibility_floor"] == 1.01 and result["feasibility_regression"] is True
    assert "below floor 1.01" in stderr


def test_the_anytime_file_holds_the_anytime_dict(run):
    _, lines, _, out = run
    written = json.loads(out.read_text())
    assert written == {**json.loads(lines[0])["anytime"], "device": "cpu",
                       "fixed_budget_iterations": 20}


def jax_anytime_formulas(batch, elapsed, iters, feas, lens, fixed_feas, fixed_lens):
    """bench.py's own expressions (`bench.py:483-503`) for the entries the
    port repairs."""
    reference = bench.REFERENCE_SOLVES_PER_S
    return {
        "vs_baseline": batch / elapsed / reference,
        "mean_length_feasible": round(float(lens[feas].mean()), 4),
        "fixed_budget_mean_length_feasible": round(float(fixed_lens[fixed_feas].mean()), 4),
    }


def anytime_input(feasible: bool):
    iters = np.array([200, 250, 250, 300], np.int32)
    feas = np.full(4, feasible)
    lens = np.array([2.5, 2.6, 2.4, 2.7], np.float32)
    return 4, 0.5, iters, feas, lens, feas, lens - 0.1


def test_anytime_gives_null_where_no_problem_is_feasible():
    inputs = anytime_input(False)
    with pytest.warns(RuntimeWarning):
        jax_values = jax_anytime_formulas(*inputs)
    assert np.isnan(jax_values["mean_length_feasible"])
    assert "NaN" in json.dumps(jax_values)  # not JSON
    got = bench.anytime_summary(*inputs)
    assert got["mean_length_feasible"] is None
    assert got["fixed_budget_mean_length_feasible"] is None
    assert got["cost_vs_fixed_budget_pct"] is None
    json.loads(json.dumps(got), parse_constant=lambda c: pytest.fail(f"{c} in the JSON"))
    feasible = bench.anytime_summary(*anytime_input(True))
    assert feasible["mean_length_feasible"] == pytest.approx(2.55)
    assert feasible["cost_vs_fixed_budget_pct"] == pytest.approx((2.55 / 2.45 - 1) * 100)


def test_anytime_vs_baseline_scales_the_reference_by_the_iterations_run():
    """Mean iterations 250 of the reference's 1000: bench.py divides by the
    reference's solves/s at 1000 iterations; the port by its solves/s at 250,
    4x as many, so its ratio is a quarter of bench.py's."""
    inputs = anytime_input(True)
    jax_ratio = jax_anytime_formulas(*inputs)["vs_baseline"]
    got = bench.anytime_summary(*inputs)
    assert got["iterations_mean"] == 250.0 and got["solves_per_s"] == 8.0
    assert got["vs_baseline"] == pytest.approx(jax_ratio * 250 / 1000)
    assert got["vs_baseline"] == pytest.approx(8.0 / (1 / 7.966 * 1000 / 250))


@pytest.mark.parametrize("path", ["bench_torch.py", "scripts/profile_step_torch.py"])
def test_no_jax_import_statements(path):
    match = FORBIDDEN.search((ROOT / path).read_text())
    assert match is None, match and match.group(0)
