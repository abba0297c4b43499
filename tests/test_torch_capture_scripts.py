"""The eleventh slice's scripts on the CPU at tiny sizes: the one-card
profiling scripts (profile_step2, profile_kernels, bench_grouped,
profile_grouped) print their JSON object; --aot of run_benchmark_torch,
replan_latency_torch and dynamic_replan_demo_torch's sessions lists the
programs it resolved (the demo's sessions equal their eager runs); and
make_city_map_torch is held against the JAX script: its grid equals
`city_grid` at seed 0 and the committed assets/movingai/city_0_256.map, its
first two .scen lines equal the JAX script's, and its whole .scen equals
the committed one. No script imports JAX."""
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ("profile_step2_torch", "profile_kernels_torch", "bench_grouped_torch",
           "profile_grouped_torch", "make_city_map_torch")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|flax|nfopp_tpu)(\.|\s|$)", re.M)


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_script(name: str, *args: str) -> dict:
    """The script's last stdout line as JSON (a run on the CPU, one thread)."""
    result = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / f"{name}.py"), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"},
    )
    assert result.returncode == 0, result.stderr[-2000:]
    return json.loads(result.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", SCRIPTS)
def test_no_jax_import_statements(name):
    match = FORBIDDEN.search((ROOT / "scripts" / f"{name}.py").read_text())
    assert match is None, match and match.group(0)


def test_profile_step2_prints_each_part_eager_and_captured():
    out = run_script("profile_step2_torch", "--batch", "2", "--steps", "1")
    assert out["metric"] == "step_parts_ms" and out["device"] == "cpu"
    assert set(out["parts"]) == {
        "field sampling", "oracle labels", "field loss and gradient", "field Adam",
        "trajectory update", "reparametrization", "full step (no reparametrization)"}
    for part in out["parts"].values():
        for mode in ("eager", "captured"):
            assert part[mode]["host_ms"] > 0 and part[mode]["device_ms"] is None


def test_profile_kernels_times_every_plain_twin():
    out = run_script("profile_kernels_torch", "--batch", "2", "--m", "6", "--iters", "1")
    assert (out["batch"], out["m"]) == (2, 6)
    assert set(out["kernels"]) == {
        "onf_forward", "onf_forward_bf16", "onf_multi_bf16", "field_grad", "field_grad_bf16",
        "field_grad_multi", "field_grad_multi_bf16", "collision_fwd", "collision_fwd_bf16",
        "collision_bwd", "collision_bwd_bf16"}
    assert all(k["plain_host_ms"] > 0 for k in out["kernels"].values())


def test_bench_grouped_eager_and_aot():
    args = ("--batch", "4", "--groups", "2", "4", "--chunk", "10", "--chunks", "1")
    eager = run_script("bench_grouped_torch", *args)
    captured = run_script("bench_grouped_torch", *args, "--aot")
    assert set(eager["us_per_step_per_problem"]) == {"plain", "grouped_2", "grouped_4"}
    assert not eager["captured"] and "aot_events" not in eager
    assert [e["program"] for e in captured["aot_events"]] == ["chunk-b4", "chunk-b4-g2",
                                                               "chunk-b4-g4"]


def test_profile_grouped_components():
    out = run_script("profile_grouped_torch", "--sizes", "2", "--steps", "1", "--aot")
    (row,) = out["sizes"]
    assert row["robots"] == 2 and len(row["components"]) == 8
    for component in row["components"].values():
        assert set(component) == {"eager", "captured"}
        assert component["eager"]["host_us_per_step_per_robot"] > 0


def test_replan_latency_and_run_benchmark_list_their_programs(tmp_path):
    out = run_script("replan_latency_torch", "--session", "--goals", "1", "--cycles-per-goal", "1",
                     "--steps-per-cycle", "10", "--aot")
    assert out["aot_events"] == [{"program": "chunk-b1", "loaded": False, "seconds": 0.0}]
    result = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "run_benchmark_torch.py"), "--suite", "corridor",
         "--seeds", "2", "--min-geodesic", "40", "--max-iterations", "40", "--min-iterations",
         "20", "--device", "cpu", "--aot", "--out", str(tmp_path / "r.json"), "--nfomp",
         json.dumps({"trajectory_length": 24, "planner": {"init_collision_iteration": 10}})],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert result.returncode == 0, result.stderr[-2000:]
    assert "programs: 0/2 taken from the store" in result.stdout
    log = json.loads((tmp_path / "r.json").read_text())
    events = log["runs"][0]["settings"]["suite"]["aot_events"]
    assert [e["program"] for e in events] == ["pretrain-b2", "chunk-b2"]


@pytest.mark.parametrize("fleet", ["1", "2"])
def test_dynamic_demo_session_aot_equals_the_eager_session(fleet, tmp_path):
    """dynamic_replan_demo_torch.py --session --aot: the session's init
    pretrains through its program and its bursts replay the chunk program
    (grouped for a fleet); on the CPU the session equals the eager one."""
    def session(*flags):
        out = tmp_path / "session.json"
        result = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "dynamic_replan_demo_torch.py"), "--device",
             "cpu", "--session", "--session-cycles", "3", "--steps-per-cycle", "10", "--fleet",
             fleet, "--out", str(out), *flags],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
        assert result.returncode == 0, result.stderr[-2000:]
        return json.loads(out.read_text())

    eager, captured = session(), session("--aot")
    assert "aot_events" not in eager
    chunk = "chunk-b1" if fleet == "1" else "chunk-b2-g2"
    pretrain = "pretrain-b1" + ("" if fleet == "1" else "-g2")
    assert [e["program"] for e in captured.pop("aot_events")] == [pretrain, chunk]
    for key in ("robots_reached_goal", "collided", "min_clearance_while_active"):
        assert captured[key] == eager[key], key


def test_city_map_grid_equals_jax_and_the_committed_map():
    port, jax_script = load("make_city_map_torch"), load("make_city_map")
    blocked = port.city_grid(0)
    np.testing.assert_array_equal(blocked, jax_script.city_grid(0))
    rows = (ROOT / "assets" / "movingai" / "city_0_256.map").read_text().splitlines()[4:]
    np.testing.assert_array_equal(blocked, np.array([[c == "@" for c in r] for r in rows]))


def test_city_scen_equals_jax_and_the_committed_scen():
    port, jax_script = load("make_city_map_torch"), load("make_city_map")
    blocked = port.city_grid(0)
    jax_lines = jax_script.make_scen_entries(blocked, "city_0_256.map", 2, 0)
    port_lines = port.make_scen_entries(blocked, "city_0_256.map", 20, 0, "cpu")
    assert port_lines[:2] == jax_lines
    committed = (ROOT / "assets" / "movingai" / "city_0_256.map.scen").read_text().splitlines()
    assert committed[0] == "version 1" and port_lines == committed[1:]


def test_city_map_script_writes_both_files(tmp_path):
    out = run_script("make_city_map_torch", "--out", str(tmp_path), "--scens", "2")
    assert out["scenarios"] == 2 and abs(out["free_percent"] - 47.05810546875) < 1e-9
    committed = (ROOT / "assets" / "movingai" / "city_0_256.map").read_text()
    assert (tmp_path / "city_0_256.map").read_text() == committed
    scen = (tmp_path / "city_0_256.map.scen").read_text().splitlines()
    assert scen == (ROOT / "assets" / "movingai" / "city_0_256.map.scen").read_text() \
        .splitlines()[:3]
