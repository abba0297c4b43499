"""The port's suite and parity scripts (scripts/compare_suites_torch.py,
shortcut_gains_torch.py, run_sweep_torch.py, two_walls_reliability_torch.py,
compare_with_reference_torch.py, compare_holonomic_torch.py) on the CPU:
each script's worlds, parameters and seeds held against its JAX
counterpart's construction, its reference glue against the port's oracles
(the reference planner's checker base class stood in for, as no checkout of
the reference is at hand), and one smoke run of each at a few steps."""
import importlib.util
import json
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.solver import run_planner_config as jax_run_planner_config
from nfopp_tpu.worlds import CircleOracle as JaxCircleOracle
from nfopp_tpu.worlds import corridor as jax_corridor
from nfopp_tpu.worlds import pad_obstacle_points as jax_pad
from nfopp_tpu.worlds import random_forest as jax_random_forest
from nfopp_tpu.worlds import two_walls_se2_environment as jax_two_walls_se2
from nfopp_tpu_torch.solver import run_planner_config
from nfopp_tpu_torch.worlds import grid_collision, polygon_collision
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def load(name):
    """scripts/<name>.py as a module (each script puts the repository and, where
    it imports a sibling, scripts/ on sys.path itself)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return {name: load(name) for name in (
        "compare_suites_torch", "compare_suites", "shortcut_gains_torch", "shortcut_gains",
        "run_sweep_torch", "two_walls_reliability_torch", "compare_with_reference_torch",
        "compare_with_reference", "compare_holonomic_torch", "compare_holonomic")}


def onf_fields(cfg):
    return {**cfg._asdict(), "onf": cfg.onf._asdict()}


# ------------------------------------------------------- compare_suites


@pytest.mark.parametrize("suite, seeds, geodesic", [
    ("corridor", 2, 40.0), ("forest", 2, 20.0), ("movingai", 3, 0.0), ("warehouse", 2, 0.0),
])
def test_compare_suites_worlds_equal_jax_s(scripts, suite, seeds, geodesic):
    """build_scenarios and the dilated grid both sides plan against equal
    compare_suites.py's bit for bit (its endpoint resampling with the JAX
    package's distance fields)."""
    got = scripts["compare_suites_torch"].build_scenarios(suite, seeds, geodesic)
    want = scripts["compare_suites"].build_scenarios(suite, seeds, geodesic)
    assert len(got) == len(want) == seeds
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.blocked, w.blocked)
        np.testing.assert_array_equal(g.start, w.start)
        np.testing.assert_array_equal(g.goal, w.goal)
        np.testing.assert_array_equal(scripts["compare_suites_torch"].dilated_blocked(g),
                                      scripts["compare_suites"].dilated_blocked(w))


@pytest.mark.parametrize("suite", ["corridor", "movingai", "warehouse"])
def test_compare_suites_parameters_equal_jax_s(scripts, suite):
    """Both sides' parameter sets: the port's (run_benchmark_torch.py's bench
    set, movingai's overrides) and the reference schema's copy."""
    ours, theirs = scripts["compare_suites_torch"], scripts["compare_suites"]
    assert ours.FOOTPRINT_RADIUS == theirs.FOOTPRINT_RADIUS
    assert json.dumps(ours.suite_parameters(suite), sort_keys=True) == json.dumps(
        theirs.suite_parameters(suite), sort_keys=True)
    ours._install_lightning_stub()
    assert json.dumps(ours._reference_parameters(suite), sort_keys=True) == json.dumps(
        theirs._reference_parameters(suite), sort_keys=True)


@pytest.fixture
def reference_stub(monkeypatch):
    """A stand-in for the reference's checker base class
    (collision_checker.py:9-18: constructed with the bounds)."""
    package = types.ModuleType("neural_field_optimal_planner")
    checker = types.ModuleType("neural_field_optimal_planner.collision_checker")

    class CollisionChecker:
        def __init__(self, boundaries):
            self.boundaries = boundaries

    checker.CollisionChecker = CollisionChecker
    package.collision_checker = checker
    monkeypatch.setitem(sys.modules, "neural_field_optimal_planner", package)
    monkeypatch.setitem(sys.modules, "neural_field_optimal_planner.collision_checker", checker)


def test_reference_checkers_agree_with_the_port_s_oracles(scripts, reference_stub):
    """The reference glue's grid checker answers as grid_collision on the
    dilated grid, and its exact polygon checker as polygon_collision, on
    random poses inside each world (the two sides plan against one world)."""
    cs = scripts["compare_suites_torch"]
    rng = np.random.RandomState(0)
    for scenario in cs.build_scenarios("corridor", 2, 0.0):
        checker = cs._make_grid_checker(cs.dilated_blocked(scenario), scenario.origin,
                                        scenario.resolution, scenario.bounds)
        xy = rng.uniform(0.0, 100.0, (2000, 3)).astype(np.float32)
        want = grid_collision(scenario.oracle(cs.FOOTPRINT_RADIUS, CPU),
                              torch.from_numpy(xy)[None])[0].numpy()
        np.testing.assert_array_equal(checker.check_collision(xy), want)
    polygons, _, singles = cs.build_exact_oracles(2, CPU)
    for polys, oracle in zip(polygons, singles):
        checker = cs._make_exact_polygon_checker(polys, cs.FOOTPRINT_RADIUS,
                                                 (0.0, 120.0, 0.0, 80.0))
        xy = np.stack([rng.uniform(0, 120, 2000), rng.uniform(0, 80, 2000),
                       np.zeros(2000)], axis=1).astype(np.float32)
        want = polygon_collision(oracle, torch.from_numpy(xy)[None])[0].numpy()
        np.testing.assert_array_equal(checker.check_collision(xy), want)


@pytest.mark.parametrize("skip, name, make, want", [
    (False, None, False, False),
    (False, "", False, False),
    (False, "missing", False, False),
    (False, "checkout", True, True),
    (True, "checkout", True, False),
])
def test_reference_path_is_only_what_nfopp_reference_names(scripts, tmp_path, monkeypatch,
                                                           skip, name, make, want):
    """The reference half runs only from the checkout $NFOPP_REFERENCE names:
    an unset or empty variable, or no directory there, skips it, and so does
    --skip-reference; no directory around the repository is looked in."""
    if name is None:
        monkeypatch.delenv("NFOPP_REFERENCE", raising=False)
    else:
        path = tmp_path / name if name else ""
        if make:
            path.mkdir()
        monkeypatch.setenv("NFOPP_REFERENCE", str(path))
    got = scripts["compare_suites_torch"].reference_path(skip)
    assert got == (str(tmp_path / name) if want else None)


def test_compare_suites_main_runs_the_port_s_side(scripts, tmp_path, monkeypatch, capsys):
    out = tmp_path / "report.json"
    monkeypatch.delenv("NFOPP_REFERENCE", raising=False)
    monkeypatch.setattr("sys.argv", [
        "compare_suites_torch.py", "--suite", "corridor", "--seeds", "2", "--iterations", "50",
        "--min-geodesic", "20", "--device", "cpu", "--json-out", str(out)])
    assert scripts["compare_suites_torch"].main() == 0
    printed = capsys.readouterr().out
    assert "ours:      feasible" in printed and "reference: skipped" in printed
    report = json.loads(out.read_text())
    assert report["seeds"] == 2 and len(report["ours_lengths"]) == 2
    assert all(np.isfinite(report["ours_lengths"])) and report["device"] == "cpu"


# ------------------------------------------------------- shortcut_gains


def test_shortcut_gains_suites_equal_jax_s(scripts):
    ours, theirs = scripts["shortcut_gains_torch"], scripts["shortcut_gains"]
    assert ours.SUITES == theirs.SUITES and ours.REF_FAIL_SEEDS == theirs.REF_FAIL_SEEDS
    assert ours.TRIALS == theirs.TRIALS
    # the committed parity artifacts the rows are held against
    for _, _, _, artifact in ours.SUITES.values():
        assert (ROOT / artifact).exists(), artifact


def test_shortcut_gains_smoke_row(scripts):
    """--smoke on the corridor parity worlds: 100-iteration solves, then the
    shortcut pass, which keeps every feasible path feasible and no longer."""
    row = scripts["shortcut_gains_torch"].suite_gains("corridor", smoke=True, device=CPU)
    assert row["seeds"] == 10 and row["iterations"] == 100
    assert row["feasible_after_shortcut"] >= row["feasible_raw"]
    assert row["feasible_after_shortcut"] - row["feasible_raw"] == row["repaired_by_shortcut"]
    if row["feasible_raw"]:
        assert row["mean_shortcut_same_set"] <= row["mean_raw_feasible"] + 1e-4
        assert row["ref_parity_artifact"] == "artifacts/parity_corridor.json"


# ------------------------------------------------------------ run_sweep


def test_sweep_worlds_and_cells_equal_jax_s(scripts):
    """run_sweep.py's worlds (the generators' own endpoints) and each cell's
    parameters (the bench set with sigma and collision weight replaced)."""
    sw = scripts["run_sweep_torch"]
    for suite, make in (("corridor", jax_corridor), ("forest", jax_random_forest)):
        for got, seed in zip(sw.sweep_scenarios(suite, 2), range(2)):
            want = make(seed=seed)
            np.testing.assert_array_equal(got.blocked, want.blocked)
            np.testing.assert_array_equal(got.start, want.start)
            np.testing.assert_array_equal(got.goal, want.goal)
    sys.path.insert(0, str(ROOT / "scripts"))
    from run_benchmark import bench_parameters

    from nfopp_tpu.utils import Config

    want = Config.from_dict(bench_parameters()).update({
        "collision_model": {"sigma": 2.5}, "planner": {"collision_weight": 50.0}},
    ).as_attribute_dict()
    assert json.dumps(sw.cell_parameters(2.5, 50.0), sort_keys=True) == json.dumps(
        want, sort_keys=True)


def test_sweep_main(scripts, tmp_path, monkeypatch):
    out = tmp_path / "sweep.json"
    monkeypatch.setattr("sys.argv", [
        "run_sweep_torch.py", "--seeds", "2", "--sigmas", "5,10", "--collision-weights", "100",
        "--max-iterations", "50", "--device", "cpu", "--out", str(out)])
    assert scripts["run_sweep_torch"].main() == 0
    rows = json.loads(out.read_text())
    assert [(r["sigma"], r["collision_weight"], r["total"]) for r in rows] == [
        (5.0, 100.0, 2), (10.0, 100.0, 2)]


# ------------------------------------------------ two_walls_reliability


def test_two_walls_scene_equals_jax_s(scripts):
    """The scene two_walls_reliability.py builds: the SE(2) two-walls
    endpoints and bounds, the disc oracle of radius 0.3, run_planner_config."""
    planner, start, goal, bounds, oracle = scripts["two_walls_reliability_torch"].scene(CPU)
    env = jax_two_walls_se2()
    pts, mask = jax_pad(env.obstacle_points.astype(np.float32), 32)
    want = JaxCircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.3),
                           jnp.asarray([0.0, 3.0, 0.0, 3.0], jnp.float32))
    for got, ref in zip(oracle, want):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(start, env.start)
    np.testing.assert_array_equal(goal, env.goal)
    np.testing.assert_array_equal(bounds, np.asarray(env.bounds, np.float32))
    assert onf_fields(planner.solver.config) == onf_fields(jax_run_planner_config())


def test_two_walls_reliability_smoke(scripts):
    result = scripts["two_walls_reliability_torch"].reliability(1, 2, 50, CPU)
    assert result["seeds"] == 1 and result["restarts"] == 2 and result["device"] == "cpu"
    assert all(0.0 <= result[k] <= 1.0 for k in ("single", "portfolio",
                                                 "portfolio_shared_field"))


def test_two_walls_rates_against_the_record(scripts):
    """Fisher's exact test of each rate against the committed JAX record
    (single 0.3, portfolio 1.0, shared 0.0 of 10): equal counts give p = 1;
    8 of 10 against 10 of 10 gives 2 C(10,2) / C(20,2) = 90/190; 3 of 10
    against 0 of 10 gives 2 C(10,3) / C(20,3) = 240/1140."""
    record = json.loads((ROOT / "artifacts" / "two_walls_reliability.json").read_text())
    result = {"seeds": 10, "single": 0.3, "portfolio": 0.8, "portfolio_shared_field": 0.3}
    p = scripts["two_walls_reliability_torch"].fisher_against_record(result, record)
    assert p["single"] == pytest.approx(1.0)
    assert p["portfolio"] == pytest.approx(90 / 190)
    assert p["portfolio_shared_field"] == pytest.approx(240 / 1140)


# ------------------------------------------------- compare_with_reference


def test_compare_with_reference_solve_and_evaluation(scripts):
    """The batched car-scene solve (run_planner_config, a few steps) gives
    finite paths with pinned endpoints, and the batched evaluation equals
    compare_with_reference.py's per-path JAX evaluation on them."""
    ours = scripts["compare_with_reference_torch"]
    assert onf_fields(run_planner_config()) == onf_fields(jax_run_planner_config())
    paths, seconds = ours.ours_run(range(3), 10, CPU)
    assert paths.shape == (3, 102, 3) and np.isfinite(paths).all() and seconds > 0
    feasible, lengths = ours.evaluate(paths, CPU)
    jax.config.update("jax_platforms", "cpu")
    want_feasible, want_lengths = scripts["compare_with_reference"].evaluate(paths)
    np.testing.assert_array_equal(feasible, want_feasible)
    np.testing.assert_allclose(lengths, want_lengths, rtol=1e-5)


def test_compare_with_reference_main(scripts, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("NFOPP_REFERENCE", str(tmp_path))
    monkeypatch.setattr("sys.argv", ["compare_with_reference_torch.py", "--seeds", "2",
                                     "--iterations", "10", "--device", "cpu",
                                     "--skip-reference"])
    assert scripts["compare_with_reference_torch"].main() == 0
    printed = capsys.readouterr().out
    assert "ours:      feasible" in printed and "reference: skipped" in printed


# ------------------------------------------------------ compare_holonomic


def test_compare_holonomic_fixture_equals_jax_s(scripts):
    """The holonomic config and the circle oracle of compare_holonomic.py,
    and the evaluation on the same paths."""
    ours, theirs = scripts["compare_holonomic_torch"], scripts["compare_holonomic"]
    assert onf_fields(ours.holonomic_config()) == onf_fields(theirs.holonomic_config())
    assert isinstance(theirs.holonomic_config().onf, JaxONFConfig)
    jax.config.update("jax_platforms", "cpu")
    for got, want in zip(ours.make_oracle(CPU), theirs.make_oracle()):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    rng = np.random.RandomState(1)
    paths = np.cumsum(rng.uniform(0.0, 0.06, (3, 102, 2)), axis=1).astype(np.float32)
    feasible, lengths = ours.evaluate(paths, CPU)
    want_feasible, want_lengths = theirs.evaluate(paths)
    np.testing.assert_array_equal(feasible, want_feasible)
    np.testing.assert_allclose(lengths, want_lengths, rtol=1e-5)


def test_compare_holonomic_main(scripts, tmp_path, monkeypatch):
    """The final-iterate, tracked and restart solves of 2 seeds at 20 steps,
    and the JSON record."""
    out = tmp_path / "holonomic.json"
    monkeypatch.delenv("NFOPP_REFERENCE", raising=False)
    monkeypatch.setattr("sys.argv", ["compare_holonomic_torch.py", "--seeds", "2",
                                     "--iterations", "20", "--device", "cpu",
                                     "--out", str(out)])
    assert scripts["compare_holonomic_torch"].main() == 0
    record = json.loads(out.read_text())
    assert record["seeds"] == 2 and record["iterations"] == 20
    assert len(record["ours_restarts"]["restarts_used"]) == 2
    for row in ("ours", "ours_tracked", "ours_restarts"):
        assert 0 <= record[row]["feasible"] <= 2
