"""The port's results analysis (nfopp_tpu_torch.bench.analysis) against the
JAX package's (nfopp_tpu.bench.analysis) on the same files, on the CPU:
load, merge, the metric samples, the aggregation and the table are equal;
the plots render where matplotlib imports; and the analysis CLI
(scripts/analyze_results_torch.py) prints JAX's table."""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

from nfopp_tpu.bench import analysis as jax_analysis
from nfopp_tpu_torch.bench import analysis
from nfopp_tpu_torch.bench.metrics import PathStatistics
from nfopp_tpu_torch.bench.results import ResultsLog, grid_environment_info
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def make_doc(tmp_path, name, planner, lengths, collides_flags, clearing=2.0):
    """tests/test_analysis.py::make_doc, written by the port's ResultsLog."""
    rng = np.random.RandomState(0)
    blocked = rng.rand(12, 12) > 0.8
    log = ResultsLog(settings={"nfomp": {"trajectory_length": 10}})
    for i, (length, collides) in enumerate(zip(lengths, collides_flags)):
        path = np.stack(
            [np.linspace(0, length / np.sqrt(2), 11),
             np.linspace(0, length / np.sqrt(2), 11),
             np.zeros(11)], axis=1)
        stats = PathStatistics(
            planner=planner, path_found=not collides, path_collides=collides,
            planning_time=0.5 + 0.1 * i, path_length=length,
            max_curvature=0.3 + 0.05 * i, normalized_curvature=1.1, aol=0.2,
            smoothness=0.05 * (i + 1), mean_clearing_distance=clearing, cusps=i % 2,
        )
        log.log_run(
            planner, path, stats, extra={"seed_index": i},
            environment=grid_environment_info(
                blocked, 1.0, (0.0, 0.0), path[0], path[-1]),
        )
    out = tmp_path / name
    log.save(out)
    return out


@pytest.fixture
def files(tmp_path):
    return [
        make_doc(tmp_path, "a.json", "nfopp_tpu", [10.0, 12.0, 9.5], [False, False, False]),
        make_doc(tmp_path, "b.json", "gpmp2", [11.0, 15.0, 13.0], [False, True, False],
                 clearing=float("nan")),
    ]


def test_load_and_merge_equal_jax(files, tmp_path):
    assert analysis.load_results(files) == jax_analysis.load_results(files)
    got = analysis.merge_results(files, tmp_path / "out" / "merged.json")
    want = jax_analysis.merge_results(files, tmp_path / "jax_merged.json")
    assert got.read_text() == want.read_text()
    assert len(json.loads(got.read_text())["runs"]) == 6


@pytest.mark.parametrize("metrics", [None, ["path_length", "smoothness", "cusps"]])
def test_aggregate_and_table_equal_jax(files, metrics):
    doc = analysis.load_results(files)
    assert analysis.collect_metric_samples(doc) == jax_analysis.collect_metric_samples(doc)
    got = analysis.aggregate_stats(doc, metrics)
    assert got == jax_analysis.aggregate_stats(doc, metrics)
    table = analysis.format_stats_table(got, metrics)
    assert table == jax_analysis.format_stats_table(got, metrics)
    # tests/test_analysis.py's holds
    assert set(got) == {"nfopp_tpu", "gpmp2"}
    assert got["nfopp_tpu"]["path_length"]["mean"] == pytest.approx(31.5 / 3)
    assert got["gpmp2"]["path_found"]["mean"] == pytest.approx(2 / 3)
    assert "found: 67%" in table and "path_length" in table
    assert "mean_clearing_distance" not in got["gpmp2"]  # NaN samples are dropped


def test_table_of_an_empty_document_equals_jax():
    assert analysis.format_stats_table(analysis.aggregate_stats({"runs": []})) == \
        jax_analysis.format_stats_table(jax_analysis.aggregate_stats({"runs": []})) == ""


def test_plots_render(files, tmp_path):
    pytest.importorskip("matplotlib")
    doc = analysis.load_results(files)
    stats_png = analysis.plot_planner_stats(doc, tmp_path / "stats.png")
    traj_png = analysis.plot_trajectories(doc, tmp_path / "traj.png", max_runs=4,
                                          planner="gpmp2")
    rows = [{"sigma": s, "collision_weight": w, "feasible": f, "total": 4,
             "mean_feasible_length": ln}
            for s, w, f, ln in [(2.5, 50.0, 4, 30.0), (5.0, 50.0, 0, float("nan"))]]
    sweep_png = analysis.plot_sweep(rows, tmp_path / "sweep.png", title="t")
    for png in (stats_png, traj_png, sweep_png):
        assert png.stat().st_size > 1000
    with pytest.raises(ValueError):
        analysis.plot_trajectories({"runs": []}, tmp_path / "x.png")
    with pytest.raises(ValueError):
        analysis.plot_planner_stats(doc, tmp_path / "y.png", metrics=["no_such_metric"])


def load_cli():
    spec = importlib.util.spec_from_file_location(
        "analyze_results_torch", ROOT / "scripts" / "analyze_results_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_cli_prints_jax_s_table(files, tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    cli = load_cli()
    doc, table = cli.table(files)
    assert table == jax_analysis.format_stats_table(
        jax_analysis.aggregate_stats(jax_analysis.load_results(files)))
    monkeypatch.setattr("sys.argv", ["analyze_results_torch.py", *map(str, files),
                                     "--merge", str(tmp_path / "m.json"),
                                     "--plot", str(tmp_path / "p.png"),
                                     "--trajectories", str(tmp_path / "t.png"),
                                     "--max-runs", "2"])
    assert cli.main() == 0
    out = capsys.readouterr().out
    assert table in out and "merged 2 file(s), 6 runs" in out
    assert (tmp_path / "p.png").stat().st_size > 1000
    assert (tmp_path / "t.png").stat().st_size > 1000


def test_the_cli_refuses_plots_without_matplotlib(files, tmp_path, monkeypatch):
    """Where matplotlib does not import, a plot flag is
    refused before any work; the table needs no matplotlib."""
    cli = load_cli()
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    monkeypatch.setattr("sys.argv", ["analyze_results_torch.py", *map(str, files),
                                     "--plot", str(tmp_path / "p.png")])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert exc.value.code == 2 and not (tmp_path / "p.png").exists()
