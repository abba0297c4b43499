"""Smoke tests, on the CPU and at a few steps, of the comparison path's
scripts (scripts/run_gpmp2_torch.py, scripts/run_planner_torch.py) and of
nfopp_tpu_torch.plotting; the GPMP2 script's worlds and initial paths are
held against scripts/run_gpmp2.py's construction with the JAX package."""
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
from matplotlib import pyplot as plt  # noqa: E402

from nfopp_tpu.astar.initializer import (  # noqa: E402
    batched_wavefront_trajectories as jax_wavefront,
)
from nfopp_tpu.worlds import corridor as jax_corridor  # noqa: E402
from nfopp_tpu.worlds import resample_distant_endpoints as jax_resample  # noqa: E402
from nfopp_tpu_torch.baselines import GPMP2Config  # noqa: E402
from nfopp_tpu_torch.bench import ResultsLog  # noqa: E402
from nfopp_tpu_torch.plotting import (  # noqa: E402
    plot_collision_positions,
    plot_field_heatmap,
    plot_planner_data,
)
from torch_threads import one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def gpmp2_script():
    return load("run_gpmp2_torch")


def test_gpmp2_worlds_and_init_equal_run_gpmp2_s(gpmp2_script):
    """The corridor suite (geodesic >= 40) and the wavefront initial paths
    equal scripts/run_gpmp2.py's with the JAX package (worlds bit for bit,
    paths at rtol 1e-6)."""
    config = GPMP2Config(num_steps=30)
    scenarios = gpmp2_script.build_scenarios("corridor", 2, 40.0)
    want = jax_resample([jax_corridor(seed=s) for s in range(2)], 40.0)
    for got, ref in zip(scenarios, want):
        np.testing.assert_array_equal(got.blocked, ref.blocked)
        np.testing.assert_array_equal(got.start, ref.start)
        np.testing.assert_array_equal(got.goal, ref.goal)
    oracles, sdf, starts, goals, init_xy = gpmp2_script.prepare(scenarios, 1.0, config, CPU)
    assert sdf.values.shape == (2, 100, 100) and init_xy.shape == (2, 30, 2)
    jax_oracles = [s.oracle(1.0) for s in want]
    np.testing.assert_array_equal(oracles.occupancy.numpy(),
                                  np.stack([np.asarray(o.occupancy) for o in jax_oracles]))
    inner = jax_wavefront(
        jnp.stack([o.occupancy for o in jax_oracles]),
        jnp.asarray(np.stack([s.start for s in want])),
        jnp.asarray(np.stack([s.goal for s in want])),
        jnp.asarray(np.stack([np.asarray(s.origin, np.float32) for s in want])),
        jnp.asarray(np.asarray([s.resolution for s in want], np.float32)), config.num_steps - 2,
    )[:, :, :2]
    np.testing.assert_allclose(init_xy[:, 1:-1].numpy(), np.asarray(inner), rtol=1e-6)
    np.testing.assert_array_equal(init_xy[:, 0].numpy(), np.stack([s.start[:2] for s in want]))
    np.testing.assert_array_equal(init_xy[:, -1].numpy(), np.stack([s.goal[:2] for s in want]))


def test_gpmp2_movingai_suite_reads_the_committed_map(gpmp2_script):
    scenarios = gpmp2_script.build_scenarios("movingai", 3)
    assert len(scenarios) == 3 and scenarios[0].blocked.shape == (256, 256)
    for s in scenarios:
        assert (s.start[:2] % 1 == 0.5).all() and s.start[2] == 0.0


def test_gpmp2_script_functions_run(gpmp2_script, tmp_path):
    """prepare -> plan (3 iterations) -> evaluate -> summary on two forest
    worlds: finite states, pinned endpoints, a results log of both runs."""
    config = GPMP2Config(num_steps=40, iterations=3)
    scenarios = gpmp2_script.build_scenarios("forest", 2)
    oracles, sdf, starts, goals, init_xy = gpmp2_script.prepare(scenarios, 1.0, config, CPU)
    states, wall = gpmp2_script.plan(sdf, starts, goals, config, init_xy)
    assert states.shape == (2, 40, 4) and torch.isfinite(states).all() and wall > 0
    assert (states[:, 0, :2] - starts).abs().max() < 0.1
    assert (states[:, -1, :2] - goals).abs().max() < 0.1
    log, collides, stats = gpmp2_script.evaluate(states, scenarios, oracles, wall, "forest")
    assert collides.shape == (2,) and len(stats) == 2
    doc = ResultsLog.load(log.save(tmp_path / "g.json"))
    assert [list(r["plans"]) for r in doc["runs"]] == [["gpmp2_torch"]] * 2
    row = gpmp2_script.summary("forest", wall, collides, stats, CPU)
    assert row["problems"] == 2 and row["device"] == "cpu"
    assert row["collision_free"] == int((~collides).sum())
    paths, dense = gpmp2_script.dense_paths(states.numpy())
    assert paths.shape == (2, 40, 3) and dense.shape == (2, 500, 3)


def test_gpmp2_main_prints_its_json_line(gpmp2_script, tmp_path, monkeypatch, capsys):
    out = tmp_path / "r.json"
    monkeypatch.setattr("sys.argv", ["run_gpmp2_torch.py", "--suite", "forest", "--seeds", "1",
                                     "--device", "cpu", "--out", str(out)])
    assert gpmp2_script.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["suite"] == "forest" and line["problems"] == 1 and line["device"] == "cpu"
    assert len(ResultsLog.load(out)["runs"]) == 1


def test_gpmp2_script_refuses_a_missing_card(gpmp2_script, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr("sys.argv", ["run_gpmp2_torch.py", "--seeds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpmp2_script.main()


def test_demo_functions_run_and_render(tmp_path):
    """run_planner_torch.py: 20 steps in two chunks of 10 with a frame after
    each, the losses logged, a finite final path with pinned endpoints."""
    demo = load("run_planner_torch")
    solver, state, oracle, g = demo.build(0, CPU)
    lines = []
    state, losses, seconds = demo.run(solver, state, oracle, g, 20, show_every=10,
                                      out_dir=tmp_path / "frames", log=lines.append)
    assert [done for done, *_ in losses] == [10, 20] and len(lines) == 2
    assert all(np.isfinite(v) for _, *pair in losses for v in pair)
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == [
        "frame_0000.png", "frame_0001.png"]
    path, collides, length = demo.final_path(solver, state, oracle)
    assert path.shape == (102, 3) and np.isfinite(path).all() and length > 0
    np.testing.assert_allclose(path[0], state.start[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(path[-1], state.goal[0].numpy(), atol=1e-6)


def test_demo_main(monkeypatch, capsys):
    demo = load("run_planner_torch")
    monkeypatch.setattr("sys.argv", ["run_planner_torch.py", "--iterations", "5",
                                     "--device", "cpu"])
    assert demo.main() in (0, 1)
    out = capsys.readouterr().out
    assert "iter 5:" in out and "final path: length=" in out


def test_plot_planner_data_renders():
    """tests/test_plotting.py on the port's plotting module."""
    fig = plt.figure()
    path = np.stack([np.linspace(0, 3, 30), np.linspace(0, 2, 30), np.zeros(30)], axis=1)
    obstacles = np.random.RandomState(0).uniform(0, 3, (10, 2))

    def fake_field(queries):
        return (queries[:, :1] - 1.5) * 2.0

    ax = plot_planner_data(path, fake_field, (0, 3, 0, 3), obstacles)
    assert ax is not None
    fig.canvas.draw()
    plt.close(fig)


def test_plot_collision_positions():
    fig = plt.figure()
    positions = np.random.RandomState(1).uniform(0, 3, (20, 2))
    truth = np.random.RandomState(2).rand(20) > 0.5
    plot_collision_positions(positions, truth)
    fig.canvas.draw()
    plt.close(fig)


def test_field_heatmap_over_onf_apply():
    """The heatmap of a port field: sigmoid of onf_apply's logits on the grid."""
    from nfopp_tpu_torch.models import ONFConfig, init_onf_params, onf_apply

    cfg = ONFConfig(hidden=8, angle_harmonics=2)
    params = init_onf_params(torch.Generator().manual_seed(0), cfg, 1, CPU)

    def field(queries):
        with torch.no_grad():
            return onf_apply(params, torch.tensor(queries)[None], cfg)[0, :, 0].numpy()

    fig = plt.figure()
    im = plot_field_heatmap(field, (0, 3, 0, 3), resolution=12)
    data = np.asarray(im.get_array())
    assert data.shape == (12, 12) and ((data > 0) & (data < 1)).all()
    plt.close(fig)
