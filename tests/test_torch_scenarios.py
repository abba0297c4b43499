"""The port's scenario worlds (nfopp_tpu_torch.worlds.scenarios) against the
JAX package's: every generator and the canonical endpoint resampling give
the same blocked arrays and poses exactly, the MovingAI parsers read the
same inline text (tests/test_scenarios.py:94-117), and the grid oracle of
a scenario answers as JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.worlds import grid_collision as jax_grid_collision
from nfopp_tpu.worlds import scenarios as js
from nfopp_tpu_torch.worlds import grid_collision
from nfopp_tpu_torch.worlds import scenarios as ts
from torch_threads import one_thread  # noqa: F401


MAP = """type octile
height 4
width 6
map
......
..@@..
..@@..
.....T
"""
SCEN = """version 1
0\tBerlin_0_256.map\t256\t256\t1\t2\t3\t4\t5.656854
1\tBerlin_0_256.map\t256\t256\t10\t20\t30\t40\t100.5
"""


def assert_same(got, want):
    assert got.blocked.dtype == want.blocked.dtype
    np.testing.assert_array_equal(got.blocked, want.blocked)
    assert got.resolution == want.resolution and tuple(got.origin) == tuple(want.origin)
    for a, b in ((got.start, want.start), (got.goal, want.goal)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got.bounds == want.bounds


@pytest.mark.parametrize("name,kwargs", [
    ("random_forest", dict(seed=0, size=(24, 32), obstacle_ratio=0.1)),
    ("random_forest", dict(seed=5, size=(40, 40), resolution=0.5)),
    ("corridor", dict(seed=0, size=40, branches=30, radius=3)),
    ("corridor", dict(seed=7, size=32, branches=10, radius=2, resolution=2.0)),
    ("warehouse", dict(seed=0)),
    ("warehouse", dict(seed=3, width=60.0, height=40.0, resolution=1.0)),
])
def test_generators_equal_jax(name, kwargs):
    assert_same(getattr(ts, name)(**kwargs), getattr(js, name)(**kwargs))


def test_polygon_world_and_warehouse_polygons_equal_jax():
    got, want = ts.warehouse_polygons(2), js.warehouse_polygons(2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    square = np.array([[2.0, 2.0], [6.0, 2.0], [6.0, 6.0], [2.0, 6.0]])
    hole = np.array([[3.0, 3.0], [5.0, 3.0], [5.0, 5.0], [3.0, 5.0]])
    for mode in ("union", "evenodd"):
        args = ([square, hole], (0.0, 8.0, 0.0, 8.0), 0.5, [1.0, 1.0, 0.0], [7.0, 7.0, 0.0], mode)
        assert_same(ts.polygon_world(*args), js.polygon_world(*args))
    with pytest.raises(ValueError, match="unknown mode"):
        ts.polygon_world([square], (0.0, 8.0, 0.0, 8.0), mode="xor")


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_dilate_and_random_free_pose_equal_jax(radius):
    grid = np.random.RandomState(radius).rand(20, 20) < 0.05
    np.testing.assert_array_equal(ts.dilate(grid, radius), js.dilate(grid, radius))
    scenario = ts.GridScenario(grid, 0.5, (1.0, -2.0))
    reference = js.GridScenario(grid, 0.5, (1.0, -2.0))
    a, b = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(3):
        np.testing.assert_array_equal(ts.random_free_pose(a, scenario, clearance_cells=radius),
                                      js.random_free_pose(b, reference, clearance_cells=radius))


def test_resample_distant_endpoints_equals_jax():
    """THE canonical resampling: the same poses, pose for pose, from the
    port's distance fields (tests/test_checkpoint_resume.py's small suite,
    and a goal too far to meet, where the farthest pair is kept)."""
    kw = dict(size=40, branches=30, radius=3)
    ported = [ts.corridor(seed=s, **kw) for s in range(4)]
    reference = [js.corridor(seed=s, **kw) for s in range(4)]
    for count, min_geodesic in ((4, 30.0), (1, 500.0)):
        got = ts.resample_distant_endpoints(ported[:count], min_geodesic, device="cpu")
        want = js.resample_distant_endpoints(reference[:count], min_geodesic)
        for a, b in zip(got, want):
            assert_same(a, b)
    assert ts.resample_distant_endpoints(ported, 0.0, device="cpu") is ported


def test_distant_endpoints_meet_the_geodesic_and_with_endpoints_copies():
    sc = ts.corridor(seed=0, size=40, branches=30, radius=3)
    start, goal = ts.distant_endpoints(np.random.RandomState(7), sc, 30.0, device="cpu")
    want = js.distant_endpoints(np.random.RandomState(7), js.corridor(seed=0, size=40,
                                                                      branches=30, radius=3), 30.0)
    np.testing.assert_array_equal(start, want[0])
    np.testing.assert_array_equal(goal, want[1])
    moved = ts.with_endpoints(sc, start, goal)
    assert moved.blocked is sc.blocked and np.array_equal(moved.goal, goal)


def test_movingai_parsers_equal_jax():
    got, want = ts.parse_movingai_map(MAP), js.parse_movingai_map(MAP)
    assert_same(got, want)
    assert got.blocked[1, 2] and got.blocked[3, 5] and not got.blocked[0, 0]
    assert got.bounds == (0.0, 6.0, 0.0, 4.0)
    entries = ts.parse_movingai_scen(SCEN)
    assert entries == js.parse_movingai_scen(SCEN)
    assert entries[0]["start_x"] == 1 and abs(entries[1]["optimal_length"] - 100.5) < 1e-9


@pytest.mark.parametrize("footprint", [0.0, 1.0])
def test_scenario_oracle_answers_as_jax(footprint):
    blocked = np.zeros((20, 20), bool)
    blocked[10, 10] = True
    scenario = ts.GridScenario(blocked, 0.5, (1.0, -1.0))
    oracle = scenario.oracle(footprint, device="cpu")
    assert oracle.occupancy.shape == (1, 20, 20) and oracle.resolution.shape == (1,)
    reference = js.GridScenario(blocked, 0.5, (1.0, -1.0)).oracle(footprint)
    q = np.random.RandomState(0).uniform(0.0, 12.0, (200, 3)).astype(np.float32)
    q[:, 1] -= 2.0
    got = grid_collision(oracle, torch.tensor(q)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_grid_collision(reference, jnp.asarray(q))))
    assert got.any() and not got.all()


def test_scenario_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is taken, not refused")
    scenario = ts.corridor(seed=0, size=16, branches=4, radius=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenario.oracle()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.resample_distant_endpoints([scenario], 5.0)
