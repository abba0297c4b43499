"""The port's grid searches (nfopp_tpu_torch.astar) against the JAX
package's: the batched wavefront distance field and greedy walk exactly
(ties included), the initial trajectories at rtol 1e-6 (JAX sums the arc
length in another order), the host A* / JPS and the host initializer
exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.astar import grid_search as jax_grid_search
from nfopp_tpu.astar import initializer as jax_initializer
from nfopp_tpu.astar import wavefront as jax_wavefront
from nfopp_tpu.worlds import scenarios as jax_scenarios
from nfopp_tpu_torch.astar import (
    AstarTrajectoryInitializer,
    GridSearch,
    astar,
    batched_wavefront_trajectories,
    distance_field,
    extract_path,
    jump_point_search,
    wavefront_path,
)
from nfopp_tpu_torch.astar.wavefront import _INF
from torch_threads import one_thread  # noqa: F401


def random_grids(seed, batch, h, w, density=0.3):
    rng = np.random.RandomState(seed)
    blocked = rng.rand(batch, h, w) < density
    cells = lambda: np.stack([rng.randint(0, h, batch), rng.randint(0, w, batch)], 1)  # noqa: E731
    return blocked, cells(), cells()


def jax_fields(blocked, goals):
    return np.stack([np.asarray(jax_wavefront.distance_field(jnp.asarray(b), jnp.asarray(g)))
                     for b, g in zip(blocked, goals)])


@pytest.mark.parametrize("seed,h,w", [(0, 16, 16), (1, 32, 24), (2, 9, 31)])
def test_distance_field_equals_jax_bit_for_bit(seed, h, w):
    blocked, goals, _ = random_grids(seed, 3, h, w)
    blocked[0, goals[0, 0], goals[0, 1]] = True  # a blocked goal keeps its zero
    got = distance_field(torch.tensor(blocked), torch.tensor(goals)).numpy()
    want = jax_fields(blocked, goals)
    np.testing.assert_array_equal(got, want)
    assert (got > 1e30).any() and (got < 1e30).any()  # unreachable cells hold the sentinel
    assert got.max() == np.float32(_INF)


def test_distance_field_goal_outside_the_grid_sets_nothing():
    blocked = np.zeros((1, 8, 8), bool)
    goal = np.array([[8, 3]])
    got = distance_field(torch.tensor(blocked), torch.tensor(goal)).numpy()
    want = np.asarray(jax_wavefront.distance_field(jnp.asarray(blocked[0]), jnp.asarray(goal[0])))
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("seed,h,w", [(3, 16, 16), (4, 32, 24)])
def test_extract_path_equals_jax(seed, h, w):
    blocked, goals, starts = random_grids(seed, 3, h, w, density=0.2)
    dist = distance_field(torch.tensor(blocked), torch.tensor(goals))
    cells, valid = extract_path(dist, torch.tensor(starts))
    for b in range(3):
        want_cells, want_valid = jax_wavefront.extract_path(jnp.asarray(dist[b].numpy()),
                                                            jnp.asarray(starts[b]))
        np.testing.assert_array_equal(cells[b].numpy(), np.asarray(want_cells))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(want_valid))
    assert cells.dtype == torch.int32


def test_extract_path_takes_the_first_of_tied_neighbours():
    """A wall with two symmetric gaps: the start's two diagonal neighbours
    towards the gaps lie at the same distance, and both walks take the
    first in the neighbour order (up)."""
    blocked = np.zeros((1, 7, 9), bool)
    blocked[0, 1:6, 4] = True  # gaps at rows 0 and 6
    start, goal = np.array([[3, 2]]), np.array([[3, 6]])
    dist = distance_field(torch.tensor(blocked), torch.tensor(goal))
    d = dist[0].numpy()
    assert d[2, 3] == d[4, 3]  # the tie
    cells, _ = extract_path(dist, torch.tensor(start))
    want, _ = jax_wavefront.extract_path(jnp.asarray(d), jnp.asarray(start[0]))
    np.testing.assert_array_equal(cells[0].numpy(), np.asarray(want))
    assert tuple(cells[0, 1].tolist()) == (2, 3)


def test_wavefront_path_matches_jax():
    blocked, goals, starts = random_grids(5, 2, 20, 20, density=0.1)
    origin = np.array([[-3.0, 1.5], [0.25, -7.0]], np.float32)
    res = np.array([0.5, 2.0], np.float32)
    got = wavefront_path(torch.tensor(blocked), torch.tensor(starts), torch.tensor(goals), 30,
                         torch.tensor(origin), torch.tensor(res)).numpy()
    for b in range(2):
        want = jax_wavefront.wavefront_path(jnp.asarray(blocked[b]), jnp.asarray(starts[b]),
                                            jnp.asarray(goals[b]), 30, jnp.asarray(origin[b]),
                                            jnp.asarray(res[b]))
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("origin,resolution", [((0.0, 0.0), 1.0), ((-5.3, -2.7), 0.5)])
def test_batched_wavefront_trajectories_match_jax(origin, resolution):
    """Corridor worlds, dilated as the suite does; a negative origin puts
    the floor division of cell indices on negative offsets."""
    scenarios = [jax_scenarios.corridor(seed=s, size=32, branches=20, radius=2) for s in range(4)]
    blocked = np.stack([jax_scenarios.dilate(s.blocked, 1) for s in scenarios])
    shift = np.array([*origin, 0.0], np.float32)
    starts = np.stack([s.start * [resolution, resolution, 1.0] + shift for s in scenarios])
    goals = np.stack([s.goal * [resolution, resolution, 1.0] + shift for s in scenarios])
    starts, goals = starts.astype(np.float32), goals.astype(np.float32)
    goals[0, 2] = starts[0, 2] + 3.5  # the wrapped angle delta
    origins = np.tile(np.asarray(origin, np.float32), (4, 1))
    res = np.full(4, resolution, np.float32)
    want = np.asarray(jax_initializer.batched_wavefront_trajectories(
        jnp.asarray(blocked), jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(origins),
        jnp.asarray(res), 24))
    got = batched_wavefront_trajectories(
        torch.tensor(blocked), torch.tensor(starts), torch.tensor(goals), torch.tensor(origins),
        torch.tensor(res), 24).numpy()
    assert got.shape == (4, 24, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("jps", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_search_paths_equal_jax(jps, seed):
    rng = np.random.RandomState(seed)
    blocked = rng.rand(24, 24) < 0.25
    blocked[0, 0] = blocked[23, 23] = False
    search = GridSearch(blocked, jps=jps)
    reference = jax_grid_search.GridSearch(blocked, jps=jps)
    try:
        want = reference.find_path((0, 0), (23, 23))
    except ValueError:
        with pytest.raises(ValueError):
            search.find_path((0, 0), (23, 23))
        return
    np.testing.assert_array_equal(search.find_path((0, 0), (23, 23)), want)
    assert search.expanded == reference.expanded
    fn = jump_point_search if jps else astar
    np.testing.assert_array_equal(fn(blocked, (0, 0), (23, 23)), want)


def test_grid_search_refuses_blocked_endpoints_and_walled_goals():
    blocked = np.zeros((6, 6), bool)
    blocked[:, 3] = True
    with pytest.raises(ValueError, match="no path"):
        astar(blocked, (0, 0), (0, 5))
    with pytest.raises(ValueError, match="blocked"):
        astar(blocked, (0, 3), (0, 5))


@pytest.mark.parametrize("blend", [False, True])
def test_host_initializer_equals_jax(blend):
    def collides(poses):
        x, y = poses[:, 0], poses[:, 1]
        return ((x > 4.0) & (x < 5.0) & (y < 7.0)) | (x < 0) | (y < 0)

    args = (collides, (0.0, 10.0, 0.0, 10.0), 0.5, blend)
    start = np.array([1.0, 1.0, 0.3], np.float32)
    goal = np.array([9.0, 2.0, -2.9], np.float32)
    got = AstarTrajectoryInitializer(*args).initial_trajectory(start, goal, 20)
    want = jax_initializer.AstarTrajectoryInitializer(*args).initial_trajectory(start, goal, 20)
    np.testing.assert_array_equal(got, want)
