"""The port's oracles (nfopp_tpu_torch.worlds.oracle) against the JAX oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nfopp_tpu.worlds import oracle as jo
from nfopp_tpu_torch.worlds import car_environment, oracle as to
from torch_threads import one_thread  # noqa: F401


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def scene():
    pts, mask = to.pad_obstacle_points(car_environment().obstacle_points.astype(np.float32), 64)
    box = np.array([-0.3, 0.2, -0.3, 0.2], np.float32)
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    return pts, mask, box, bounds


def random_poses(seed, batch=2, m=300):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.2, 3.2, (batch, m, 2))
    theta = rng.uniform(-np.pi, np.pi, (batch, m, 1))
    return np.concatenate([xy, theta], axis=-1).astype(np.float32)


def test_pad_obstacle_points_matches_jax():
    points = car_environment().obstacle_points.astype(np.float32)
    for got, ref in zip(to.pad_obstacle_points(points, 64), jo.pad_obstacle_points(points, 64)):
        np.testing.assert_array_equal(got, ref)


def test_rectangle_collision_matches_jax():
    pts, mask, box, bounds = scene()
    poses = random_poses(0)
    ref = jax.vmap(lambda p: jo.rectangle_collision(
        jo.RectangleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(box),
                           jnp.asarray(bounds)), p))(jnp.asarray(poses))
    oracle = to.RectangleOracle(t(pts)[None], t(mask, torch.bool)[None], t(box)[None],
                                t(bounds)[None])
    got = to.rectangle_collision(oracle, t(poses))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.float().mean() < 1


def test_rectangle_edge_points_do_not_collide():
    """Strict inequalities: an obstacle exactly on the footprint's edge is free."""
    pts = np.array([[1.0, 1.0]], np.float32)
    mask = np.array([True])
    box = np.array([-0.25, 0.25, -0.5, 0.5], np.float32)
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    poses = np.array([[[0.75, 1.0, 0.0], [1.25, 1.0, 0.0], [1.0, 0.5, 0.0], [1.0, 1.5, 0.0],
                       [0.76, 1.0, 0.0], [1.0, 1.0, 0.0]]], np.float32)
    oracle = to.RectangleOracle(t(pts)[None], t(mask, torch.bool)[None], t(box)[None],
                                t(bounds)[None])
    got = to.rectangle_collision(oracle, t(poses))[0].numpy()
    ref = jo.rectangle_collision(
        jo.RectangleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(box),
                           jnp.asarray(bounds)), jnp.asarray(poses[0]))
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, [False, False, False, False, True, True])


def test_boundary_collision_matches_jax():
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    xy = np.array([[[0.0, 0.0], [3.0, 3.0], [-1e-6, 1.0], [1.0, 3.0001], [1.5, 1.5]]], np.float32)
    got = to.boundary_collision(t(bounds)[None], t(xy))
    ref = jo.boundary_collision(jnp.asarray(bounds), jnp.asarray(xy[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got[0].numpy(), [False, False, True, True, False])


def test_circle_collision_matches_jax():
    pts, mask, _, bounds = scene()
    poses = random_poses(1)
    radius = np.float32(0.3)
    ref = jax.vmap(lambda p: jo.circle_collision(
        jo.CircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(radius),
                        jnp.asarray(bounds)), p))(jnp.asarray(poses))
    oracle = to.CircleOracle(t(pts)[None], t(mask, torch.bool)[None], t([radius]),
                             t(bounds)[None])
    got = to.circle_collision(oracle, t(poses))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.float().mean() < 1
