"""The port's grid and polygon oracles (nfopp_tpu_torch.worlds.oracle)
against the JAX oracles: booleans bit for bit, clearance at rtol 1e-6, on
the cases of the JAX package's own oracle tests and on random queries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.worlds import oracle as jo
from nfopp_tpu.worlds import warehouse_polygons
from nfopp_tpu_torch.worlds import oracle as to

BOUNDS = np.array([0.0, 10.0, 0.0, 10.0], np.float32)


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def square(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)


L_SHAPE = np.array([[0, 0], [6, 0], [6, 3], [3, 3], [3, 6], [0, 6]], np.float64) + 1.0
TRIANGLE = np.array([[7, 7], [9, 7], [8, 9]], np.float64)

# (polygons, pad_polygons options, radius, queries, expected collisions) of
# tests/test_polygon_oracle.py:44-117
POLYGON_CASES = {
    "square": ([square(2, 2, 5, 5)], {}, 0.0,
               [[3.0, 3.0], [1.0, 1.0], [6.0, 3.0], [0.5, 3.0], [4.9, 4.9]],
               [True, False, False, False, True]),
    "concave": ([L_SHAPE], {}, 0.0, [[2.0, 5.0], [5.0, 2.0], [5.0, 5.0]], [True, True, False]),
    "padding": ([square(1, 1, 2, 2), TRIANGLE], {"capacity": 4, "max_vertices": 6}, 0.0,
                [[1.5, 1.5], [8.0, 7.5], [5.0, 5.0]], [True, True, False]),
    "out_of_bounds": ([square(2, 2, 3, 3)], {}, 0.0, [[-1.0, 5.0], [5.0, 11.0]], [True, True]),
    "se2_ignores_angle": ([square(2, 2, 5, 5)], {}, 0.0, [[3.0, 3.0, 1.2], [1.0, 1.0, -0.7]],
                          [True, False]),
    "point_robot": ([square(2, 2, 5, 5)], {}, 0.0, [[1.5, 3.5]], [False]),
    "inflated": ([square(2, 2, 5, 5)], {}, 0.6, [[1.5, 3.5]], [True]),
}


def oracles(polygons, pad, radius, bounds=BOUNDS):
    vertices, mask = to.pad_polygons(polygons, **pad)
    jax_oracle = jo.PolygonOracle(jnp.asarray(vertices), jnp.asarray(mask), jnp.float32(radius),
                                  jnp.asarray(bounds))
    oracle = to.PolygonOracle(t(vertices)[None], t(mask, torch.bool)[None], t([radius]),
                              t(bounds)[None])
    return jax_oracle, oracle


def test_pad_polygons_matches_jax():
    polys = [square(1, 1, 2, 2), TRIANGLE, L_SHAPE]
    for kwargs in ({}, {"capacity": 5, "max_vertices": 8}):
        for got, ref in zip(to.pad_polygons(polys, **kwargs), jo.pad_polygons(polys, **kwargs)):
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="exceed capacity"):
        to.pad_polygons(polys, capacity=2)
    with pytest.raises(ValueError, match="vertices"):
        to.pad_polygons(polys, max_vertices=4)


@pytest.mark.parametrize("case", sorted(POLYGON_CASES))
def test_polygon_collision_cases_match_jax(case):
    polygons, pad, radius, queries, expected = POLYGON_CASES[case]
    jax_oracle, oracle = oracles(polygons, pad, radius)
    q = np.asarray(queries, np.float32)
    got = to.polygon_collision(oracle, t(q)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jo.polygon_collision(jax_oracle, jnp.asarray(q))))
    np.testing.assert_array_equal(got, expected)


def test_polygon_clearance_exact_values():
    jax_oracle, oracle = oracles([square(2, 2, 5, 5)], {}, 0.0)
    q = np.array([[1.0, 3.5], [7.0, 7.0], [3.5, 3.5]], np.float32)
    got = to.polygon_clearance(oracle, t(q)[None])[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jo.polygon_clearance(jax_oracle, jnp.asarray(q))),
                               rtol=1e-6)
    np.testing.assert_allclose(got, [1.0, np.sqrt(8.0), 0.0], atol=1e-6)


@pytest.mark.parametrize("radius", [0.0, 0.4])
def test_polygon_oracle_on_a_warehouse_matches_jax(radius):
    """The warehouse world of tests/test_polygon_oracle.py:95-127, two
    problems with other radii and bounds, 2,000 random queries each."""
    polys = warehouse_polygons(3)
    vertices, mask = to.pad_polygons(polys)
    bounds = np.array([[0.0, 120.0, 0.0, 80.0], [5.0, 110.0, 5.0, 75.0]], np.float32)
    radii = np.array([radius, radius + 0.3], np.float32)
    rng = np.random.RandomState(0)
    q = np.stack([rng.uniform(-1.0, 121.0, (2, 2000)), rng.uniform(-1.0, 81.0, (2, 2000))],
                 axis=-1).astype(np.float32)
    oracle = to.PolygonOracle(t(vertices)[None].expand(2, -1, -1, -1),
                              t(mask, torch.bool)[None].expand(2, -1), t(radii), t(bounds))

    def jax_oracle(b):
        return jo.PolygonOracle(jnp.asarray(vertices), jnp.asarray(mask), jnp.float32(radii[b]),
                                jnp.asarray(bounds[b]))

    hits = to.polygon_collision(oracle, t(q)).numpy()
    clear = to.polygon_clearance(oracle, t(q)).numpy()
    for b in range(2):
        qb = jnp.asarray(q[b])
        np.testing.assert_array_equal(hits[b], np.asarray(jo.polygon_collision(jax_oracle(b), qb)))
        np.testing.assert_allclose(clear[b], np.asarray(jo.polygon_clearance(jax_oracle(b), qb)),
                                   rtol=1e-6)
    assert 0.05 < hits.mean() < 0.95 and (clear == 0).any() and (clear > 1).any()


def grid_oracles(occupancy, origin, resolution, bounds):
    jax_oracle = jo.GridOracle(jnp.asarray(occupancy), jnp.asarray(origin),
                               jnp.float32(resolution), jnp.asarray(bounds))
    oracle = to.GridOracle(t(occupancy, torch.bool)[None], t(origin)[None], t([resolution]),
                           t(bounds)[None])
    return jax_oracle, oracle


def test_grid_collision_case_matches_jax():
    """tests/test_oracle.py:87-94: a block covering [1, 2) x [1, 2)."""
    occ = np.zeros((30, 30), bool)
    occ[10:20, 10:20] = True
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    jax_oracle, oracle = grid_oracles(occ, [0.0, 0.0], 0.1, bounds)
    q = np.array([[1.5, 1.5], [0.5, 0.5], [1.95, 1.05], [2.05, 1.5]], np.float32)
    got = to.grid_collision(oracle, t(q)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jo.grid_collision(jax_oracle, jnp.asarray(q))))
    np.testing.assert_array_equal(got, [True, False, True, False])


def test_grid_collision_random_matches_jax():
    """Random occupancy (float, as the JAX oracle allows), an offset origin,
    queries inside, on and past the grid's edges, and SE(2) poses; two
    problems with their own grids, plus one grid shared by a batch."""
    rng = np.random.RandomState(1)
    occ = (rng.rand(2, 24, 31) > 0.7).astype(np.float32)
    origin = np.array([[-0.5, 0.25], [0.1, -0.3]], np.float32)
    res = np.array([0.13, 0.2], np.float32)
    bounds = np.array([[-0.5, 3.5, 0.0, 3.0], [0.0, 4.0, -0.3, 4.5]], np.float32)
    q = np.concatenate([rng.uniform(-1.5, 5.5, (2, 500, 2)),
                        rng.uniform(-np.pi, np.pi, (2, 500, 1))], axis=-1).astype(np.float32)
    oracle = to.GridOracle(t(occ), t(origin), t(res), t(bounds))
    got = to.grid_collision(oracle, t(q)).numpy()
    for b in range(2):
        jax_oracle = jo.GridOracle(jnp.asarray(occ[b]), jnp.asarray(origin[b]),
                                   jnp.float32(res[b]), jnp.asarray(bounds[b]))
        np.testing.assert_array_equal(got[b], np.asarray(jo.grid_collision(jax_oracle,
                                                                           jnp.asarray(q[b]))))
    assert 0.2 < got.mean() < 0.9
    shared = to.GridOracle(t(occ[:1]), t(origin[:1]), t(res[:1]), t(bounds[:1]))
    ref = jax.vmap(lambda p: jo.grid_collision(jo.GridOracle(
        jnp.asarray(occ[0]), jnp.asarray(origin[0]), jnp.float32(res[0]), jnp.asarray(bounds[0])),
        p))(jnp.asarray(q))
    np.testing.assert_array_equal(to.grid_collision(shared, t(q)).numpy(), np.asarray(ref))
