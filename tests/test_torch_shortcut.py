"""The port's random-pair shortcutting (nfopp_tpu_torch.ops.shortcut)
against the JAX package's, with JAX's (i, j) draws replayed: the same
output paths (atol 1e-6) and the same accepted and rejected trials. JAX's
trials are read from a mirror of its trial body (ops/shortcut.py:67-83)
that is first shown to reproduce JAX's `shortcut_batch` (to f32 rounding:
jit may fuse the chord's multiply-add). Then the contract of
tests/test_shortcut.py on the port's own draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.ops import shortcut as jax_shortcut
from nfopp_tpu.ops.math import wrap_angle as jax_wrap_angle
from nfopp_tpu.worlds import GridOracle as JaxGridOracle
from nfopp_tpu.worlds import grid_collision as jax_grid_collision
from nfopp_tpu_torch.ops.shortcut import (
    shortcut_batch,
    shortcut_pairs,
    shortcut_path,
    shortcut_trial,
)
from nfopp_tpu_torch.solver.tracking import evaluate_path
from nfopp_tpu_torch.worlds import GridOracle, grid_collision
from torch_threads import one_thread  # noqa: F401


TRIALS, SAMPLES = 24, 5


def world():
    """16x16 grid, one wall with a gap (tests/test_runner.py::wall_scenario)."""
    blocked = np.zeros((16, 16), bool)
    blocked[3:13, 8] = True
    blocked[7:9, 8] = False
    return blocked


def paths():
    """Three SE(2) paths of 30 points through the gap (x in [8, 9), y in
    [7, 9)): a wide zigzag detour, a wiggle whose angles wrap across +-pi,
    and one that cuts through the wall (an infeasible path, which a chord
    may or may not repair)."""
    t = np.linspace(0.0, 1.0, 30, dtype=np.float32)
    x = 2.0 + 12.0 * t
    detour = np.stack([np.interp(t, [0, 0.25, 0.5, 0.75, 1], [2, 5, 8.5, 11, 14]),
                       np.interp(t, [0, 0.25, 0.5, 0.75, 1], [8, 13, 8, 3, 8]), 0.5 * t], axis=1)
    wiggle = np.stack([x, 8.0 + 0.5 * np.sin(3 * np.pi * t), 3.0 - 6.2 * t], axis=1)
    through = np.stack([x, 8.0 - 5.0 * np.sin(np.pi * t), np.zeros_like(t)], axis=1)
    return np.stack([detour, wiggle, through]).astype(np.float32)


def jax_pairs(key, batch, m):
    """JAX's draws: problem b's trials come from split(split(key, B)[b], T),
    each trial splitting its key for i ~ randint(0, m-2), j ~ randint(i+2, m)."""
    pairs = np.zeros((TRIALS, batch, 2), np.int64)
    for b, problem_key in enumerate(jax.random.split(key, batch)):
        for t, trial_key in enumerate(jax.random.split(problem_key, TRIALS)):
            k1, k2 = jax.random.split(trial_key)
            i = jax.random.randint(k1, (), 0, m - 2)
            pairs[t, b] = int(i), int(jax.random.randint(k2, (), i + 2, m))
    return pairs


def jax_trial(oracle, p, i, j):
    """One JAX trial (the body of ops/shortcut.py::shortcut_path)."""
    m = p.shape[0]
    idx = jnp.arange(m)
    a, b = p[i], p[j]
    delta = (b - a).at[2].set(jax_wrap_angle(b[2] - a[2]))
    t = jnp.clip((idx - i) / (j - i), 0.0, 1.0).astype(p.dtype)[:, None]
    cand = jnp.where(((idx > i) & (idx < j))[:, None], a[None] + t * delta[None], p)
    collides = jax_shortcut._dense_collides(jax_grid_collision, oracle, cand, SAMPLES)
    return jnp.where(collides, p, cand), ~collides


@pytest.fixture(scope="module")
def case():
    blocked, start = world(), paths()
    bounds = np.array([0.0, 16.0, 0.0, 16.0], np.float32)
    jax_oracle = JaxGridOracle(jnp.asarray(blocked), jnp.zeros(2), jnp.float32(1.0),
                               jnp.asarray(bounds))
    batch = start.shape[0]
    oracle = GridOracle(torch.tensor(blocked)[None].expand(batch, -1, -1), torch.zeros(batch, 2),
                        torch.ones(batch), torch.tensor(bounds)[None].expand(batch, -1))
    key = jax.random.PRNGKey(3)
    pairs = jax_pairs(key, batch, start.shape[1])
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x] * batch), jax_oracle)
    out = np.asarray(jax_shortcut.shortcut_batch(jax_grid_collision, stacked,
                                                 jnp.asarray(start), key, TRIALS, SAMPLES))
    # JAX's trials, one by one, through the mirror of its trial body
    current, accepted = [jnp.asarray(p) for p in start], np.zeros((TRIALS, batch), bool)
    for t in range(TRIALS):
        for b in range(batch):
            current[b], ok = jax_trial(jax_oracle, current[b], *pairs[t, b])
            accepted[t, b] = bool(ok)
    mirror = np.stack([np.asarray(p) for p in current])
    return dict(start=start, oracle=oracle, pairs=pairs, out=out, mirror=mirror,
                accepted=accepted)


def test_mirror_reproduces_jax_shortcut_batch(case):
    # jit may fuse the chord's multiply-add: equal to f32 rounding
    np.testing.assert_allclose(case["mirror"], case["out"], rtol=0, atol=1e-6)
    assert case["accepted"].any() and not case["accepted"].all()


def test_shortcut_batch_with_jax_draws_matches(case):
    got = shortcut_batch(grid_collision, case["oracle"], torch.tensor(case["start"]),
                         torch.tensor(case["pairs"]), TRIALS, SAMPLES).numpy()
    np.testing.assert_allclose(got, case["out"], rtol=0, atol=1e-6)


def test_same_trials_accepted_and_rejected(case):
    current = torch.tensor(case["start"])
    for t in range(TRIALS):
        current, accepted = shortcut_trial(grid_collision, case["oracle"], current,
                                           torch.tensor(case["pairs"][t]), SAMPLES)
        np.testing.assert_array_equal(accepted.numpy(), case["accepted"][t], err_msg=f"trial {t}")


def test_shortcut_path_is_one_row_of_the_batch(case):
    one = tuple(leaf[:1] for leaf in case["oracle"])
    got = shortcut_path(grid_collision, type(case["oracle"])(*one),
                        torch.tensor(case["start"][0]), torch.tensor(case["pairs"][:, :1]),
                        TRIALS, SAMPLES)
    np.testing.assert_allclose(got.numpy(), case["out"][0], rtol=0, atol=1e-6)


def test_pairs_refused_at_the_wrong_shape(case):
    with pytest.raises(ValueError, match="pairs of shape"):
        shortcut_batch(grid_collision, case["oracle"], torch.tensor(case["start"]),
                       torch.tensor(case["pairs"][:-1]), TRIALS, SAMPLES)


def test_drawn_pairs_cover_their_ranges():
    pairs = shortcut_pairs(torch.Generator().manual_seed(0), 4000, 2, 7, "cpu")
    i, j = pairs[..., 0], pairs[..., 1]
    assert pairs.shape == (4000, 2, 2)
    assert sorted(i.unique().tolist()) == [0, 1, 2, 3, 4]
    assert bool((j >= i + 2).all()) and bool((j <= 6).all()) and int(j.max()) == 6


def test_shortcut_with_generator_shortens_keeps_feasibility_and_endpoints(case):
    """tests/test_shortcut.py's contract: a feasible path stays feasible
    and gets no longer; endpoints never move; a path stays infeasible or
    is repaired, and the evaluator says which."""
    start = torch.tensor(case["start"])
    collides0, length0 = evaluate_path(grid_collision, case["oracle"], start, SAMPLES)
    out = shortcut_batch(grid_collision, case["oracle"], start, torch.Generator().manual_seed(1),
                         64, SAMPLES)
    collides1, length1 = evaluate_path(grid_collision, case["oracle"], out, SAMPLES)
    assert not collides0[0] and not collides0[1] and collides0[2]
    assert not bool((collides1 & ~collides0).any())
    assert bool((length1[~collides0] <= length0[~collides0] + 1e-5).all())
    assert float(length1[0]) < 0.9 * float(length0[0])
    np.testing.assert_array_equal(out[:, 0].numpy(), case["start"][:, 0])
    np.testing.assert_array_equal(out[:, -1].numpy(), case["start"][:, -1])
