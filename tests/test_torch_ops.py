"""The port's batched ops (nfopp_tpu_torch.ops) against the JAX ops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.ops import losses as jl
from nfopp_tpu.ops import math as jm
from nfopp_tpu.ops import reparametrize as jr
from nfopp_tpu.ops import sampling as js
from nfopp_tpu_torch.ops import losses as tl
from nfopp_tpu_torch.ops import math as tm
from nfopp_tpu_torch.ops import reparametrize as tr
from nfopp_tpu_torch.ops import sampling as ts
from torch_threads import one_thread  # noqa: F401


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def make_path(seed, n=20, batch=3):
    """[B, n, 3] paths with random steps and headings (angle jumps > pi)."""
    rng = np.random.RandomState(seed)
    steps = rng.uniform(0.05, 0.8, (batch, n - 1, 3))
    path = np.concatenate([np.zeros((batch, 1, 3)), np.cumsum(steps, axis=1)], axis=1)
    path[..., 2] = rng.uniform(-np.pi, np.pi, (batch, n)) * 1.5
    return path.astype(np.float32)


def test_wrap_angle_floor_mod():
    angles = np.array(
        [-100.0, -7.5, -4.0, -np.pi, -3.0, -0.1, 0.0, 0.1, 3.0, np.pi, 4.0, 9.9, 100.0],
        np.float32,
    )
    got = tm.wrap_angle(t(angles)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.wrap_angle(jnp.asarray(angles))), atol=1e-6)
    assert (got >= -np.pi - 1e-6).all() and (got < np.pi + 1e-6).all()
    # a floor-mod: negative inputs land in range, not at fmod's negative remainder
    floor_mod = np.mod(angles.astype(np.float64) + np.pi, 2 * np.pi) - np.pi
    inner = np.abs(np.abs(angles) - np.pi) > 1e-3  # +-pi itself may round to either end
    np.testing.assert_allclose(got[inner], floor_mod[inner], atol=1e-4)


@pytest.mark.parametrize("beta", [1.0, 10.0])
def test_softplus_beta_both_sides_of_threshold(beta):
    x = np.concatenate([
        np.linspace(-30.0, 30.0, 61), np.array([19.0, 19.999, 20.0, 20.001, 21.0]) / beta,
    ]).astype(np.float32)
    got = tl.softplus_beta(t(x), beta).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.softplus_beta(jnp.asarray(x), beta)),
                               rtol=1e-6, atol=1e-6)
    linear = beta * x > 20.0
    np.testing.assert_array_equal(got[linear], x[linear])


def test_bce_with_logits():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 17).astype(np.float32) * 5
    truth = (rng.rand(3, 17) > 0.5).astype(np.float32)
    expected = jax.vmap(jl.bce_with_logits)(jnp.asarray(logits), jnp.asarray(truth))
    np.testing.assert_allclose(tl.bce_with_logits(t(logits), t(truth)).numpy(),
                               np.asarray(expected), rtol=1e-6)


def test_distance_loss_se2_value_and_grad():
    """Value and gradient vs jax.grad: the detach sits where stop_gradient is."""
    full = make_path(1, n=12)
    weight = 0.5
    ref_val, ref_grad = jax.vmap(jax.value_and_grad(lambda p: jl.distance_loss_se2(p, weight)))(
        jnp.asarray(full))
    x = t(full).requires_grad_(True)
    val = tl.distance_loss_se2(x, weight)
    (grad,) = torch.autograd.grad(val.sum(), x)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(ref_val), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-5)


def test_constraint_deltas_and_boundary_loss():
    full = make_path(2, n=15)
    bounds = np.array([[0.5, 3.0, 0.2, 2.5]] * 3, np.float32)
    for jfn, tfn in [
        (jl.non_holonomic_constraint_deltas, tl.non_holonomic_constraint_deltas),
        (jl.direction_constraint_deltas, tl.direction_constraint_deltas),
    ]:
        np.testing.assert_allclose(tfn(t(full)).numpy(), np.asarray(jax.vmap(jfn)(jnp.asarray(full))),
                                   rtol=1e-5, atol=1e-5)
    expected = jax.vmap(jl.boundary_loss)(jnp.asarray(full), jnp.asarray(bounds))
    np.testing.assert_allclose(tl.boundary_loss(t(full), t(bounds)).numpy(), np.asarray(expected),
                               rtol=1e-5)


def test_linspace_and_dense_path():
    start, stop = np.array([0.5, -1.0], np.float32), np.array([2.0, 3.3], np.float32)
    expected = np.stack([np.asarray(jnp.linspace(a, b, 102)) for a, b in zip(start, stop)])
    # same formula; XLA may contract it into FMAs, so equal to rounding
    np.testing.assert_allclose(tm.linspace(t(start), t(stop), 102).numpy(), expected, atol=1e-6)
    full = make_path(3, n=9)
    dense = jax.vmap(lambda p: jm.dense_path(p, 5))(jnp.asarray(full))
    np.testing.assert_allclose(tm.dense_path(t(full), 5).numpy(), np.asarray(dense), atol=1e-5)


def check_reparam(full, rng_seed=4):
    rng = np.random.RandomState(rng_seed)
    batch, m, _ = full.shape
    coll = rng.rand(batch, m - 2).astype(np.float32)
    cons = rng.randn(batch, m - 1).astype(np.float32)

    def jax_one(p, c1, c2):
        out, interp = jr.reparametrize_se2(p)
        return (out, jr.reparametrize_collision_multipliers(c1, interp),
                jr.reparametrize_constraint_multipliers(c2, interp))

    expected = jax.vmap(jax_one)(jnp.asarray(full), jnp.asarray(coll), jnp.asarray(cons))
    out, interp = tr.reparametrize_se2(t(full))
    got = (out, tr.reparametrize_collision_multipliers(t(coll), interp),
           tr.reparametrize_constraint_multipliers(t(cons), interp))
    for g, e in zip(got, expected):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5)


def test_reparametrize_matches_jax():
    check_reparam(make_path(5))


def test_reparametrize_degenerate_zero_length_segments():
    full = make_path(6)
    full[:, 5] = full[:, 4]
    full[:, 6] = full[:, 4]
    check_reparam(full)


def test_reparametrize_collapsed_path_stays_finite():
    """A path collapsed to one point (update_start onto the goal): the CDF
    guard and the t-clamp keep it finite and in place."""
    point = np.tile(np.array([1.5, 1.0, 0.3], np.float32), (2, 14, 1))
    check_reparam(point)
    out, _ = tr.reparametrize_se2(t(point))
    np.testing.assert_allclose(out.numpy(), point[:, 1:-1], atol=1e-4)


def test_gumbel_topk_from_same_noise():
    rng = np.random.RandomState(7)
    u = rng.rand(4, 23).astype(np.float32)
    u[0, 0], u[1, 1] = 0.0, 1.0  # the clamps
    log_w = (rng.randn(4, 23) * 3).astype(np.float32)
    g_ref = js.gumbel_noise(jnp.asarray(u))
    g = ts.gumbel_noise(t(u))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5)
    ref = jax.vmap(lambda w, n: js.gumbel_topk_log_indices(w, n, 12))(jnp.asarray(log_w), g_ref)
    got = ts.gumbel_topk_log_indices(t(log_w), t(np.asarray(g_ref)), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_uniform_box_points():
    u = np.random.RandomState(8).rand(2, 10, 3).astype(np.float32)
    bounds = np.array([[-0.1, 3.1, -0.1, 3.1], [0.0, 1.0, 2.0, 4.0]], np.float32)
    got = ts.uniform_box_points(t(u), t(bounds), with_angle=True).numpy()
    for b in range(2):
        x = bounds[b, 0] + u[b, :, 0] * (bounds[b, 1] - bounds[b, 0])
        np.testing.assert_allclose(got[b, :, 0], x, rtol=1e-6)
    assert (got[..., 2] >= 0).all() and (got[..., 2] < 2 * np.pi).all()
