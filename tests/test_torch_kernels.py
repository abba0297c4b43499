"""The kernel wrappers' CPU path (their plain PyTorch versions) against the
TPU kernels run in Pallas interpret mode. The CUDA kernels themselves are
held against the same plain versions on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.experimental.pallas import onf_apply_fused
from nfopp_tpu.experimental.pallas.collision_terms import make_collision_terms
from nfopp_tpu.experimental.pallas.field_grad import field_loss_and_grad_fused
from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.models import init_onf_params as jax_init
from nfopp_tpu_torch import kernels
from nfopp_tpu_torch.models import ONFConfig, params_from_jax

CONFIGS = [
    ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True),
    ONFConfig(mean=1.0, sigma=3.0, use_cos=True, angle_encoding=False),
    ONFConfig(mean=0.0, sigma=1.0, use_cos=False, angle_encoding=False),
]


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors no wrapper may count a kernel launch."""
    kernels.reset_launches()
    yield
    assert all(count == 0 for count in kernels.LAUNCHES.values()), kernels.LAUNCHES


def setup(config, batch, m, seed=0):
    jcfg = JaxONFConfig(**config._asdict())
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    params = jax.tree_util.tree_map(np.asarray, jax.vmap(lambda k: jax_init(k, jcfg))(keys))
    dim = 3 if config.angle_encoding else 2
    x = (np.random.RandomState(seed + 1).randn(batch, m, dim) * 2).astype(np.float32)
    return jcfg, params, x


@pytest.mark.parametrize("config", CONFIGS)
def test_onf_forward_matches_pallas(config):
    jcfg, params, x = setup(config, batch=3, m=37)
    expected = onf_apply_fused(params, jnp.asarray(x), jcfg, interpret=True)
    got = kernels.onf_forward(params_from_jax(params, device="cpu"), torch.from_numpy(x), config)
    assert tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("config", CONFIGS)
def test_field_grad_matches_pallas(config):
    jcfg, params, x = setup(config, batch=2, m=53)
    truth = np.random.RandomState(2).rand(2, 53) > 0.5
    ref_loss, ref_grads = jax.vmap(
        lambda p, q, y: field_loss_and_grad_fused(jcfg, p, q, y, interpret=True)
    )(params, jnp.asarray(x), jnp.asarray(truth))
    loss, grads = kernels.field_grad(params_from_jax(params, device="cpu"), torch.from_numpy(x),
                                     torch.from_numpy(truth), config)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-6)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), device="cpu")
    assert set(grads) == set(ref)
    for layer in ref:
        leaves = ref[layer] if isinstance(ref[layer], dict) else {"": ref[layer]}
        for leaf, expected in leaves.items():
            got = grads[layer][leaf] if leaf else grads[layer]
            assert got.shape == expected.shape, (layer, leaf)
            np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=f"gradient of {layer}/{leaf}")


@pytest.mark.parametrize("beta", [1.0, 10.0])
@pytest.mark.parametrize("angle", [True, False])
def test_collision_terms_match_pallas(beta, angle):
    config = ONFConfig(mean=0.5, sigma=2.0, use_cos=True, angle_encoding=angle)
    jcfg, params, _ = setup(config, batch=2, m=33)
    rng = np.random.RandomState(1)
    dim = 3 if angle else 2
    positions = (rng.randn(2, 33, dim) * 1.5).astype(np.float32)
    multipliers = rng.rand(2, 33).astype(np.float32)
    terms = make_collision_terms(jcfg, beta, interpret=True)
    w1, w2 = 3.0, 1.0

    def ref_loss(p, pos, mult):
        a, b = terms(p, pos, mult)
        return w1 * a + w2 * b

    ref_sums = jax.vmap(terms)(params, jnp.asarray(positions), jnp.asarray(multipliers))
    ref_dp, ref_dm = jax.vmap(jax.grad(ref_loss, argnums=(1, 2)))(
        params, jnp.asarray(positions), jnp.asarray(multipliers))

    pos = torch.from_numpy(positions).requires_grad_(True)
    mult = torch.from_numpy(multipliers).requires_grad_(True)
    a, b = kernels.collision_terms(params_from_jax(params, device="cpu"), pos, mult, config, beta)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ref_sums[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(ref_sums[1]), rtol=1e-5, atol=1e-5)
    dp, dm = torch.autograd.grad((w1 * a + w2 * b).sum(), (pos, mult))
    np.testing.assert_allclose(dp.numpy(), np.asarray(ref_dp), rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(dm.numpy(), np.asarray(ref_dm), rtol=5e-4, atol=1e-6)


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor on neither the CPU nor CUDA raises."""
    config = CONFIGS[0]
    _, params, x = setup(config, batch=1, m=5)
    meta = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.onf_forward(params_from_jax(params, device="cpu"), meta, config)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.field_grad(params_from_jax(params, device="cpu"), meta, torch.zeros(1, 5), config)
