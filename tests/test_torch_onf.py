"""The port's ONF (nfopp_tpu_torch.models.onf) against the JAX model."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.models import init_onf_params as jax_init
from nfopp_tpu.models import onf_apply as jax_onf_apply
from nfopp_tpu_torch.models import ONFConfig, init_onf_params, onf_apply, params_from_jax
from torch_threads import one_thread  # noqa: F401

CONFIGS = [
    ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True),
    ONFConfig(mean=1.5, sigma=2.0, use_cos=True, angle_encoding=False),
    ONFConfig(mean=0.0, sigma=5.0, use_cos=False, angle_encoding=False),
]


def jax_params(config, batch, seed=0):
    jcfg = JaxONFConfig(**config._asdict())
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return jax.tree_util.tree_map(np.asarray, jax.vmap(lambda k: jax_init(k, jcfg))(keys))


def both_apply(config, batch=3, m=37, seed=1):
    params = jax_params(config, batch)
    dim = 3 if config.angle_encoding else 2
    x = (np.random.RandomState(seed).randn(batch, m, dim) * 2).astype(np.float32)
    jcfg = JaxONFConfig(**config._asdict())
    expected = jax.vmap(lambda p, q: jax_onf_apply(p, q, jcfg))(params, jnp.asarray(x))
    got = onf_apply(params_from_jax(params, device="cpu"), torch.from_numpy(x), config)
    return np.asarray(expected), got.numpy()


@pytest.mark.parametrize("config", CONFIGS)
def test_onf_apply_matches_jax_f32(config):
    expected, got = both_apply(config)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", CONFIGS[:2])
def test_onf_apply_matches_jax_bf16(config):
    """bf16 compute: both round the same operands to bf16 before every
    product, but a one-ulp f32 difference upstream (sin/cos, the K=2
    encoding) can round to a neighbouring bf16 value (2^-8 relative), hence
    the loose tolerance."""
    expected, got = both_apply(config._replace(compute_dtype="bfloat16"))
    np.testing.assert_allclose(got, expected, rtol=2e-2, atol=2e-2)
    f32_expected, _ = both_apply(config)
    assert np.abs(got - f32_expected).max() > 0  # the casts really happened


@pytest.mark.parametrize("config", CONFIGS)
def test_init_shapes_and_bounds(config):
    generator = torch.Generator().manual_seed(0)
    got = init_onf_params(generator, config, batch=64)
    ref = jax_params(config, batch=64)
    assert set(got) == set(ref)
    for layer in ("encoding", "mlp1", "mlp2", "out"):
        for leaf in ("w", "b"):
            assert tuple(got[layer][leaf].shape) == ref[layer][leaf].shape
            assert got[layer][leaf].dtype == torch.float32
    fan_in = {"mlp1": config.feature_dim, "mlp2": config.hidden,
              "out": config.hidden + config.feature_dim}
    for layer, n in fan_in.items():
        bound = 1.0 / math.sqrt(n)
        for leaf in ("w", "b"):
            assert got[layer][leaf].abs().max() <= bound
    enc_w = got["encoding"]["w"]
    assert abs(enc_w.mean().item()) < 0.05 and abs(enc_w.std().item() - 1.0) < 0.05
    assert got["encoding"]["b"].abs().max() <= 1.0 / math.sqrt(2.0)
    if config.angle_encoding:
        assert tuple(got["angle_biases"].shape) == (64, 2 * config.angle_harmonics)
        assert got["angle_biases"].abs().max() <= math.pi


def test_init_without_bias_has_zero_encoding_bias():
    config = ONFConfig(bias=False)
    got = init_onf_params(torch.Generator().manual_seed(1), config, batch=2)
    assert torch.count_nonzero(got["encoding"]["b"]) == 0


def test_params_from_jax_round_trip():
    config = CONFIGS[0]
    batched = jax_params(config, batch=2)
    got = params_from_jax(batched, device="cpu")
    for layer in ("encoding", "mlp1", "mlp2", "out"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[layer][leaf].numpy(), batched[layer][leaf])
    np.testing.assert_array_equal(got["angle_biases"].numpy(), batched["angle_biases"])
    single = jax.tree_util.tree_map(lambda a: a[1], batched)
    one = params_from_jax(single, device="cpu")
    assert tuple(one["mlp1"]["w"].shape) == (1,) + batched["mlp1"]["w"].shape[1:]
    np.testing.assert_array_equal(one["mlp2"]["w"][0].numpy(), batched["mlp2"]["w"][1])
