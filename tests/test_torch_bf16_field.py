"""The production solver's field passes in bf16: the plain twins of the
onf_forward and field_grad kernels (onf_apply's casts and their autograd)
against the JAX solver's onf_apply and field_loss_and_grad in bf16. The CUDA
kernels are held against the same twins on the card by chip_smoke.py.

bf16 tolerance: both sides round at the same places (every product's operands,
xy and the encoding weights included; each cotangent where it passes back
through a cast; each cast weight's gradient once, after its f32 sum), so they
agree at the f32 kernel tests' tolerances except where one value's two f32
sums, taken in different orders, round to neighbouring bf16 values (a tie,
tests/test_torch_multi_kernels.py): at most max(2, 1%) of an output's
elements may miss the f32 bound, each by at most 2^-7 of the output's
largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.models import init_onf_params as jax_init
from nfopp_tpu.models import onf_apply as jax_onf_apply
from nfopp_tpu.solver import SolverConfig as JaxSolverConfig
from nfopp_tpu.solver.field import field_loss_and_grad as jax_field_loss_and_grad
from nfopp_tpu_torch import kernels
from nfopp_tpu_torch.models import ONFConfig, params_from_jax
from test_torch_kernels import CONFIGS
from test_torch_multi_kernels import FWD_TOLS, GRAD_TOLS, LOSS_TOLS, assert_close

B, M = 2, 53
# the gradients of the four cast weights: each rounded once to bf16
CAST_WEIGHTS = [("encoding", "w"), ("mlp1", "w"), ("mlp2", "w"), ("out", "w")]


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors no wrapper may count a kernel launch."""
    kernels.reset_launches()
    yield
    assert all(count == 0 for count in kernels.LAUNCHES.values()), kernels.LAUNCHES


def setup(config, seed=0):
    config = config._replace(compute_dtype="bfloat16")
    jcfg = JaxONFConfig(**config._asdict())
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    params = jax.tree_util.tree_map(np.asarray, jax.vmap(lambda k: jax_init(k, jcfg))(keys))
    dim = 3 if config.angle_encoding else 2
    rng = np.random.RandomState(seed + 1)
    x = (rng.randn(B, M, dim) * 2).astype(np.float32)
    truth = rng.rand(B, M) > 0.5
    return config, jcfg, params, x, truth


def is_bf16_valued(a) -> bool:
    t = torch.as_tensor(np.asarray(a, np.float32))
    return bool(torch.equal(t, t.to(torch.bfloat16).float()))


@pytest.mark.parametrize("config", CONFIGS)
def test_onf_forward_plain_bf16_matches_jax(config):
    config, jcfg, params, x, _ = setup(config)
    want = jax.vmap(lambda p, q: jax_onf_apply(p, q, jcfg))(params, jnp.asarray(x))
    got = kernels.onf_forward(params_from_jax(params, device="cpu"), torch.from_numpy(x), config)
    assert tuple(got.shape) == (B, M, 1)
    assert_close(got.numpy(), want, FWD_TOLS, "bfloat16", "logits")


@pytest.mark.parametrize("config", CONFIGS)
def test_field_grad_plain_bf16_matches_jax(config):
    config, jcfg, params, x, truth = setup(config)
    solver_cfg = JaxSolverConfig(onf=jcfg)
    ref_loss, ref_grads = jax.vmap(
        lambda p, q, y: jax_field_loss_and_grad(solver_cfg, p, q, y)
    )(params, jnp.asarray(x), jnp.asarray(truth))
    loss, grads = kernels.field_grad(params_from_jax(params, device="cpu"), torch.from_numpy(x),
                                     torch.from_numpy(truth), config)
    assert_close(loss.numpy(), ref_loss, LOSS_TOLS, "bfloat16", "loss")
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), device="cpu")
    assert set(grads) == set(ref)
    for layer in ref:
        leaves = ref[layer] if isinstance(ref[layer], dict) else {"": ref[layer]}
        for leaf, want in leaves.items():
            got = grads[layer][leaf] if leaf else grads[layer]
            assert_close(got.numpy(), want.numpy(), GRAD_TOLS, "bfloat16", f"{layer}/{leaf}")
    for layer, leaf in CAST_WEIGHTS:
        assert is_bf16_valued(grads[layer][leaf]), (layer, leaf)
        assert is_bf16_valued(ref[layer][leaf]), (layer, leaf)
    # the bias gradients are f32 sums, not rounded
    assert not is_bf16_valued(grads["mlp1"]["b"])
