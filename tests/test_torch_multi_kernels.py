"""The multi-problem kernels' CPU path (their plain PyTorch versions) against
the TPU kernels onf_multi.py / field_grad_multi.py run in Pallas interpret
mode, in f32 and bf16; and the collision terms' bf16 mode against the JAX
solver's (onf_apply under jax.grad). The CUDA kernels are held against the
same plain versions on the card by chip_smoke.py.

bf16 tolerance: the plain versions round at the TPU kernels' places, so the
two agree at the f32 tolerances except where one product's two f32 sums, taken
in different orders, round to neighbouring bf16 values. That value then moves
by one bf16 ulp (2^-7 of itself) and carries the move into what depends on
it. Such ties are rare, so at most max(2, 1%) of an output's elements may
miss the f32 bound, each by at most 2^-7 times the output's largest
magnitude.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.experimental.pallas.field_grad_multi import field_loss_and_grad_multi
from nfopp_tpu.experimental.pallas.onf_multi import onf_apply_fused_multi
from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.models import init_onf_params as jax_init
from nfopp_tpu.models import onf_apply as jax_onf_apply
from nfopp_tpu.ops.losses import softplus_beta as jax_softplus_beta
from nfopp_tpu_torch import kernels
from nfopp_tpu_torch.kernels.common import use_plain
from nfopp_tpu_torch.models import ONFConfig, params_from_jax
from nfopp_tpu_torch.utils.tree import tree_leaves

# the four field configurations of chip_smoke.py's check_configs that differ
# in more than the hidden width
CONFIGS = [
    ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True),
    ONFConfig(mean=1.0, sigma=3.0, use_cos=True, angle_encoding=False),
    ONFConfig(mean=0.0, sigma=1.0, use_cos=False, angle_encoding=False),
    ONFConfig(mean=0.5, sigma=2.0, use_cos=True, angle_encoding=True, bias=False),
]
DTYPES = ["float32", "bfloat16"]
B, M = 4, 37  # 37 rows: a partial last tile for the 8-row Pallas and 32-row CUDA tiles
BF16_ULP = 2.0 ** -7
FWD_TOLS = (1e-4, 2e-4)  # tests/test_pallas.py:32
LOSS_TOLS = (1e-5, 1e-6)  # tests/test_field_grad_fused.py:33-46
GRAD_TOLS = (2e-4, 2e-5)


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors no wrapper may count a kernel launch."""
    kernels.reset_launches()
    yield
    assert all(count == 0 for count in kernels.LAUNCHES.values()), kernels.LAUNCHES


def setup(config, dtype, batch=B, m=M, seed=0):
    config = config._replace(compute_dtype=dtype)
    jcfg = JaxONFConfig(**config._asdict())
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    params = jax.tree_util.tree_map(np.asarray, jax.vmap(lambda k: jax_init(k, jcfg))(keys))
    dim = 3 if config.angle_encoding else 2
    rng = np.random.RandomState(seed + 1)
    x = (rng.randn(batch, m, dim) * 2).astype(np.float32)
    truth = rng.rand(batch, m) > 0.5
    return config, jcfg, params, x, truth


def assert_close(got, want, tols, dtype, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    rtol, atol = tols
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
        return
    bound = atol + rtol * np.abs(want)
    diff = np.abs(got - want)
    misses = int((diff > bound).sum())
    assert misses <= max(2, want.size // 100), f"{name}: {misses} of {want.size} miss"
    assert (diff <= bound + BF16_ULP * np.abs(want).max()).all(), f"{name}: beyond a bf16 tie"


def pallas_grads(grads):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, grads), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("config", CONFIGS)
def test_onf_multi_matches_pallas(config, dtype):
    config, jcfg, params, x, _ = setup(config, dtype)
    want = onf_apply_fused_multi(params, jnp.asarray(x), jcfg, 2, interpret=True)
    got = kernels.onf_multi(params_from_jax(params, device="cpu"), torch.from_numpy(x), config, 2)
    assert tuple(got.shape) == (B, M, 1)
    assert_close(got.numpy(), want, FWD_TOLS, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("config", CONFIGS)
def test_field_grad_multi_matches_pallas(config, dtype):
    config, jcfg, params, x, truth = setup(config, dtype)
    ref_loss, ref_grads = field_loss_and_grad_multi(
        jcfg, params, jnp.asarray(x), jnp.asarray(truth), 2, interpret=True)
    loss, grads = kernels.field_grad_multi(
        params_from_jax(params, device="cpu"), torch.from_numpy(x), torch.from_numpy(truth),
        config, 2)
    assert_close(loss.numpy(), ref_loss, LOSS_TOLS, dtype, "loss")
    ref = pallas_grads(ref_grads)
    assert set(grads) == set(ref)
    for layer in ref:
        leaves = ref[layer] if isinstance(ref[layer], dict) else {"": ref[layer]}
        for leaf, want in leaves.items():
            got = grads[layer][leaf] if leaf else grads[layer]
            assert_close(got.numpy(), want.numpy(), GRAD_TOLS, dtype, f"{layer}/{leaf}")
    if not config.bias:
        assert (grads["encoding"]["b"] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_results_do_not_depend_on_problems_per_program(dtype):
    """The TPU kernels' problems are independent: Pallas gives the same bits
    for every P, and so does the port, which only checks P."""
    config, jcfg, params, x, truth = setup(CONFIGS[0], dtype, m=11, seed=3)
    port = params_from_jax(params, device="cpu")
    outs, port_outs = [], []
    for p in (1, 2, 4):
        loss, grads = field_loss_and_grad_multi(
            jcfg, params, jnp.asarray(x), jnp.asarray(truth), p, interpret=True)
        logits = onf_apply_fused_multi(params, jnp.asarray(x), jcfg, p, interpret=True)
        outs.append([np.asarray(logits), np.asarray(loss)]
                    + [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
        loss, grads = kernels.field_grad_multi(port, torch.from_numpy(x), torch.from_numpy(truth),
                                               config, p)
        logits = kernels.onf_multi(port, torch.from_numpy(x), config, p)
        port_outs.append([logits.numpy(), loss.numpy()] + [g.numpy() for g in tree_leaves(grads)])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)
    for other in port_outs[1:]:
        for a, b in zip(port_outs[0], other):
            np.testing.assert_array_equal(a, b)
    assert_close(port_outs[0][0], outs[0][0], FWD_TOLS, dtype)


def test_batch_not_divisible_by_problems_per_program_raises():
    config, jcfg, params, x, truth = setup(CONFIGS[0], "float32")
    port = params_from_jax(params, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3"):
        onf_apply_fused_multi(params, jnp.asarray(x), jcfg, 3, interpret=True)
    with pytest.raises(ValueError, match="not divisible by 3"):
        kernels.onf_multi(port, torch.from_numpy(x), config, 3)
    with pytest.raises(ValueError, match="not divisible by 3"):
        kernels.field_grad_multi(port, torch.from_numpy(x), torch.from_numpy(truth), config, 3)


@pytest.mark.parametrize("config", CONFIGS)
def test_f32_twins_equal_the_production_twins(config):
    """In f32 the multi-problem functions are kernels 1 and 2's: the written-out
    backward equals autograd of onf_apply."""
    config, _, params, x, truth = setup(config, "float32", seed=5)
    port = params_from_jax(params, device="cpu")
    x, truth = torch.from_numpy(x), torch.from_numpy(truth)
    torch.testing.assert_close(kernels.onf_multi_plain(port, x, config),
                               kernels.onf_forward_plain(port, x, config), rtol=1e-4, atol=2e-4)
    loss, grads = kernels.field_grad_multi_plain(port, x, truth, config)
    ref_loss, ref_grads = kernels.field_grad_plain(port, x, truth, config)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    for got, want in zip(tree_leaves(grads), tree_leaves(ref_grads)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("beta", [1.0, 10.0])
@pytest.mark.parametrize("angle", [True, False])
def test_bf16_collision_terms_match_the_jax_solver(beta, angle):
    """The trajectory step's collision terms in bf16: collision_terms_plain and
    its autograd against onf_apply's under jax.grad, as the JAX solver takes
    them (solver/constrained.py:404-406). Both round each cotangent once where
    it passes back through a cast, so they agree at the f32 kernel tests'
    tolerances up to bf16 ties."""
    config = ONFConfig(mean=0.5, sigma=2.0, angle_encoding=angle)
    config, jcfg, params, _, _ = setup(config, "bfloat16", batch=2, m=33)
    rng = np.random.RandomState(1)
    positions = (rng.randn(2, 33, 3 if angle else 2) * 1.5).astype(np.float32)
    multipliers = rng.rand(2, 33).astype(np.float32)
    w1, w2 = 3.0, 1.0

    def terms(p, pos, mult):
        logits = jax_onf_apply(p, pos, jcfg)
        return (jnp.sum(jax_softplus_beta(logits, beta)),
                jnp.sum(mult * jnp.tanh(logits[:, 0])))

    def weighted(p, pos, mult):
        a, b = terms(p, pos, mult)
        return w1 * a + w2 * b

    ref_a, ref_b = jax.vmap(terms)(params, jnp.asarray(positions), jnp.asarray(multipliers))
    ref_dp, ref_dm = jax.vmap(jax.grad(weighted, argnums=(1, 2)))(
        params, jnp.asarray(positions), jnp.asarray(multipliers))

    pos = torch.from_numpy(positions).requires_grad_(True)
    mult = torch.from_numpy(multipliers).requires_grad_(True)
    a, b = kernels.collision_terms(params_from_jax(params, device="cpu"), pos, mult, config, beta)
    assert_close(a.detach().numpy(), ref_a, (1e-5, 1e-5), "bfloat16", "softplus sum")
    assert_close(b.detach().numpy(), ref_b, (1e-5, 1e-5), "bfloat16", "tanh sum")
    dp, dm = torch.autograd.grad((w1 * a + w2 * b).sum(), (pos, mult))
    assert_close(dp.numpy(), ref_dp, (5e-4, 1e-5), "bfloat16", "d positions")
    assert_close(dm.numpy(), ref_dm, (5e-4, 1e-6), "bfloat16", "d multipliers")


@pytest.mark.parametrize("name", [
    "onf_forward", "field_grad", "collision_terms", "onf_multi", "field_grad_multi",
])
def test_dispatch_rule_for_bf16_on_cuda(name):
    """On CUDA tensors every kernel takes f32 and bf16, the production
    solver's field passes included (onf_apply's casts); none ever falls back
    to the plain version, and an unsupported compute_dtype raises."""
    on_cuda = types.SimpleNamespace(device=torch.device("cuda"))
    assert use_plain(on_cuda, ONFConfig(), name) is False
    assert use_plain(on_cuda, ONFConfig(compute_dtype="bfloat16"), name) is False
    with pytest.raises(ValueError, match="unsupported compute_dtype"):
        use_plain(on_cuda, ONFConfig(compute_dtype="float16"), name)
