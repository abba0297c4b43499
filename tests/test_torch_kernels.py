"""The kernel wrappers' CPU path (their plain PyTorch versions) against the
TPU kernels run in Pallas interpret mode. The CUDA kernels themselves are
held against the same plain versions on the card by chip_smoke.py."""
import importlib
import types
from functools import partial

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


@pytest.mark.parametrize("name,entry,flag", [
    ("field_grad", "nf_field_grad", 0),
    ("field_grad_bf16", "nf_field_grad", 1),
    ("field_grad_multi", "nf_field_grad_multi", 1),
])
def test_field_grad_refuses_a_field_too_wide_for_its_kernel(monkeypatch, name, entry, flag):
    """A field-gradient kernel that cannot hold a field on chip returns
    TOO_LARGE; the wrapper raises a ValueError naming the widths and counts
    no launch (the library is stood in for, so this runs without a card)."""
    from nfopp_tpu_torch.kernels.common import NetArgs
    from nfopp_tpu_torch.models import init_onf_params

    fg = importlib.import_module("nfopp_tpu_torch.kernels.field_grad")  # the module
    config = ONFConfig(hidden=112)
    params = init_onf_params(torch.Generator().manual_seed(0), config, 2, torch.device("cpu"))
    x, truth = torch.zeros((2, 5, 3)), torch.zeros((2, 5), dtype=torch.bool)
    library = types.SimpleNamespace(**{entry: lambda *args: fg.TOO_LARGE})
    monkeypatch.setattr(fg, "net_args", lambda *args: NetArgs())
    monkeypatch.setattr(fg, "stream", lambda: None)
    monkeypatch.setattr(fg.build, "load_library", lambda: library)
    with pytest.raises(ValueError, match="220 features and hidden 112 does not fit"):
        fg.launch_field_grad(name, entry, params, x, truth, config, flag)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_collision_bwd_refuses_a_field_too_wide_for_its_kernel(monkeypatch, compute_dtype):
    """A collision-backward kernel that cannot hold a field in one CTA's
    shared memory returns TOO_LARGE; the wrapper raises a ValueError naming
    the widths and each mode's limit, and counts no launch (the library is
    stood in for, so this runs without a card)."""
    from nfopp_tpu_torch.kernels.common import TOO_LARGE, NetArgs
    from nfopp_tpu_torch.models import init_onf_params

    ct = importlib.import_module("nfopp_tpu_torch.kernels.collision_terms")  # the module
    config = ONFConfig(hidden=112, compute_dtype=compute_dtype)
    params = init_onf_params(torch.Generator().manual_seed(0), config, 2, torch.device("cpu"))
    x, mult, g = torch.zeros((2, 5, 3)), torch.zeros((2, 5)), torch.ones((2, 2))
    calls = []
    library = types.SimpleNamespace(nf_collision_bwd=lambda *args: calls.append(args) or TOO_LARGE)
    monkeypatch.setattr(ct, "net_args", lambda *args: NetArgs())
    monkeypatch.setattr(ct, "stream", lambda: None)
    monkeypatch.setattr(ct.build, "load_library", lambda: library)
    with pytest.raises(ValueError, match="220 features and hidden 112 does not fit") as info:
        ct.collision_bwd(params, x, mult, g, config, 10.0)
    assert "f32 kernel takes hidden <= 108" in str(info.value)
    assert "bf16 kernel hidden <= 128" in str(info.value)
    assert len(calls) == 1 and calls[0][8] == int(compute_dtype == "bfloat16")  # its bf16 flag


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,entry,flag_at", [
    ("onf_forward", "nf_onf_forward", 5),
    ("onf_multi", "nf_onf_multi", 5),
    ("collision_fwd", "nf_collision_fwd", 7),
])
def test_forward_kernels_refuse_a_field_too_wide(monkeypatch, name, entry, flag_at, compute_dtype):
    """A forward kernel (the ONF logits kernel behind onf_forward and
    onf_multi, the collision forward) that cannot hold a field in one CTA's
    shared memory returns TOO_LARGE; the wrapper raises a ValueError naming
    the widths and each mode's limit, and counts no launch (the library is
    stood in for, and the wrapper made to take CPU tensors for the kernel's,
    so this runs without a card)."""
    from nfopp_tpu_torch.kernels.common import TOO_LARGE, NetArgs
    from nfopp_tpu_torch.models import init_onf_params

    module = importlib.import_module(
        "nfopp_tpu_torch.kernels." + ("collision_terms" if name == "collision_fwd" else name))
    config = ONFConfig(hidden=121, compute_dtype=compute_dtype)
    params = init_onf_params(torch.Generator().manual_seed(0), config, 2, torch.device("cpu"))
    x, mult = torch.zeros((2, 5, 3)), torch.zeros((2, 5))
    calls = []
    library = types.SimpleNamespace(**{entry: lambda *args: calls.append(args) or TOO_LARGE})
    monkeypatch.setattr(module, "net_args", lambda *args: NetArgs())
    monkeypatch.setattr(module, "stream", lambda: None)
    monkeypatch.setattr(module.build, "load_library", lambda: library)
    if name == "collision_fwd":
        call = partial(module.collision_fwd, params, x, mult, config, 10.0)
    else:
        monkeypatch.setattr(module, "use_plain", lambda *args: False)
        call = partial(getattr(module, name), params, x, config,
                       *(2,) if name == "onf_multi" else ())
    with pytest.raises(ValueError, match="220 features and hidden 121 does not fit") as info:
        call()
    assert "f32 kernel takes hidden <= 120" in str(info.value)
    assert "bf16 kernel every field of hidden <= 128" in str(info.value)
    assert len(calls) == 1 and calls[0][flag_at] == int(compute_dtype == "bfloat16")
