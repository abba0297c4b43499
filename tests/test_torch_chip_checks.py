"""The kernel checks of chip_smoke.py, on the CPU: `hold` accepts a problem
whose gradients moved only because a ReLU unit within rounding of zero took
the other side, and rejects any other miss."""
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from nfopp_tpu_torch import kernels  # noqa: E402
from nfopp_tpu_torch.models import ONFConfig, init_onf_params, onf_apply  # noqa: E402
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

CPU = torch.device("cpu")
B, M = 3, 40
POINT, UNIT = 7, 13
GRAD_TOLS = (2e-4, 2e-5)


def one(params, x, i=0):
    return tree_map(lambda t: t[i:i + 1].double(), params), x[i:i + 1].double()


@pytest.mark.parametrize("config", [
    ONFConfig(),
    ONFConfig(mean=1.0, sigma=3.0, angle_encoding=False),
    ONFConfig(use_cos=False, angle_encoding=False),
    ONFConfig(mean=0.5, sigma=2.0, bias=False),
])
def test_masked_forward_without_flips_is_onf_apply(config):
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.double(), init_onf_params(g, config, 1, CPU))
    x = torch.randn(1, 17, 3 if config.angle_encoding else 2, generator=g, dtype=torch.float64)
    got, _ = cs.masked_forward(params, x, config)
    torch.testing.assert_close(got, onf_apply(params, x, config)[..., 0], rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def kinked():
    """Fields whose problem 0 has a first-layer unit 3e-6 above zero at one
    point, and the field gradients a kernel taking its other side returns."""
    config = ONFConfig()
    g = torch.Generator().manual_seed(1)
    params = init_onf_params(g, config, B, CPU)
    x = torch.rand(B, M, 3, generator=g) * 3
    truth = torch.rand(B, M, generator=g) > 0.5
    _, pre = cs.masked_forward(*one(params, x), config)
    params["mlp1"]["b"][0, UNIT] -= float(pre[0][0, POINT, UNIT]) - 3e-6
    _, want = kernels.field_grad_plain(params, x, truth, config)
    want = tree_leaves(want)
    recompute = cs.field_grad_f64(truth, config)
    flipped = recompute(*one(params, x), 0, [(0, POINT, UNIT)])
    got = [w.clone() for w in want]
    for leaf, f in zip(got, flipped):
        leaf[0] = f[0].float()
    return config, params, x, truth, got, want


def hold_grads(kinked, got):
    config, params, x, truth, _, want = kinked
    return cs.hold("field_grad gradients", got, want, [GRAD_TOLS] * len(got),
                   kinks=(params, x, config, cs.field_grad_f64(truth, config)))


def test_hold_accepts_a_flipped_relu_unit(kinked):
    got, want = kinked[4], kinked[5]
    moved = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert moved > 1e-4  # the flip moves problem 0 past the elementwise bound
    assert hold_grads(kinked, got) == pytest.approx(moved)
    with pytest.raises(AssertionError, match=r"problems \[0\] outside"):
        cs.hold("no kinks", got, want, [GRAD_TOLS] * len(got))


@pytest.mark.parametrize("problem", [0, 1])
def test_hold_rejects_an_error_a_kink_does_not_explain(kinked, problem):
    got = [t.clone() for t in kinked[4]]
    got[2][problem, 3, 5] += 1e-3  # one element of mlp1's weight gradient
    with pytest.raises(AssertionError, match=f"problem {problem} misses its bound"):
        hold_grads(kinked, got)


def test_hold_accepts_a_flipped_unit_in_the_collision_gradients(kinked):
    config, params, x = kinked[:3]
    mult = torch.rand(B, M, generator=torch.Generator().manual_seed(2))
    recompute = cs.collision_f64(mult, torch.tensor([3.0, 1.0]), config, 10.0)
    pos, mu = x.clone().requires_grad_(True), mult.clone().requires_grad_(True)
    a, b = kernels.collision_terms_plain(params, pos, mu, config, 10.0)
    want = list(torch.autograd.grad((3.0 * a + b).sum(), (pos, mu)))
    got = [w.clone() for w in want]
    for leaf, f in zip(got, recompute(*one(params, x), 0, [(0, POINT, UNIT)])):
        leaf[0] = f[0].float()
    tols = [(5e-4, 1e-5), (5e-4, 1e-6)]
    assert cs.hold("collision gradients", got, want, tols,
                   kinks=(params, x, config, recompute)) > 1e-3
    got[0][1, 0, 0] += 1e-2
    with pytest.raises(AssertionError, match="problem 1 misses its bound"):
        cs.hold("collision gradients", got, want, tols, kinks=(params, x, config, recompute))
