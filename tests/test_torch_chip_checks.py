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


BF16 = ONFConfig(compute_dtype="bfloat16")


def grads_in(fn, params, x, mult, config):
    pos, mu = x.clone().requires_grad_(True), mult.clone().requires_grad_(True)
    a, b = fn(params, pos, mu, config, 10.0)
    return list(torch.autograd.grad((3.0 * a + b).sum(), (pos, mu)))


@pytest.mark.parametrize("casts", ["multi", "apply"])
def test_masked_forward_casts_are_the_plain_versions(casts):
    """masked_forward's bf16 casts, under autograd, are the plain versions of
    the bf16 kernels: "multi" the multi-problem kernels' written-out backward,
    "apply" autograd of the collision terms through onf_apply's casts (held
    as chip_smoke.py holds the kernels, bf16 ties allowed)."""
    g = torch.Generator().manual_seed(4)
    params = init_onf_params(g, BF16, B, CPU)
    x = torch.rand(B, M, 3, generator=g) * 3
    if casts == "multi":
        truth = torch.rand(B, M, generator=g) > 0.5
        recompute = cs.field_grad_f64(truth, BF16, casts)
        got = [torch.cat(parts) for parts in zip(*(
            recompute(tree_map(lambda t: t[i:i + 1].float(), params), x[i:i + 1], i, ())
            for i in range(B)))]
        _, want = kernels.field_grad_multi_plain(params, x, truth, BF16)
        want = tree_leaves(want)
        tols = [GRAD_TOLS] * len(want)
    else:
        mult = torch.rand(B, M, generator=g)
        recompute = cs.collision_f64(mult, torch.tensor([3.0, 1.0]), BF16, 10.0, casts)
        got = [torch.cat(parts) for parts in zip(*(
            recompute(tree_map(lambda t: t[i:i + 1].float(), params), x[i:i + 1], i, ())
            for i in range(B)))]
        want = grads_in(kernels.collision_terms_plain, params, x, mult, BF16)
        tols = [(5e-4, 1e-5), (5e-4, 1e-6)]
    assert cs.hold(f"masked_forward {casts}", got, want, tols, bf16=True) < 1e-2


def test_hold_bf16_allows_rare_ties_and_rejects_a_systematic_miss():
    g = torch.Generator().manual_seed(5)
    params = init_onf_params(g, BF16, B, CPU)
    x = torch.rand(B, M, 3, generator=g) * 3
    truth = torch.rand(B, M, generator=g) > 0.5
    _, want = kernels.field_grad_multi_plain(params, x, truth, BF16)
    want = tree_leaves(want)
    tols = [GRAD_TOLS] * len(want)
    # one tie in problem 1's largest gradient leaf, moved by half the allowance
    j = max(range(len(want)), key=lambda k: float(want[k][1].abs().max()))
    scale = float(want[j][1].abs().max())
    move = 0.5 * cs.BF16_ULP * scale
    assert move > GRAD_TOLS[1] + GRAD_TOLS[0] * scale
    got = [w.clone() for w in want]
    got[j][1].view(-1)[int(want[j][1].abs().argmax())] += move
    assert cs.hold("one tie", got, want, tols, bf16=True) == pytest.approx(move, rel=1e-3)
    with pytest.raises(AssertionError, match="outside the bounds"):
        cs.hold("one tie as f32", got, want, tols)
    got[j][1].view(-1)[int(want[j][1].abs().argmax())] += 3 * move  # twice the allowance
    with pytest.raises(AssertionError, match=r"problems \[1\] outside"):
        cs.hold("beyond a tie", got, want, tols, bf16=True)
    # every element of out.w's gradient off by one bf16 ulp: a rounding in
    # the wrong place, which no share of ties explains
    got = [w.clone() for w in want]
    got[6] = got[6] * (1.0 + 2.0 ** -7)
    with pytest.raises(AssertionError, match="more than bf16 ties explain"):
        cs.hold("systematic", got, want, tols, bf16=True)


@pytest.mark.parametrize("casts", ["multi", "apply"])
def test_hold_bf16_accepts_a_flipped_relu_unit(casts):
    """As in f32: a bf16 kernel whose problem 0 took the other side of a
    first-layer unit 3e-6 above zero (in the rounded operands' pre-activation)
    passes through the f64 recomputation with the same casts. Under "multi"
    the flip moves problem 0 past the bf16 bound; under "apply" only its d
    positions' row, within the tie allowance."""
    g = torch.Generator().manual_seed(6)
    params = init_onf_params(g, BF16, B, CPU)
    x = torch.rand(B, M, 3, generator=g) * 3
    _, pre = cs.masked_forward(*one(params, x), BF16, casts=casts)
    params["mlp1"]["b"][0, UNIT] -= float(pre[0][0, POINT, UNIT]) - 3e-6
    if casts == "multi":
        truth = torch.rand(B, M, generator=g) > 0.5
        recompute = cs.field_grad_f64(truth, BF16, casts)
        want = tree_leaves(kernels.field_grad_multi_plain(params, x, truth, BF16)[1])
        tols = [GRAD_TOLS] * len(want)
    else:
        mult = torch.rand(B, M, generator=g)
        recompute = cs.collision_f64(mult, torch.tensor([3.0, 1.0]), BF16, 10.0, casts)
        want = grads_in(kernels.collision_terms_plain, params, x, mult, BF16)
        tols = [(5e-4, 1e-5), (5e-4, 1e-6)]
    got = [w.clone() for w in want]
    for leaf, f in zip(got, recompute(*one(params, x), 0, [(0, POINT, UNIT)])):
        leaf[0] = f[0].float()
    if casts == "multi":
        with pytest.raises(AssertionError, match=r"problems \[0\] outside"):
            cs.hold("no kinks", got, want, tols, bf16=True)
    assert cs.hold("kink", got, want, tols, kinks=(params, x, BF16, recompute), bf16=True) > 0
