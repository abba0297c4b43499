"""The kernel checks of chip_smoke.py, on the CPU: `hold` accepts a problem
whose gradients moved only because a ReLU unit within rounding of zero took
the other side, and rejects any other miss."""
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from nfopp_tpu_torch import kernels  # noqa: E402
from nfopp_tpu_torch.models import ONFConfig, init_onf_params, onf_apply  # noqa: E402
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402, F401

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


@pytest.mark.parametrize("kernel_off,passes", [(0.5, True), (-0.9, True), (1.5, False)])
def test_hold_accepts_a_kernel_no_farther_from_f64_than_the_plain_version(kinked, kernel_off,
                                                                          passes):
    """A badly conditioned problem: the plain version sits 2e-3 from the
    f64 recomputation in one gradient element, past every bound, and nearer
    on every other problem. A kernel closer to it (on either side) passes;
    one farther off than the plain version on any problem does not."""
    config, params, x, truth = kinked[:4]
    exact = cs.field_grad_f64(truth, config)(*one(params, x, 1), 1, ())
    want = [w.clone() for w in kinked[5]]
    for leaf, f in zip(want, exact):
        leaf[1] = f[0].float()
    got = [w.clone() for w in want]
    want[2][1, 3, 5] += 2e-3
    got[2][1, 3, 5] += kernel_off * 2e-3
    if passes:
        assert hold_grads((*kinked[:5], want), got) == pytest.approx(
            abs(1.0 - kernel_off) * 2e-3, rel=1e-3)
    else:
        with pytest.raises(AssertionError, match="farther from the f64 recomputation"):
            hold_grads((*kinked[:5], want), got)


def test_collision_sums_f64_is_the_plain_collision_forward(kinked):
    config, params, x = kinked[:3]
    mult = torch.rand(B, M, generator=torch.Generator().manual_seed(3))
    a, b = kernels.collision_terms_plain(params, x, mult, config, 10.0)
    sums = cs.collision_sums_f64(mult, config, 10.0)(*one(params, x, 2), 2, ())[0]
    torch.testing.assert_close(sums.float(), torch.stack([a, b], dim=1)[2:3], rtol=1e-5,
                               atol=1e-5)


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


def test_field_grad_f64_apply_is_the_bf16_field_grad_plain():
    """masked_forward's "apply" casts under autograd, the recomputation that
    holds the bf16 field_grad kernel, are field_grad_plain's bf16 gradients
    (autograd of onf_apply's casts), held as chip_smoke.py holds the kernel."""
    g = torch.Generator().manual_seed(8)
    params = init_onf_params(g, BF16, B, CPU)
    x = torch.rand(B, M, 3, generator=g) * 3
    truth = torch.rand(B, M, generator=g) > 0.5
    recompute = cs.field_grad_f64(truth, BF16, "apply")
    got = [torch.cat(parts) for parts in zip(*(
        recompute(tree_map(lambda t: t[i:i + 1].float(), params), x[i:i + 1], i, ())
        for i in range(B)))]
    want = tree_leaves(kernels.field_grad_plain(params, x, truth, BF16)[1])
    assert cs.hold("field_grad_f64 apply", got, want, [GRAD_TOLS] * len(want), bf16=True) < 1e-2


def test_hold_bf16_accepts_a_unit_flipped_within_a_tie_reach():
    """A bf16 tie in a layer's input moves a unit's pre-activation by up to
    BF16_ULP max_j |a_j W_jc|. A first-layer unit half that far from zero in
    problem 0, flipped, passes under bf16 through tie_reach_units, and fails
    as f32, where only units within KINK_TOL of zero may flip."""
    g = torch.Generator().manual_seed(7)
    params = init_onf_params(g, BF16, B, CPU)
    x = torch.rand(B, M, 3, generator=g) * 3
    truth = torch.rand(B, M, generator=g) > 0.5
    record = {}
    _, pre = cs.masked_forward(*one(params, x), BF16, casts="apply", record=record)
    a, w = record["inputs"][0][0, POINT], record["weights"][0][0]
    reach = cs.BF16_ULP * float((a.abs() * w[:, UNIT].abs()).max())
    assert reach > 10 * cs.KINK_TOL
    params["mlp1"]["b"][0, UNIT] -= float(pre[0][0, POINT, UNIT]) - 0.5 * reach
    recompute = cs.field_grad_f64(truth, BF16, "apply")
    want = tree_leaves(kernels.field_grad_plain(params, x, truth, BF16)[1])
    got = [t.clone() for t in want]
    for leaf, f in zip(got, recompute(*one(params, x), 0, [(0, POINT, UNIT)])):
        leaf[0] = f[0].float()
    tols = [GRAD_TOLS] * len(want)
    with pytest.raises(AssertionError, match=r"problems \[0\] outside"):
        cs.hold("no kinks", got, want, tols, bf16=True)
    assert cs.hold("tie", got, want, tols, kinks=(params, x, BF16, recompute), bf16=True) > 0
    with pytest.raises(AssertionError, match="problem 0 misses its bound"):
        cs.hold("as f32", got, want, tols, kinks=(params, x, BF16, recompute))


# made-up `cuobjdump -sass` listings: each kernel's name, then its lines
FIELD_TC = ("_Z20field_grad_tc_kernelILi1EEvPKfS1_iiN2nf7NetArgsEPfNS2_5GradsE",
            "_Z20field_grad_tc_kernelILi2EEvPKfS1_iiN2nf7NetArgsEPfNS2_5GradsE")
COLLISION_TC = "_ZN12_GLOBAL__N_123collision_bwd_tc_kernelILi2EEEvPKfS2_S2_iiN2nf7NetArgsEfPfS5_"
ONF_TC = ("_ZN2nf20onf_logits_tc_kernelILi1EEEvPKfiiNS_7NetArgsEPf",
          "_ZN2nf20onf_logits_tc_kernelILi2EEEvPKfiiNS_7NetArgsEPf")
COLLISION_FWD_TC = "_ZN12_GLOBAL__N_123collision_fwd_tc_kernelILi2EEEvPKfS2_iiN2nf7NetArgsEfPf"
OTHERS = ("_Z21field_grad_f32_kernelILi0EEvPKfS1_iiN2nf7NetArgsEPfNS2_5GradsE",
          "_ZN12_GLOBAL__N_124collision_bwd_f32_kernelILi0EEEvPKfS2_S2_iiN2nf7NetArgsEfPfS5_",
          "_ZN12_GLOBAL__N_124collision_fwd_f32_kernelILi0EEEvPKfS2_iiN2nf7NetArgsEfPf",
          "_ZN2nf21onf_logits_f32_kernelILi0EEEvPKfiiNS_7NetArgsEPf")
HMMA = {FIELD_TC[0]: 128, FIELD_TC[1]: 128, COLLISION_TC: 56, ONF_TC[0]: 48, ONF_TC[1]: 48,
        COLLISION_FWD_TC: 48, **{name: 0 for name in OTHERS}}


def sass_listing(hmma: dict) -> str:
    lines = ["", "Fatbin elf code:", "================", "arch = sm_90a"]
    for name, count in hmma.items():
        lines += ["", f"\tcode for sm_90a", f"\t\tFunction : {name}",
                  "        /*0000*/                   LDC R1, c[0x0][0x28] ;"]
        lines += ["        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"] * count
        lines += ["        /*0020*/                   FFMA R5, R6, R7, R5 ;", "        /*0030*/   EXIT ;"]
    return "\n".join(lines)


def test_tensor_core_kernels_counts_hmma_of_the_field_and_collision_kernels():
    assert cs.tensor_core_kernels(sass_listing(HMMA)) == HMMA


@pytest.mark.parametrize("missing", [COLLISION_TC, FIELD_TC[1], ONF_TC[0], ONF_TC[1],
                                     COLLISION_FWD_TC])
def test_tensor_core_kernels_raises_without_hmma_in_a_tensor_core_kernel(missing):
    """A bf16 kernel compiled without tensor-core instructions (or missing
    from the library) fails the check: the bf16 collision backward and
    forward and the ONF logits kernel's two bf16 modes as the field-gradient
    kernels."""
    hmma = dict(HMMA)
    hmma[missing] = 0
    kernel = next(k for k in cs.TENSOR_CORE_KERNELS if k in missing)
    with pytest.raises(AssertionError, match=f"{kernel}: instantiations without tensor-core"):
        cs.tensor_core_kernels(sass_listing(hmma))
    del hmma[missing]
    with pytest.raises(AssertionError, match=kernel):
        cs.tensor_core_kernels(sass_listing(hmma))


@pytest.mark.parametrize("f32_kernel", OTHERS)
def test_tensor_core_kernels_raises_on_hmma_in_an_f32_kernel(f32_kernel):
    """The f32 kernels keep the f32 numerics: tensor-core instructions in one
    of them fail the check."""
    hmma = dict(HMMA)
    hmma[f32_kernel] = 8
    with pytest.raises(AssertionError, match="f32 kernels with tensor-core instructions"):
        cs.tensor_core_kernels(sass_listing(hmma))


def test_check_launches_wants_each_path_kernel_once_per_step():
    """Each kernel of the path once per step, the Adam kernel twice (the
    field's and the trajectory's update), pretraining's iterations once
    more each for the field-gradient and Adam kernels, others never."""
    path = ("onf_forward", "field_grad")
    launches = {name: 0 for name in kernels.LAUNCHES}
    launches.update(onf_forward=150, field_grad=150, adam=300)
    cs.check_launches(launches, path, 150, "a test")
    for name, count in (("field_grad", 149), ("collision_fwd", 1), ("adam", 150), ("adam", 301)):
        wrong = dict(launches, **{name: count})
        with pytest.raises(AssertionError, match=f"kernel {name} launched {count} times"):
            cs.check_launches(wrong, path, 150, "a test")
    # pretraining's launches of the field-gradient and Adam kernels come on top
    pretrained = dict(launches, field_grad=250, adam=400)
    cs.check_launches(pretrained, path, 150, "a test", cs.pretrain_launches(100))
    for name in ("field_grad", "adam"):
        with pytest.raises(AssertionError, match=f"kernel {name} launched {launches[name]} times"):
            cs.check_launches(dict(pretrained, **{name: launches[name]}), path, 150, "a test",
                              cs.pretrain_launches(100))
    # pretraining alone (no steps), and a program whose Adam is PyTorch's
    cs.check_launches(dict(launches, onf_forward=0, field_grad=100, adam=100), ("field_grad",), 0,
                      "a test", cs.pretrain_launches(100))
    cs.check_launches(dict(launches, adam=0), path, 150, "a test", adam_per_step=0)
    with pytest.raises(AssertionError, match="kernel adam launched 300 times"):
        cs.check_launches(launches, path, 150, "a test", adam_per_step=0)


def test_check_replicas_holds_groups_bit_identical_and_distinct():
    g = torch.Generator().manual_seed(0)
    params = init_onf_params(g, ONFConfig(hidden=8), 3)
    tree = tree_map(lambda x: x.repeat_interleave(4, dim=0), params)
    cs.check_replicas(tree, 4)
    flipped = tree_map(lambda x: x.clone(), tree)
    flipped["mlp2"]["w"][5, 1, 2] = torch.nextafter(flipped["mlp2"]["w"][5, 1, 2],
                                                     torch.tensor(1.0))
    with pytest.raises(AssertionError, match="differs within a group"):
        cs.check_replicas(flipped, 4)
    same = tree_map(lambda x: x[:1].expand(12, *x.shape[1:]).contiguous(), params)
    with pytest.raises(AssertionError, match="same field"):
        cs.check_replicas(same, 4)


def test_tracked_rates_divide_by_the_iterations_run():
    """µs per iteration per problem divides by the mean iterations actually
    run, not the budget."""
    assert cs.per_problem_us(2.0, 250.0, 8) == pytest.approx(1000.0)
    assert cs.per_problem_us(2.0, 1000, 8) == pytest.approx(250.0)


def test_check_finite_paths():
    cs.check_finite_paths(torch.zeros(2, 5, 3), (2, 5, 3), "a test")
    for bad in (torch.zeros(2, 5, 2), torch.full((2, 5, 3), float("nan"))):
        with pytest.raises(AssertionError, match="bad paths"):
            cs.check_finite_paths(bad, (2, 5, 3), "a test")


@pytest.fixture(scope="module", params=["constrained", "holonomic"])
def path_state(request):
    """A small solver of each kind, 10 steps into a solve of 2 problems, with
    (solver, state, oracle, width of its points, collision samples)."""
    from nfopp_tpu_torch.solver import ConstrainedSolver, HolonomicSolver, SolverConfig
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import circle_collision, rectangle_collision

    holonomic = request.param == "holonomic"
    samples = 1 if holonomic else 2
    cfg = SolverConfig(trajectory_length=12, collision_point_count=10,
                       onf=ONFConfig(hidden=16, angle_encoding=False),
                       init_collision_iteration=0, collision_samples_per_segment=samples)
    if holonomic:
        oracle, start, goal, bounds = cs.two_walls_world(2, CPU)
        solver = HolonomicSolver(cfg, circle_collision, device="cpu")
    else:
        oracle, start, goal, bounds = car_world(2, CPU)
        solver = ConstrainedSolver(cfg, rectangle_collision, device="cpu")
    state = solver.init_state(torch.Generator().manual_seed(0), start, goal, bounds, oracle)
    state, _ = solver.run(state, oracle, 10, torch.Generator().manual_seed(1))
    return solver, state, oracle, 2 if holonomic else 3, samples


def test_hold_path_kernels_takes_the_paths_own_shapes(path_state):
    solver, state, oracle, dim, samples = path_state
    held = cs.hold_path_kernels("a test", solver, state, oracle, 2)
    assert held["shapes"] == {"onf_forward": [2, 10 + 11, dim],
                              "field_grad": [2, 11 + 10 + 10, dim],
                              "collision": [2, 11 * samples, dim]}
    assert set(held["max_abs_err"]) == {"onf_forward", "field_grad", "collision_fwd",
                                        "collision_bwd"}


@pytest.mark.parametrize("wrong", ["onf_forward", "field_grad", "collision_fwd",
                                   "collision_bwd"])
def test_hold_path_kernels_rejects_a_kernel_off_its_plain_version(path_state, wrong,
                                                                  monkeypatch):
    """Each of the four checks fails when its kernel's output moves past the
    tolerance (a kernel that the CPU stands in for by its plain version)."""
    solver, state, oracle, _, _ = path_state
    if wrong == "onf_forward":
        monkeypatch.setattr(kernels, "onf_forward",
                            lambda *a: kernels.onf_forward_plain(*a) + 1e-2)
    elif wrong == "field_grad":
        def field_grad(*a):
            loss, grads = kernels.field_grad_plain(*a)
            return loss, tree_map(lambda t: t * 1.01, grads)
        monkeypatch.setattr(kernels, "field_grad", field_grad)
    else:
        class ScaledGrad(torch.autograd.Function):  # identity, its gradient x 1.01
            @staticmethod
            def forward(ctx, x):
                return x.clone()

            @staticmethod
            def backward(ctx, g):
                return g * 1.01

        def collision_terms(params, x, *a):
            if wrong == "collision_fwd":
                return tuple(t * 1.01 for t in kernels.collision_terms_plain(params, x, *a))
            return kernels.collision_terms_plain(params, ScaledGrad.apply(x), *a)

        monkeypatch.setattr(kernels, "collision_terms", collision_terms)
    with pytest.raises(AssertionError, match=f"a test {wrong}"):
        cs.hold_path_kernels("a test", solver, state, oracle, 2)


@pytest.fixture(scope="module")
def batch_path_state():
    """The bf16 batch path (run_batch, P=2): 4 problems 10 steps in, as
    (solver, state, oracle)."""
    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
    from nfopp_tpu_torch.solver import SolverConfig
    from nfopp_tpu_torch.tools.scene import car_world
    from nfopp_tpu_torch.worlds import rectangle_collision

    cfg = SolverConfig(trajectory_length=12, collision_point_count=10,
                       onf=ONFConfig(hidden=16, compute_dtype="bfloat16"),
                       init_collision_iteration=0, collision_samples_per_segment=2)
    oracle, start, goal, bounds = car_world(4, CPU)
    solver = ExperimentalConstrainedSolver(cfg, rectangle_collision, device="cpu")
    state = solver.init_state(torch.Generator().manual_seed(0), start, goal, bounds, oracle)
    state, _ = solver.run_batch(state, oracle, 10, torch.Generator().manual_seed(1),
                                problems_per_program=2)
    return solver, state, oracle


def test_hold_path_kernels_holds_the_batch_path_s_multi_problem_kernels(batch_path_state):
    held = cs.hold_path_kernels("a test", *batch_path_state, 2, problems_per_program=2)
    assert held["shapes"] == {"onf_multi": [4, 10 + 11, 3], "field_grad": [4, 11 + 10 + 10, 3],
                              "collision": [4, 11 * 2, 3]}
    assert set(held["max_abs_err"]) == {"onf_multi", "field_grad_multi", "collision_fwd",
                                        "collision_bwd"}


@pytest.mark.parametrize("wrong", ["onf_multi", "field_grad_multi"])
def test_hold_path_kernels_rejects_a_multi_problem_kernel_off_its_plain_version(
        batch_path_state, wrong, monkeypatch):
    if wrong == "onf_multi":
        monkeypatch.setattr(kernels, "onf_multi",
                            lambda p, x, c, n: kernels.onf_multi_plain(p, x, c) + 1e-2)
    else:
        def field_grad_multi(p, x, truth, c, n):
            loss, grads = kernels.field_grad_multi_plain(p, x, truth, c)
            return loss, tree_map(lambda t: t * 1.01, grads)
        monkeypatch.setattr(kernels, "field_grad_multi", field_grad_multi)
    with pytest.raises(AssertionError, match=f"a test {wrong}"):
        cs.hold_path_kernels("a test", *batch_path_state, 2, problems_per_program=2)


def test_bf16_other_side_crosses_the_nearest_rounding_boundary():
    a = torch.tensor([21.18750019744, -21.18750019744, 1.0, 3.046167612, -0.0142822265625 * 1.0001],
                     dtype=torch.float64)
    other, dist = cs.bf16_other_side(a)
    assert other.tolist()[:2] == [21.125, -21.125]  # 21.1875 is the boundary; rounds to 21.25
    assert float(dist[0]) == pytest.approx(9.3e-9, rel=1e-2) and float(dist[2]) == float("inf")
    assert cs.bf16_round(a[3]).item() == 3.046875 and other[3].item() == 3.03125
    assert all(float(o) != float(cs.bf16_round(v)) for o, v in zip(other, a))


def test_masked_forward_rounds_a_tied_activation_across():
    """("tie", "h2", point, unit) under onf_apply's casts moves that point's
    logit by exactly the rounding's step times the unit's bf16 output
    weight, and no other point's."""
    g = torch.Generator().manual_seed(9)
    params = init_onf_params(g, BF16, 1, CPU)
    p, x = one(params, torch.rand(1, M, 3, generator=g) * 3)
    record = {}
    base, _ = cs.masked_forward(p, x, BF16, casts="apply", record=record)
    h2 = record["activations"]["h2"][0, POINT]
    unit = int(torch.argmax(h2))
    tied, _ = cs.masked_forward(p, x, BF16, [("tie", "h2", POINT, unit)], casts="apply")
    other, _ = cs.bf16_other_side(h2[unit])
    step = float(other - cs.bf16_round(h2[unit]))
    assert step != 0.0
    moved = (tied - base)[0]
    assert float(moved[POINT]) == pytest.approx(
        step * float(cs.bf16_round(p["out"]["w"][0, unit, 0])), rel=1e-9)
    assert float(moved.abs().sum() - moved[POINT].abs()) == 0.0


def card_problem():
    """Problem 8 of chip_smoke.py phase 11f's field-gradient hold (the bf16
    anytime server on an H100): its field, training points and labels, and
    the kernel's gradients, whose h2 unit 97 at point 206 (f64 value
    21.1875002, a bf16 rounding boundary at 21.1875) the kernel rounded to
    21.125 and the plain version to 21.25."""
    data = np.load(pathlib.Path(__file__).parent / "data" / "field_grad_bf16_tie.npz")

    def tree(prefix):
        out = {}
        for key in data.files:
            if key.startswith(prefix + "/"):
                *path, leaf = key[len(prefix) + 1:].split("/")
                node = out
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = torch.tensor(data[key])[None]
        return out

    params = tree("params")
    return (params, torch.tensor(data["points"])[None], torch.tensor(data["truth"])[None],
            tree_leaves(tree("kernel")))


def test_hold_bf16_explains_the_card_s_activation_tie():
    """The card's kernel gradients of that problem miss the bf16 bound
    against the plain version; the f64 recomputation with h2 unit 97 at point
    206 rounded to the other side matches them, and without the rounding-tie
    explanation hold rejects them."""
    from nfopp_tpu_torch.solver import run_planner_config

    config = run_planner_config().onf._replace(compute_dtype="bfloat16")
    params, x, truth, got = card_problem()
    want = tree_leaves(kernels.field_grad_plain(params, x, truth, config)[1])
    tols = [GRAD_TOLS] * len(want)
    recompute = cs.field_grad_f64(truth, config, "apply")
    with pytest.raises(AssertionError, match=r"problems \[0\] outside"):
        cs.hold("no kinks", got, want, tols, bf16=True)
    assert cs.explain_by_kinks("card", 0, got, tols, params, x, config, recompute,
                               bf16=True) == [("tie", "h2", 206, 97)]
    kinks = (params, x, config, recompute)
    assert cs.hold("card", got, want, tols, kinks=kinks, bf16=True) > 5e-4
    saved = cs.rounding_ties
    cs.rounding_ties = lambda record: []
    try:
        with pytest.raises(AssertionError, match="farther from the f64 recomputation"):
            cs.hold("card, no rounding ties", got, want, tols, kinks=kinks, bf16=True)
    finally:
        cs.rounding_ties = saved
