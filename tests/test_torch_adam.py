"""The optimizer's update (`solver/adam.py::adam_update` over
`kernels.adam_leaves`) on the CPU. A NumPy f32 emulation of the CUDA
kernel's op order (csrc/adam.cu: one rounding per operation, no fused
multiply-add) equals `adam_update` bit for bit, so the kernel, which
chip_smoke.py holds against the plain version on the card, computes today's
formula; the wrapper's CPU path is the plain formula and launches nothing.

One operation is the platform's: PyTorch's vectorized CPU square root is not
always correctly rounded (on AVX-512 it misses by an ulp for about 0.6% of
inputs), so the emulation takes its square root from `torch.sqrt` on the CPU.
On the card `torch.sqrt` and the kernel's `__fsqrt_rn` both round correctly."""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nfopp_tpu_torch import kernels
from nfopp_tpu_torch.kernels import adam as kernel_adam
from nfopp_tpu_torch.kernels import build
from nfopp_tpu_torch.models import init_onf_params
from nfopp_tpu_torch.solver import (
    AdamState, ConstrainedSolver, adam_init, adam_update, run_planner_config,
)
from nfopp_tpu_torch.solver import adam as adam_module
from nfopp_tpu_torch.tools.scene import car_world
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map
from nfopp_tpu_torch.worlds import rectangle_collision
from torch_threads import one_thread  # noqa: F401

CONFIG = run_planner_config()
ROWS = 3
F32 = np.float32


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors the wrapper never counts a launch."""
    kernels.reset_launches()
    yield
    assert kernels.LAUNCHES["adam"] == 0, kernels.LAUNCHES


def car_trees(rows: int, seed: int = 0) -> dict:
    """The car field's 9 leaves and the trajectory [rows, 100, 3]."""
    g = torch.Generator().manual_seed(seed)
    field = init_onf_params(g, CONFIG.onf, rows)
    trajectory = torch.randn((rows, CONFIG.trajectory_length, 3), generator=g)
    return {"field": field, "trajectory": trajectory}


def cpu_sqrt(x: np.ndarray) -> np.ndarray:
    """The square root as PyTorch rounds it on this CPU (same shape, so the
    same split between vector lanes and scalar tail)."""
    return torch.sqrt(torch.from_numpy(x)).numpy()


def emulate(g, m, v, p, bc1, bc2, lr, b1, b2, eps, sqrt=cpu_sqrt):
    """The kernel's arithmetic in NumPy f32, one rounding per operation, the
    scalars rounded once from the Python doubles; bc1, bc2 [rows]."""
    shape = (-1,) + (1,) * (p.ndim - 1)
    c1, c2 = bc1.reshape(shape), bc2.reshape(shape)
    with np.errstate(all="ignore"):
        m_out = F32(1 - b1) * g + F32(b1) * m
        v_out = F32(1 - b2) * (g * g) + F32(b2) * v
        step = (m_out / c1) / (sqrt(v_out / c2) + F32(eps))
        p_out = p + F32(-lr) * step
    for a in (m_out, v_out, p_out):
        assert a.dtype == np.float32
    return p_out, m_out, v_out


def today(grads, state, params, lr, b1, b2, eps):
    """`adam_update` as the solver wrote it before the kernel: one PyTorch
    operation at a time, leaf by leaf."""
    count = state.count + 1
    steps = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), steps)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), steps)
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)

    def step(p, m, v):
        shape = (-1,) + (1,) * (p.ndim - 1)
        return p + (-lr) * ((m / bc1.reshape(shape)) / (torch.sqrt(v / bc2.reshape(shape)) + eps))

    return tree_map(step, params, mu, nu), AdamState(count, mu, nu)


def bits(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32)


def assert_same_bits(got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want), strict=True)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{what}, leaf {i}")


def random_state(params, counts, seed: int, scale: float = 1e-2) -> tuple:
    """Gradients and an Adam state with moments of plausible size, each row
    at its own step count."""
    g = torch.Generator().manual_seed(seed)

    def normal(p, s):
        return s * torch.randn(p.shape, generator=g)

    grads = tree_map(lambda p: normal(p, scale), params)
    mu = tree_map(lambda p: normal(p, scale), params)
    nu = tree_map(lambda p: normal(p, scale * scale).abs(), params)
    return grads, AdamState(torch.tensor(counts, dtype=torch.int32), mu, nu)


def check_against_emulation(grads, state, params, lr, b1, b2, eps) -> None:
    new_params, new_state = adam_update(grads, state, params, lr, b1, b2, eps)
    steps = (state.count + 1).to(torch.float32)
    bc1 = (1 - torch.pow(torch.tensor(b1, dtype=torch.float32), steps)).numpy()
    bc2 = (1 - torch.pow(torch.tensor(b2, dtype=torch.float32), steps)).numpy()
    for i, leaf in enumerate(zip(*(tree_leaves(t) for t in (grads, state.mu, state.nu, params)))):
        want = emulate(*(t.numpy() for t in leaf), bc1, bc2, lr, b1, b2, eps)
        got = [tree_leaves(t)[i] for t in (new_params, new_state.mu, new_state.nu)]
        for name, a, b in zip(("params", "mu", "nu"), got, want):
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{name}, leaf {i}")
    assert torch.equal(new_state.count, state.count + 1)


RATES = {"field": (CONFIG.collision_lr, *CONFIG.collision_betas),
         "trajectory": (CONFIG.trajectory_lr, *CONFIG.trajectory_betas)}


@pytest.mark.parametrize("tree", ["field", "trajectory"])
@pytest.mark.parametrize("counts", [(0, 1, 2), (9, 99, 999), (0, 499, 999)])
def test_kernel_arithmetic_equals_adam_update(tree, counts):
    """(a) The kernel's op order in NumPy f32 equals `adam_update` bit for
    bit on the car field's leaves and the trajectory, rows at steps 1..1000."""
    params = car_trees(ROWS)[tree]
    grads, state = random_state(params, counts, seed=sum(counts) + len(tree))
    lr, b1, b2 = RATES[tree]
    check_against_emulation(grads, state, params, lr, b1, b2, CONFIG.adam_eps)


@pytest.mark.parametrize("edge", ["zero", "subnormal", "huge"])
def test_kernel_arithmetic_at_edges(edge):
    """(a) The same at the edges: g = 0 with m = v = 0 (the update is -0),
    subnormal g (g * g underflows), |g| near 1e30 (g * g overflows to inf and
    the update is 0), with the classic betas (0.9, 0.999) too."""
    params = car_trees(ROWS, seed=1)["field"]
    grads, state = random_state(params, (0, 3, 999), seed=2)
    if edge == "zero":
        grads = tree_map(torch.zeros_like, grads)
        state = state._replace(mu=tree_map(torch.zeros_like, grads),
                               nu=tree_map(torch.zeros_like, grads))
    else:
        value = 3e-41 if edge == "subnormal" else 9.9e29
        signs = tree_map(lambda g: torch.where(g < 0, -1.0, 1.0), grads)
        grads = tree_map(lambda s: s * value, signs)
        assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    for lr, b1, b2 in (RATES["field"], (1e-3, 0.9, 0.999)):
        check_against_emulation(grads, state, params, lr, b1, b2, CONFIG.adam_eps)


@pytest.mark.parametrize("tree", ["field", "trajectory"])
def test_wrapper_on_cpu_is_todays_formula(tree):
    """(b) On CPU leaves the wrapper and `adam_update` return what the
    per-leaf PyTorch formula returned, bit for bit, and launch nothing (the
    autouse fixture holds LAUNCHES["adam"] at 0)."""
    params = car_trees(ROWS, seed=3)[tree]
    grads, state = random_state(params, (0, 7, 999), seed=4)
    lr, b1, b2 = RATES[tree]
    want_params, want_state = today(grads, state, params, lr, b1, b2, CONFIG.adam_eps)
    got_params, got_state = adam_update(grads, state, params, lr, b1, b2, CONFIG.adam_eps)
    assert_same_bits(got_params, want_params, "params")
    assert_same_bits(got_state, want_state, "state")
    steps = (state.count + 1).to(torch.float32)
    bc1, bc2 = (1 - torch.pow(torch.tensor(b, dtype=torch.float32), steps) for b in (b1, b2))
    direct = kernels.adam_leaves(grads, state.mu, state.nu, params, bc1, bc2, lr, b1, b2,
                                 CONFIG.adam_eps)
    assert_same_bits(direct, (want_params, want_state.mu, want_state.nu), "adam_leaves")
    plain = kernels.adam_leaves_plain(grads, state.mu, state.nu, params, bc1, bc2, lr, b1, b2,
                                      CONFIG.adam_eps)
    assert_same_bits(plain, direct, "adam_leaves_plain")
    # out of place: the inputs keep their values
    assert_same_bits(state, random_state(params, (0, 7, 999), seed=4)[1], "old state")


def test_grouped_rows_take_the_same_path(monkeypatch):
    """(c) A leading dimension of groups (G rows of count, one shared field
    each) goes through `adam_leaves` once per update, with bias corrections
    [G], and equals the emulation."""
    groups = 2
    params = car_trees(groups, seed=5)["field"]
    state = adam_init(params)
    assert tuple(state.count.shape) == (groups,)
    calls = []

    def spy(*args):
        calls.append(tuple(args[4].shape))
        return kernels.adam_leaves(*args)

    monkeypatch.setattr(adam_module, "adam_leaves", spy)
    lr, b1, b2 = RATES["field"]
    for step in range(3):
        grads, _ = random_state(params, (0,) * groups, seed=6 + step)
        check_against_emulation(grads, state, params, lr, b1, b2, CONFIG.adam_eps)
        params, state = adam_update(grads, state, params, lr, b1, b2, CONFIG.adam_eps)
    assert calls == [(groups,)] * 6 and state.count.tolist() == [3, 3]


def test_the_solver_hands_over_contiguous_leaves(monkeypatch):
    """Every leaf the solver hands to `adam_leaves` is contiguous float32
    with a row per count, as the kernel takes them: a caller's trajectory
    given as a strided view (the suite passes its wavefront paths so) and
    the group-mean gradients of one field shared by the whole batch (a
    stride-0 view before they are made contiguous)."""
    seen = []

    def spy(*args):
        rows = args[4].shape[0]
        seen.extend((t.dtype, t.is_contiguous(), t.shape[0] == rows)
                    for tree in args[:4] for t in tree_leaves(tree))
        return kernels.adam_leaves(*args)

    monkeypatch.setattr(adam_module, "adam_leaves", spy)
    batch = 4
    cfg = CONFIG._replace(onf=CONFIG.onf._replace(hidden=8), init_collision_iteration=2)
    solver = ConstrainedSolver(cfg, rectangle_collision, device="cpu")
    oracle, start, goal, bounds = car_world(batch, "cpu")
    wide = torch.zeros((batch, cfg.trajectory_length + 2, 3))
    wide += torch.linspace(0, 1, cfg.trajectory_length + 2)[None, :, None]
    strided = wide[:, 1:-1]
    assert not strided.is_contiguous()
    g = torch.Generator().manual_seed(0)
    state = solver.init_state(g, start, goal, bounds, oracle, trajectory=strided)
    solver.run(state, oracle, 2, g)
    grouped = solver.init_state(g, start, goal, bounds, oracle, group_size=batch)
    solver.run_grouped(grouped, oracle, cfg.reparametrize_trajectory_freq, batch, g)
    assert len(seen) > 0 and set(seen) == {(torch.float32, True, True)}


# A stand-in for the CUDA runtime, enough to build csrc/adam.cu for the CPU:
# IEEE f32 operations one at a time (g++ -ffp-contract=off), blocks and
# threads run one after another.
CUDA_STAND_IN = r"""
#pragma once
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __restrict__
struct alignas(16) float4 { float x, y, z, w; };
struct dim3 { unsigned x = 0; };
inline dim3 gridDim, blockIdx, threadIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
"""


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """csrc/adam.cu built for the CPU with g++ against CUDA_STAND_IN, its
    launch rewritten as a loop over the grid's blocks and threads."""
    source = (pathlib.Path(build.CSRC) / "adam.cu").read_text()
    launch = re.search(r"nf::adam_kernel<<<(.*?), (.*?), 0,\s*.*?>>>\((.*?)\);", source, re.S)
    blocks, threads, args = launch.groups()
    serial = (f"gridDim.x = {blocks}; for (unsigned block_ = 0; block_ < gridDim.x; ++block_) "
              f"for (unsigned thread_ = 0; thread_ < unsigned({threads}); ++thread_) {{ "
              f"blockIdx.x = block_; threadIdx.x = thread_; nf::adam_kernel({args}); }}")
    source = source[:launch.start()] + serial + source[launch.end():]
    tmp = tmp_path_factory.mktemp("adam_cpu")
    (tmp / "cuda_runtime.h").write_text(CUDA_STAND_IN)
    (tmp / "adam.cpp").write_text(source.replace("#pragma unroll", ""))
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    f"-I{tmp}", str(tmp / "adam.cpp"), "-o", str(tmp / "libadam.so")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(tmp / "libadam.so"))
    lib.nf_adam.argtypes, lib.nf_adam.restype = build.PROTOTYPES["nf_adam"], ctypes.c_int
    return lib


def one_float_off(t: torch.Tensor) -> torch.Tensor:
    """`t` in memory that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("rows", [1, 5, 17])
@pytest.mark.parametrize("layout", ["aligned", "one float off"])
def test_kernel_source_on_the_cpu(kernel_on_cpu, rows, layout):
    """The kernel's own source, built for the CPU, equals the emulation with
    a correctly rounded square root bit for bit, through the wrapper's
    launch: the car field's 9 leaves, the trajectory and 10 more leaves
    [rows, 1..10] in one tree of 20 (two launches), rows at steps 1..1000,
    gradients of 1e-2, subnormal, near 1e30, zero and 1; row sizes of 1,
    5, 10 and 300 straddle quads, and one float off 16 bytes every quad
    moves element by element."""
    trees = car_trees(rows, seed=rows)
    params = tree_leaves(trees["field"]) + [trees["trajectory"]] + [
        torch.randn(rows, k) for k in range(1, 11)]
    g = torch.Generator().manual_seed(rows)
    scales = (1e-2, 3e-41, 9.9e29, 0.0, 1.0)
    leaves = []
    for i, p in enumerate(params):
        grads = scales[i % len(scales)] * torch.randn(p.shape, generator=g)
        mu, nu = 1e-2 * torch.randn(p.shape, generator=g), 1e-4 * torch.rand(p.shape, generator=g)
        place = one_float_off if layout == "one float off" else torch.clone
        leaves.append(tuple(place(t) for t in (grads, mu, nu, p)))
    assert (leaves[0][0].data_ptr() % 16 != 0) == (layout == "one float off")
    lr, b1, b2 = RATES["field"][0], 0.9, 0.999
    steps = (1 + torch.arange(rows) * 383 % 1000).to(torch.float32)
    bc1, bc2 = (1 - torch.pow(torch.tensor(b, dtype=torch.float32), steps) for b in (b1, b2))
    outs = kernel_adam.launch_adam(kernel_on_cpu, leaves, bc1, bc2, lr, b1, b2, CONFIG.adam_eps,
                                   None)
    assert kernels.LAUNCHES["adam"] == 2
    kernels.reset_launches()
    for i, (leaf, out) in enumerate(zip(leaves, outs, strict=True)):
        p_out, m_out, v_out = emulate(*(t.numpy() for t in leaf), bc1.numpy(), bc2.numpy(), lr,
                                      b1, b2, CONFIG.adam_eps, sqrt=np.sqrt)
        for name, got, want in zip(("mu", "nu", "params"), out, (m_out, v_out, p_out)):
            np.testing.assert_array_equal(bits(got), bits(want), err_msg=f"{name}, leaf {i}")

