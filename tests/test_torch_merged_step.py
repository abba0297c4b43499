"""The port's merged field+trajectory step (nfopp_tpu_torch.experimental.
merged_step, ExperimentalConstrainedSolver(merged_step=True)) against the JAX
package's, with JAX's own random draws handed to the port.

Setting of tests/test_merged_step.py: the two-walls SE(2) scene, a disc
robot of radius 0.3, N=12 waypoints, K=12 buffer points, R=4 random points,
the full-width angle-encoded field. Checked: the forward activations and the
hand-written backward (with and without angle features, and without cos
features); one merged step of 2 problems in f32 (S = 1 and 3 collision
samples per segment) and in bf16; 20 grouped steps; and a saturated field,
where JAX's merged step, which resamples the replay buffer without the
`buffer_weight_floor` term, keeps the buffer peaked while the Jacobi order
resamples near-uniformly: the port copies JAX's merged step there too.

bf16 tolerance (ROADMAP.md section 3): at most max(2, 1%) of an output's
elements past the f32 bound, each within 2^-7 of the output's largest
magnitude (a product whose two f32 sums round to neighbouring bf16 values).

Run as a script, the file solves the car scene with JAX's merged solver on
the CPU and prints its feasible fraction (see `main`), for the statistical
comparison with chip_smoke.py's merged cell.
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.experimental import ExperimentalConstrainedSolver as JaxExperimentalSolver
from nfopp_tpu.experimental import merged_step as jax_merged
from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.models import init_onf_params as jax_init
from nfopp_tpu.solver import SolverConfig as JaxSolverConfig
from nfopp_tpu.worlds import CircleOracle as JaxCircleOracle
from nfopp_tpu.worlds import circle_collision as jax_circle_collision
from nfopp_tpu_torch import kernels
from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
from nfopp_tpu_torch.experimental import merged_step
from nfopp_tpu_torch.models import ONFConfig, params_from_jax
from nfopp_tpu_torch.ops.sampling import GeneratorNoise
from nfopp_tpu_torch.solver import SolverConfig, state_from_jax
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    circle_collision,
    pad_obstacle_points,
    two_walls_se2_environment,
)
from torch_threads import one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
ACT_TOLS = (2e-4, 2e-5)  # tests/test_merged_step.py:27


@pytest.fixture(autouse=True)
def no_launches():
    """The merged step launches none of the port's kernels (and on CPU
    tensors no wrapper counts one)."""
    kernels.reset_launches()
    yield
    assert all(count == 0 for count in kernels.LAUNCHES.values()), kernels.LAUNCHES


def configs(compute_dtype="float32", **kwargs):
    """The JAX config of tests/test_merged_step.py and the port's copy of it."""
    jcfg = JaxSolverConfig(
        trajectory_length=12, collision_point_count=12, random_field_points=4,
        onf=JaxONFConfig(angle_encoding=True, compute_dtype=compute_dtype), angle_offset=0.3,
        **kwargs,
    )
    return jcfg, SolverConfig(**{**jcfg._asdict(), "onf": ONFConfig(**jcfg.onf._asdict())})


class ReplayNoise:
    """Noise source that hands out pre-drawn arrays in call order."""

    def __init__(self):
        self.queue = []

    def push(self, kind, array):
        self.queue.append((kind, np.asarray(array, np.float32)))

    def _next(self, kind, shape, device):
        want, array = self.queue.pop(0)
        assert want == kind and array.shape == tuple(shape), (want, kind, array.shape, shape)
        return torch.tensor(array, device=device)

    def uniform(self, shape, device):
        return self._next("uniform", shape, device)

    def normal(self, shape, device):
        return self._next("normal", shape, device)


def replay(cfg, keys, steps):
    """JAX's per-problem draws for `steps` steps (constrained.py:316 and
    field.py:74-87 for the field, merged_step.py:248 for t), queued in the
    port's call order."""
    n, k, r = cfg.trajectory_length, cfg.collision_point_count, cfg.random_field_points

    def draws(key):
        key, k_field, k_traj = jax.random.split(key, 3)
        k_uni, k_norm = jax.random.split(k_field, 2)
        u = jax.random.uniform(k_uni, ((n - 1) + (k + n - 1) + r * 3,), jnp.float32)
        normal = jax.random.normal(k_norm, (2, n - 1, 3), jnp.float32)
        t = jax.random.uniform(k_traj, (n - 1, cfg.collision_samples_per_segment), jnp.float32)
        return key, u, normal, t

    noise = ReplayNoise()
    for _ in range(steps):
        keys, u, normal, t = jax.vmap(draws)(keys)
        noise.push("uniform", u)
        noise.push("normal", normal)
        noise.push("uniform", t)
    return noise


@pytest.fixture(scope="module")
def world():
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    jax_oracle = JaxCircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.3),
                                 jnp.asarray(bounds))
    oracle = CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], torch.tensor([0.3]),
                          torch.tensor(bounds)[None])
    return {"env": env, "jax_oracle": jax_oracle, "oracle": oracle}


def jax_batch(world, batch):
    return jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (batch,) + (1,) * x.ndim),
                                  world["jax_oracle"])


def jax_states(solver, world, key=2, batch=2):
    env = world["env"]
    keys = jax.random.split(jax.random.PRNGKey(key), batch)
    return jax.jit(jax.vmap(lambda k: solver.init_state(
        k, jnp.asarray(env.start), jnp.asarray(env.goal), jnp.asarray(env.bounds, jnp.float32),
        world["jax_oracle"])))(keys)


def to_port(jax_state):
    return state_from_jax(jax.tree_util.tree_map(np.asarray, jax_state), device="cpu")


def assert_close(got, want, tols, dtype="float32", name=""):
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


# ------------------------------------------------ forward acts and backward


@pytest.mark.parametrize("onf", [
    {"angle_encoding": True},
    {"angle_encoding": False},
    {"use_cos": False, "angle_encoding": True},
], ids=["angle", "no_angle", "no_cos"])
def test_forward_acts_and_backward_match_jax(onf):
    """tests/test_merged_step.py::TestONFBackward's inputs (23 points, the
    parameter rows [:15]) for two problems: every saved activation, the
    parameter gradients and the position gradients against JAX's."""
    jcfg = JaxONFConfig(**onf)
    cfg = ONFConfig(**jcfg._asdict())
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jparams = jax.vmap(lambda k: jax_init(k, jcfg))(keys)
    x = jax.random.uniform(jax.random.PRNGKey(4), (2, 23, 3), minval=-2.0, maxval=2.0)
    g = jax.random.normal(jax.random.PRNGKey(5), (2, 23, 1))
    p = 15

    def jax_side(params, xs, gs):
        acts = jax_merged.onf_forward_acts(params, xs, jcfg)
        return acts, jax_merged.onf_backward(params, acts, gs, p, jcfg)

    want_acts, (want_grads, want_pos) = jax.vmap(jax_side)(jparams, x, g)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    acts = merged_step.onf_forward_acts(params, torch.tensor(np.asarray(x)), cfg)
    grads, pos = merged_step.onf_backward(params, acts, torch.tensor(np.asarray(g)), p, cfg)

    for name in acts._fields:
        got, want = getattr(acts, name), getattr(want_acts, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert_close(got.numpy(), want, ACT_TOLS, name=name)
    assert list(grads) == list(params)  # the parameters' layout and order
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads), device="cpu")
    for (got, want), name in zip(zip(tree_leaves(grads), tree_leaves(want_grads)),
                                 ("encoding", "mlp1", "mlp2", "out", "angle")):
        assert_close(got.numpy(), want.numpy(), ACT_TOLS, name=name)
    assert tuple(pos.shape) == (2, 23 - p, 3)
    assert_close(pos.numpy(), want_pos, ACT_TOLS, name="positions")
    if not cfg.angle_encoding:
        assert (pos[..., 2] == 0).all()


# ------------------------------------------------------------ one step


def assert_same_buffer(got, want):
    """The same picks: equal ages, and the picked candidates within the f32
    rounding of their jitter (XLA may fuse the segment lerp's products)."""
    np.testing.assert_array_equal(got.buffer_ages.numpy(), np.asarray(want.buffer_ages))
    np.testing.assert_allclose(got.buffer_points.numpy(), np.asarray(want.buffer_points),
                               rtol=1e-6, atol=1e-6)


def check_step(got, want, aux, want_aux):
    """The same replay buffer; every other leaf within
    test_jacobi_step_matches_jax's tolerances (tests/test_torch_experimental.py)."""
    assert_same_buffer(got, want)
    for name in got._fields:
        # from init, Adam's first update lr * g / (|g| + eps) turns
        # rounding-level differences of a near-zero gradient into parameter
        # differences of up to ~1e-4
        tols = (0.0, 1e-3) if name == "field_params" else (1e-4, 1e-5)
        for g, w in zip(tree_leaves(getattr(got, name)), tree_leaves(getattr(want, name))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), *tols, err_msg=name)
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(want_aux.field_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(aux.trajectory_loss.numpy(),
                               np.asarray(want_aux.trajectory_loss), rtol=1e-5)


@pytest.mark.parametrize("samples", [1, 3])
def test_merged_step_matches_jax(world, samples):
    """One merged step of 2 problems (then the step-0 reparametrization)
    against JAX's merged step under vmap, with JAX's draws; S collision
    samples per segment."""
    jcfg, cfg = configs(collision_samples_per_segment=samples)
    jax_solver = JaxExperimentalSolver(jcfg, jax_circle_collision, merged_step=True)
    states = jax_states(jax_solver, world)
    ref, ref_aux = jax.jit(jax.vmap(jax_solver.step))(states, jax_batch(world, 2))
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, merged_step=True, device="cpu")
    noise = replay(jcfg, states.key, 1)
    got, aux = solver.step(to_port(states), world["oracle"], noise)
    assert not noise.queue
    check_step(got, to_port(ref), aux, ref_aux)


def test_bf16_merged_step_matches_jax(world):
    """JAX's merged step with compute_dtype='bfloat16' (its `_mm` casts both
    operands and accumulates in f32): the partial step's field gradients and
    losses at the bf16 tie rule, the same replay buffer, and the trajectory
    update (which reads the bf16 position gradients) at the one-step
    tolerances of the f32 test."""
    jcfg, cfg = configs("bfloat16")
    jax_solver = JaxExperimentalSolver(jcfg, jax_circle_collision, merged_step=True)
    states = jax_states(jax_solver, world)

    def partial(state, oracle):
        _, k_field, k_traj = jax.random.split(state.key, 3)
        return jax_merged.merged_partial_step(jax_solver, state, oracle, k_field, k_traj)

    ref, ref_grads, ref_field_loss, ref_traj_loss = jax.jit(jax.vmap(partial))(
        states, jax_batch(world, 2))
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, merged_step=True, device="cpu")
    noise = replay(jcfg, states.key, 1)
    got, grads, field_loss, traj_loss = merged_step.merged_partial_step(
        solver, to_port(states), world["oracle"], noise)
    assert not noise.queue
    want = to_port(ref)
    assert_same_buffer(got, want)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), device="cpu")
    for g, w in zip(tree_leaves(grads), tree_leaves(want_grads)):
        assert_close(g.numpy(), w.numpy(), ACT_TOLS, "bfloat16", "field grads")
    assert_close(field_loss.numpy(), ref_field_loss, (1e-5, 1e-6), "bfloat16", "field loss")
    assert_close(traj_loss.numpy(), ref_traj_loss, (1e-5, 1e-6), "bfloat16", "trajectory loss")
    for name in ("trajectory", "constraint_multipliers", "collision_multipliers"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   1e-4, 1e-5, err_msg=name)
    for g, w in zip(tree_leaves(got.field_params), tree_leaves(want.field_params)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())  # the entry field


# ------------------------------------------------------------ grouped mode


def test_grouped_merged_matches_jax(world):
    """20 steps of 4 problems in groups of 2 (one field_key per group, as
    BatchPlanner.init_batch_grouped gives): the port's run_grouped against
    JAX's with its draws (trajectory atol 2e-3, the bound of the port's
    20-step runs), replicas bit-identical within a group and distinct
    across; and group_size=1 is `run` bit for bit."""
    jcfg, cfg = configs()
    jax_solver = JaxExperimentalSolver(jcfg, jax_circle_collision, merged_step=True)
    env = world["env"]
    k_problems, k_fields = jax.random.split(jax.random.PRNGKey(1))
    keys = jax.random.split(k_problems, 4)
    field_keys = jnp.repeat(jax.random.split(k_fields, 2), 2, axis=0)
    states = jax.jit(jax.vmap(lambda k, f: jax_solver.init_state(
        k, jnp.asarray(env.start), jnp.asarray(env.goal), jnp.asarray(env.bounds, jnp.float32),
        world["jax_oracle"], field_key=f)))(keys, field_keys)
    ref, ref_aux = jax.jit(lambda s: jax_solver.run_grouped(s, jax_batch(world, 4), 20, 2))(
        states)

    solver = ExperimentalConstrainedSolver(cfg, circle_collision, merged_step=True, device="cpu")
    noise = replay(jcfg, states.key, 20)
    start = to_port(states)
    got, aux = solver.run_grouped(start, world["oracle"], 20, 2, noise)
    assert not noise.queue
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(ref_aux.field_loss), rtol=1e-3)
    for leaf in tree_leaves((got.field_params, got.field_opt_state)):
        grouped = leaf.reshape((2, 2) + tuple(leaf.shape[1:]))
        assert torch.equal(grouped, grouped[:, :1].expand_as(grouped))
    assert all(not torch.equal(p[0], p[2]) for p in tree_leaves(got.field_params))

    one, one_aux = solver.run_grouped(start, world["oracle"], 20, 1,
                                      GeneratorNoise(torch.Generator().manual_seed(3)))
    plain, plain_aux = solver.run(start, world["oracle"], 20,
                                  GeneratorNoise(torch.Generator().manual_seed(3)))
    for a, b in zip(tree_leaves((one, one_aux)), tree_leaves((plain, plain_aux))):
        assert torch.equal(a, b)


# ------------------------------------------------- the missing weight floor


def test_saturated_field_merged_keeps_jax_s_buffer_not_jacobi_s(world):
    """With the field's output bias at -30 every candidate's weight
    sigmoid(z) is below buffer_weight_floor (1e-6). JAX's merged step has no
    floor (merged_step.py:274): the port's merged buffer equals JAX's merged
    buffer, and differs from the port's Jacobi buffer, which the floor
    spreads near-uniformly over the candidates."""
    jcfg, cfg = configs()
    jax_solver = JaxExperimentalSolver(jcfg, jax_circle_collision, merged_step=True)
    states = jax_states(jax_solver, world)
    out = dict(states.field_params["out"], b=jnp.full_like(states.field_params["out"]["b"], -30.0))
    states = states._replace(field_params={**states.field_params, "out": out})
    ref, _ = jax.jit(jax.vmap(jax_solver.step))(states, jax_batch(world, 2))

    start = to_port(states)
    assert float(torch.sigmoid(merged_step.onf_forward_acts(
        start.field_params, start.buffer_points, cfg.onf).logits).max()) < cfg.buffer_weight_floor
    merged = ExperimentalConstrainedSolver(cfg, circle_collision, merged_step=True, device="cpu")
    got, _ = merged.step(start, world["oracle"], replay(jcfg, states.key, 1))
    assert_same_buffer(got, ref)

    jacobi = ExperimentalConstrainedSolver(cfg, circle_collision, jacobi_step=True, device="cpu")
    other, _ = jacobi.step(start, world["oracle"], replay(jcfg, states.key, 1))
    assert not torch.equal(other.buffer_points, got.buffer_points)
    # the trajectory update reads the same entry field in both orders
    torch.testing.assert_close(other.trajectory, got.trajectory, rtol=1e-4, atol=1e-5)


def test_merged_runs_with_generator_noise(world):
    """`run` with a seeded generator: 20 finite steps, losses [B, 20]."""
    _, cfg = configs()
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, merged_step=True, device="cpu")
    env = world["env"]
    ends = [np.tile(np.asarray(a, np.float32)[None], (2, 1))
            for a in (env.start, env.goal, env.bounds)]
    state = solver.init_state(torch.Generator().manual_seed(0), *ends, world["oracle"])
    state, aux = solver.run(state, world["oracle"], 20,
                            GeneratorNoise(torch.Generator().manual_seed(1)))
    assert torch.isfinite(state.trajectory).all()
    assert tuple(aux.field_loss.shape) == (2, 20) and torch.isfinite(aux.field_loss).all()
    assert all(torch.isfinite(leaf).all() for leaf in tree_leaves(state.field_params))
    assert tuple(state.field_params["out"]["w"].shape) == (2, 320, 1)


# ------------------------------------ feasibility of the JAX merged solver


def main() -> None:
    """JAX's merged solver (ExperimentalConstrainedSolver(merged_step=True))
    on the car scene with run_planner_config in f32 and the rectangle
    footprint of chip_smoke.py, vmapped over `--problems` problems x
    `--steps` steps on the CPU; prints one JSON line. The port's counterpart
    is chip_smoke.py's merged-f32 cell."""
    from nfopp_tpu.solver import run_planner_config as jax_run_planner_config
    from nfopp_tpu.solver.tracking import evaluate_path as jax_evaluate_path
    from nfopp_tpu.worlds import RectangleOracle as JaxRectangleOracle
    from nfopp_tpu.worlds import car_environment as jax_car_environment
    from nfopp_tpu.worlds import pad_obstacle_points as jax_pad
    from nfopp_tpu.worlds import rectangle_collision as jax_rectangle_collision

    parser = argparse.ArgumentParser(description=main.__doc__.split(";")[0])
    parser.add_argument("--problems", type=int, default=16)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")

    env = jax_car_environment()
    pts, mask = jax_pad(env.obstacle_points.astype(np.float32), 64)
    oracle = JaxRectangleOracle(jnp.asarray(pts), jnp.asarray(mask),
                                jnp.asarray([-0.3, 0.2, -0.3, 0.2], jnp.float32),
                                jnp.asarray([0.0, 3.0, 0.0, 3.0], jnp.float32))
    solver = JaxExperimentalSolver(jax_run_planner_config(), jax_rectangle_collision,
                                   merged_step=True)

    @jax.jit
    def solve(keys):
        states = jax.vmap(lambda k: solver.init_state(
            k, jnp.asarray(env.start), jnp.asarray(env.goal),
            jnp.asarray(env.bounds, jnp.float32), oracle))(keys)
        states, _ = jax.vmap(lambda s: solver.run(s, oracle, args.steps))(states)
        paths = jax.vmap(solver.full_trajectory)(states)
        return jax.vmap(lambda p: jax_evaluate_path(jax_rectangle_collision, oracle, p))(paths)

    t0 = time.perf_counter()
    collides, length = solve(jax.random.split(jax.random.PRNGKey(args.seed), args.problems))
    collides = np.asarray(collides)
    feasible = float((~collides).mean())
    print(json.dumps({
        "jax_merged": {
            "problems": args.problems, "steps": args.steps, "seed": args.seed,
            "feasible_fraction": feasible,
            "feasible_count": int((~collides).sum()),
            "mean_length_feasible": (float(np.asarray(length)[~collides].mean())
                                     if feasible else None),
            "seconds_cpu": time.perf_counter() - t0,
        }}))


if __name__ == "__main__":
    main()
