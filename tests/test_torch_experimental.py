"""The port's ExperimentalConstrainedSolver (nfopp_tpu_torch.experimental)
against the JAX package's, with JAX's own random draws handed to the port:
run_batch in f32 and with a static field stride over 10 steps, one bf16 step
of the batch-explicit path, jacobi_step, and the validations (merged_step
has its own file, tests/test_torch_merged_step.py).

Setting of tests/test_run_batch.py: two-walls SE(2) scene, disc robot of
radius 0.3, N=12 waypoints, K=12 buffer points, R=4 random points, the
full-width angle-encoded field, B=4 problems, P=2 problems per program. The
JAX multi-problem kernels run in Pallas interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.experimental import ExperimentalConstrainedSolver as JaxExperimentalSolver
from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.solver import SolverConfig as JaxSolverConfig
from nfopp_tpu.worlds import CircleOracle as JaxCircleOracle
from nfopp_tpu.worlds import circle_collision as jax_circle_collision
from nfopp_tpu_torch import kernels
from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver
from nfopp_tpu_torch.experimental.merged_step import merged_field_and_trajectory
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.ops.sampling import GeneratorNoise
from nfopp_tpu_torch.solver import ConstrainedSolver, SolverConfig, state_from_jax
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    circle_collision,
    pad_obstacle_points,
    two_walls_se2_environment,
)
from torch_threads import one_thread  # noqa: F401

BATCH, P = 4, 2


def configs(compute_dtype="float32", **kwargs):
    """The JAX config and the port's copy of it."""
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


def replay(cfg, keys, steps, field_steps=None):
    """JAX's per-problem draws for `steps` steps (constrained.py:316 and :431,
    field.py:74-87), queued for the port in its call order; only the steps in
    `field_steps` (default: all) draw field noise."""
    n, k, r = cfg.trajectory_length, cfg.collision_point_count, cfg.random_field_points

    def draws(key):
        key, k_field, k_traj = jax.random.split(key, 3)
        k_uni, k_norm = jax.random.split(k_field, 2)
        u = jax.random.uniform(k_uni, ((n - 1) + (k + n - 1) + r * 3,), jnp.float32)
        normal = jax.random.normal(k_norm, (2, n - 1, 3), jnp.float32)
        t = jax.random.uniform(k_traj, (n - 1, cfg.collision_samples_per_segment), jnp.float32)
        return key, u, normal, t

    noise = ReplayNoise()
    for i in range(steps):
        keys, u, normal, t = jax.vmap(draws)(keys)
        if field_steps is None or i in field_steps:
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
    jax_oracles = jax.tree_util.tree_map(
        lambda x: jnp.tile(x[None], (BATCH,) + (1,) * x.ndim), jax_oracle)
    oracle = CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], torch.tensor([0.3]),
                          torch.tensor(bounds)[None])
    return {"env": env, "jax_oracle": jax_oracle, "jax_oracles": jax_oracles, "oracle": oracle}


def jax_states(solver, world, key=0, batch=BATCH):
    env = world["env"]
    keys = jax.random.split(jax.random.PRNGKey(key), batch)
    return jax.jit(jax.vmap(lambda k: solver.init_state(
        k, jnp.asarray(env.start), jnp.asarray(env.goal), jnp.asarray(env.bounds, jnp.float32),
        world["jax_oracle"])))(keys)


_RUNS = {}


def jax_run_batch(jcfg, world):
    """(initial states, states and aux after 10 steps) of JAX's run_batch,
    computed once per config."""
    if jcfg not in _RUNS:
        jax_solver = JaxExperimentalSolver(jcfg, jax_circle_collision)
        states = jax_states(jax_solver, world)
        _RUNS[jcfg] = (states, *jax.jit(
            lambda s, o: jax_solver.run_batch(s, o, 10, problems_per_program=P))(
                states, world["jax_oracles"]))
    return _RUNS[jcfg]


def to_port(jax_state):
    return state_from_jax(jax.tree_util.tree_map(np.asarray, jax_state), device="cpu")


@pytest.mark.parametrize("field_freq", [1, 2])
def test_run_batch_matches_jax(world, field_freq):
    """10 steps of run_batch (one reparametrization chunk) against JAX's
    run_batch with its draws: trajectory atol 2e-3 (the bound of
    tests/test_torch_solver.py's runs). field_freq 2 divides the
    reparametrization freq: the static field stride, as in
    tests/test_field_freq.py:138-160, trains the field at steps 0, 2, ..., 8
    and draws no field noise in between."""
    jcfg, cfg = configs(optimize_collision_model_freq=field_freq)
    states, ref, ref_aux = jax_run_batch(jcfg, world)
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, device="cpu")
    noise = replay(jcfg, states.key, 10, range(0, 10, field_freq))
    got, aux = solver.run_batch(to_port(states), world["oracle"], 10, noise, problems_per_program=P)
    assert not noise.queue
    assert tuple(aux.field_loss.shape) == tuple(aux.trajectory_loss.shape) == (BATCH, 10)
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(ref_aux.field_loss),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(ref.step_count))
    np.testing.assert_array_equal(got.field_opt_state.count.numpy(),
                                  np.asarray(ref.field_opt_state[0].count))
    skipped = [i for i in range(10) if i % field_freq]
    assert (aux.field_loss[:, skipped] == 0).all() and (aux.field_loss[:, ::field_freq] > 0).all()


def test_bf16_batch_step_matches_jax(world):
    """One bf16 step of the batch-explicit path (field update through the
    multi-problem twins, trajectory update through onf_apply's casts, then the
    reparametrization) against JAX's, from the state 10 f32 steps in. The field loss
    and the scores that pick the new replay buffer come from the same entry
    field, so they agree to a bf16 tie (rtol 1e-4) and the picks are the same
    points; the trajectory loss reads the field after one Adam update, which
    turns rounding-level gradient differences into parameter differences of
    up to ~1e-4 (test_torch_solver.py), so it is held at rtol 1e-3 and the
    trajectory at atol 1e-4."""
    jcfg, cfg = configs("bfloat16")
    jax_solver = JaxExperimentalSolver(jcfg, jax_circle_collision)
    _, states, _ = jax_run_batch(configs()[0], world)
    ref, ref_aux = jax.jit(lambda s, o: jax_solver._step_batch(s, o, True, P))(
        states, world["jax_oracles"])
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, device="cpu")
    noise = replay(jcfg, states.key, 1)
    got, aux = solver._step_batch(to_port(states), world["oracle"], noise, True, P)
    assert not noise.queue
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(ref_aux.field_loss), rtol=1e-4)
    np.testing.assert_allclose(got.buffer_points.numpy(), np.asarray(ref.buffer_points),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.buffer_ages.numpy(), np.asarray(ref.buffer_ages))
    np.testing.assert_allclose(aux.trajectory_loss.numpy(), np.asarray(ref_aux.trajectory_loss),
                               rtol=1e-3)
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=1e-4)


def test_jacobi_step_matches_jax(world):
    """One jacobi step (tests/test_jacobi.py's setting): the trajectory update
    reads the entry field. Every leaf within the tolerances of
    test_torch_solver.py's step test; and against the port's default order,
    the field update is identical while the trajectory differs."""
    jcfg, cfg = configs()
    jax_solver = JaxExperimentalSolver(jcfg, jax_circle_collision, jacobi_step=True)
    states = jax_states(jax_solver, world, key=2, batch=2)
    oracles = jax.tree_util.tree_map(lambda x: x[:2], world["jax_oracles"])
    ref, ref_aux = jax.jit(jax.vmap(jax_solver.step))(states, oracles)
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, jacobi_step=True, device="cpu")
    got, aux = solver.step(to_port(states), world["oracle"], replay(jcfg, states.key, 1))
    want = to_port(ref)
    for name in got._fields:
        # from init, Adam's first update lr * g / (|g| + eps) turns
        # rounding-level differences of a near-zero gradient into parameter
        # differences of up to ~1e-4 (test_torch_solver.py's frequency test)
        tols = (0.0, 1e-3) if name == "field_params" else (1e-4, 1e-5)
        for g, w in zip(tree_leaves(getattr(got, name)), tree_leaves(getattr(want, name))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), *tols, err_msg=name)
    np.testing.assert_allclose(aux.trajectory_loss.numpy(), np.asarray(ref_aux.trajectory_loss),
                               rtol=1e-5)

    plain = ConstrainedSolver(cfg, circle_collision, device="cpu")
    default, _ = plain.step(to_port(states), world["oracle"], replay(jcfg, states.key, 1))
    for a, b in zip(tree_leaves(got.field_params), tree_leaves(default.field_params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(got.buffer_points, default.buffer_points, rtol=0, atol=0)
    torch.testing.assert_close(got.prev_trajectory, default.prev_trajectory, rtol=0, atol=0)
    assert not torch.allclose(got.trajectory, default.trajectory)


def test_run_batch_matches_run_on_the_cpu(world):
    """In f32 the batch-explicit path computes what `run` computes: 20 steps of
    both from one state with the same noise stay within 1e-5."""
    _, cfg = configs()
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, device="cpu")
    env = world["env"]
    ends = [np.tile(np.asarray(a, np.float32)[None], (BATCH, 1))
            for a in (env.start, env.goal, env.bounds)]
    state = solver.init_state(torch.Generator().manual_seed(0), *ends, world["oracle"])
    def noise():
        return GeneratorNoise(torch.Generator().manual_seed(1))

    a, aux_a = solver.run_batch(state, world["oracle"], 20, noise(), P)
    b, aux_b = solver.run(state, world["oracle"], 20, noise())
    torch.testing.assert_close(a.trajectory, b.trajectory, rtol=0, atol=1e-5)
    torch.testing.assert_close(aux_a.field_loss, aux_b.field_loss, rtol=1e-4, atol=1e-5)
    assert all(count == 0 for count in kernels.LAUNCHES.values())


def test_use_fused_field_grad_selects_the_main_path(world):
    _, cfg = configs()
    fused = ExperimentalConstrainedSolver(cfg, circle_collision, use_fused_field_grad=True,
                                          device="cpu")
    plain = ConstrainedSolver(cfg, circle_collision, device="cpu")
    env = world["env"]
    ends = [np.tile(np.asarray(a, np.float32)[None], (2, 1))
            for a in (env.start, env.goal, env.bounds)]
    state = plain.init_state(torch.Generator().manual_seed(0), *ends, world["oracle"])
    a, _ = fused.step(state, world["oracle"], GeneratorNoise(torch.Generator().manual_seed(2)))
    b, _ = plain.step(state, world["oracle"], GeneratorNoise(torch.Generator().manual_seed(2)))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_run_batch_validations():
    """JAX's run_batch(None, None, 7) raises before touching the state; so
    does the port's; and B % P must be 0."""
    jcfg, cfg = configs()
    with pytest.raises(ValueError, match="reparametrize"):
        JaxExperimentalSolver(jcfg, jax_circle_collision).run_batch(None, None, 7)
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, device="cpu")
    with pytest.raises(ValueError, match="reparametrize"):
        solver.run_batch(None, None, 7, None)
    three = tree_map(lambda t: t[:3], _cpu_state(solver))
    with pytest.raises(ValueError, match="not divisible by 2"):
        solver.run_batch(three, None, 10, GeneratorNoise(torch.Generator()), problems_per_program=2)


def _cpu_oracle():
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    return CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], torch.tensor([0.3]),
                        torch.tensor([[0.0, 3.0, 0.0, 3.0]]))


def _cpu_state(solver):
    env = two_walls_se2_environment()
    ends = [np.tile(np.asarray(a, np.float32)[None], (BATCH, 1))
            for a in (env.start, env.goal, env.bounds)]
    return solver.init_state(torch.Generator().manual_seed(0), *ends, _cpu_oracle())


@pytest.mark.parametrize("flags, error, match", [
    ({"jacobi_step": True, "merged_step": True}, ValueError, "mutually exclusive"),
    ({"merged_step": True, "use_fused_field_grad": True}, ValueError, "mutually exclusive"),
    ({"merged_step": True}, None, None),
])
def test_constructor_flags(flags, error, match):
    """The exclusive flags raise in both packages; merged_step alone builds
    a solver whose step takes the merged branch (the field, the replay
    buffer and the trajectory of `merged_field_and_trajectory`)."""
    jcfg, cfg = configs()
    if error is not None:
        with pytest.raises(error, match=match):
            JaxExperimentalSolver(jcfg, jax_circle_collision, **flags)
        with pytest.raises(error, match=match):
            ExperimentalConstrainedSolver(cfg, circle_collision, device="cpu", **flags)
        return
    assert JaxExperimentalSolver(jcfg, jax_circle_collision, **flags).merged_step
    solver = ExperimentalConstrainedSolver(cfg, circle_collision, device="cpu", **flags)
    assert solver.merged_step and not solver.jacobi_step
    state = _cpu_state(solver)
    oracle = _cpu_oracle()
    got, _ = solver.step_static(state, oracle, GeneratorNoise(torch.Generator().manual_seed(4)),
                                with_reparam=False)
    want, _, _ = merged_field_and_trajectory(solver, state, oracle,
                                             GeneratorNoise(torch.Generator().manual_seed(4)))
    for a, b in zip(tree_leaves((got.field_params, got.buffer_points, got.trajectory)),
                    tree_leaves((want.field_params, want.buffer_points, want.trajectory))):
        assert torch.equal(a, b)


def test_field_freq_validations():
    """jacobi needs a field update every step; the batch-explicit step needs a
    field frequency that is 1 or a static stride (one dividing the
    reparametrization freq), as in the JAX package."""
    jcfg, cfg = configs(optimize_collision_model_freq=2)
    for solver_cls, c, fn in ((JaxExperimentalSolver, jcfg, jax_circle_collision),
                              (ExperimentalConstrainedSolver, cfg, circle_collision)):
        kwargs = {} if solver_cls is JaxExperimentalSolver else {"device": "cpu"}
        with pytest.raises(NotImplementedError, match="optimize_collision_model_freq == 1"):
            solver_cls(c, fn, jacobi_step=True, **kwargs)
    _, cfg3 = configs(optimize_collision_model_freq=3)
    solver = ExperimentalConstrainedSolver(cfg3, circle_collision, device="cpu")
    with pytest.raises(NotImplementedError, match="batch-explicit path requires"):
        solver.run_batch(_cpu_state(solver), None, 10, GeneratorNoise(torch.Generator()), P)
