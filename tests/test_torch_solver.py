"""The port's batched solver (nfopp_tpu_torch.solver) against the JAX
ConstrainedSolver, with JAX's own random draws handed to the port.

Scene and config are the main path's (car scene, rectangle footprint,
run_planner_config, full-width field), cut to N=12 waypoints, K=12 buffer
points and R=4 random points, for B=2 problems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.solver import ConstrainedSolver as JaxSolver
from nfopp_tpu.solver import run_planner_config as jax_run_planner_config
from nfopp_tpu.solver.field import field_sample_post as jax_post
from nfopp_tpu.solver.field import field_sample_pre as jax_pre
from nfopp_tpu.solver.tracking import evaluate_path as jax_evaluate_path
from nfopp_tpu.worlds import RectangleOracle as JaxRectangleOracle
from nfopp_tpu.worlds import rectangle_collision as jax_rectangle_collision
from nfopp_tpu_torch.models import ONFConfig, params_from_jax
from nfopp_tpu_torch.solver import (
    ConstrainedSolver,
    SolverConfig,
    evaluate_path,
    state_from_jax,
)
from nfopp_tpu_torch.solver.field import field_sample_post, field_sample_pre
from nfopp_tpu_torch.utils.tree import tree_leaves
from nfopp_tpu_torch.worlds import (
    RectangleOracle,
    car_environment,
    pad_obstacle_points,
    rectangle_collision,
)

BATCH = 2
JCFG = jax_run_planner_config()._replace(
    trajectory_length=12, collision_point_count=12, random_field_points=4
)
CFG = SolverConfig(**{**JCFG._asdict(), "onf": ONFConfig(**JCFG.onf._asdict())})
N = CFG.trajectory_length


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Long loops of small tensor ops: one intra-op thread, so that test
    workers sharing the cores do not spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def field_draws(k_field, dim=3):
    """The two blocks `field_sample_pre` draws (field.py:70-87)."""
    k_uni, k_norm = jax.random.split(k_field, 2)
    cand = JCFG.collision_point_count + N - 1
    u = jax.random.uniform(k_uni, ((N - 1) + cand + JCFG.random_field_points * dim,),
                           dtype=jnp.float32)
    normal = jax.random.normal(k_norm, (2, N - 1, dim), dtype=jnp.float32)
    return u, normal


def step_draws(key):
    """One step's keys and draws (constrained.py:316 and :431)."""
    key, k_field, k_traj = jax.random.split(key, 3)
    u, normal = field_draws(k_field)
    t = jax.random.uniform(k_traj, (N - 1, JCFG.collision_samples_per_segment), jnp.float32)
    return key, u, normal, t


def replay(keys, steps, field_steps=None):
    """JAX's draws for `steps` steps of a batch, queued for the port; only
    the steps in `field_steps` (default: all) draw field noise."""
    noise = ReplayNoise()
    for i in range(steps):
        keys, u, normal, t = jax.vmap(step_draws)(keys)
        if field_steps is None or i in field_steps:
            noise.push("uniform", u)
            noise.push("normal", normal)
        noise.push("uniform", t)
    return noise


@pytest.fixture(scope="module")
def world():
    env = car_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 64)
    box = np.array([-0.3, 0.2, -0.3, 0.2], np.float32)
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    jax_oracle = JaxRectangleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(box),
                                    jnp.asarray(bounds))
    oracle = RectangleOracle(*(torch.tensor(a)[None] for a in (pts, mask, box, bounds)))
    jax_solver = JaxSolver(JCFG, jax_rectangle_collision)
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    state0 = jax.jit(jax.vmap(lambda k: jax_solver.init_state(
        k, env.start, env.goal, jnp.asarray(env.bounds, jnp.float32), jax_oracle)))(keys)
    run20 = jax.jit(jax.vmap(lambda s: jax_solver.run(s, jax_oracle, 20)))
    state20, _ = run20(state0)
    return {
        "env": env, "jax_oracle": jax_oracle, "oracle": oracle, "jax_solver": jax_solver,
        "solver": ConstrainedSolver(CFG, rectangle_collision, device="cpu"),
        "state0": state0, "state20": state20,
    }


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_states_close(got, jax_state, rtol, atol):
    want = state_from_jax(to_np(jax_state), device="cpu")
    names = [f"{field}[{i}]" for field, leaf in zip(got._fields, got)
             for i in range(len(tree_leaves(leaf)))]
    for name, g, w in zip(names, tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=name)


def test_state_from_jax_round_trip(world):
    state = state_from_jax(to_np(world["state0"]), device="cpu")
    assert tuple(state.trajectory.shape) == (BATCH, N, 3)
    assert tuple(state.field_opt_state.mu["mlp1"]["w"].shape) == (BATCH, 220, 100)
    assert state.step_count.dtype == torch.int32 and tuple(state.step_count.shape) == (BATCH,)
    np.testing.assert_array_equal(state.buffer_points.numpy(),
                                  np.asarray(world["state0"].buffer_points))
    first = jax.tree_util.tree_map(lambda a: a[0], world["state0"])
    single = state_from_jax(to_np(first), device="cpu")
    assert tuple(single.trajectory.shape) == (1, N, 3)


def test_initial_trajectory_matches_jax(world):
    env = world["env"]
    ref = world["jax_solver"].initial_trajectory(jnp.asarray(env.start), jnp.asarray(env.goal))
    got = world["solver"].initial_trajectory(env.start[None], env.goal[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=1e-6)


def test_field_sample_pre_and_post_with_injected_draws(world):
    state = world["state20"]
    keys = jax.vmap(lambda k: jax.random.split(k, 3)[1])(state.key)
    ref = jax.vmap(lambda k, p, b: jax_pre(JCFG, k, p, b))(
        keys, state.prev_trajectory, state.bounds)
    noise = ReplayNoise()
    u, normal = jax.vmap(field_draws)(keys)
    noise.push("uniform", u)
    noise.push("normal", normal)
    got = field_sample_pre(CFG, noise, torch.tensor(np.asarray(state.prev_trajectory)),
                           torch.tensor(np.asarray(state.bounds)))
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6, err_msg=name)

    candidates = jnp.concatenate([state.buffer_points, ref.fine], axis=1)
    ages = jnp.concatenate([state.buffer_ages, jnp.zeros((BATCH, N - 1))], axis=1)
    logits = jnp.asarray(np.random.RandomState(0).randn(BATCH, candidates.shape[1]) * 3,
                         jnp.float32)
    ref_post = jax.vmap(lambda p, z, c, a: jax_post(JCFG, p, z, c, a))(
        ref, logits, candidates, ages)
    got_post = field_sample_post(
        CFG, got, torch.tensor(np.asarray(logits)), torch.tensor(np.asarray(candidates)),
        torch.tensor(np.asarray(ages)))
    for name, g, r in zip(got_post._fields, got_post, ref_post):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6, err_msg=name)


def test_step_static_matches_jax(world):
    """One step (field update, trajectory update, reparametrization) from a
    state 20 steps in: every leaf within f32 tolerance. The field's Adam
    normalises tiny gradients, so leaves are held at rtol 1e-4."""
    state = world["state20"]
    jax_solver = world["jax_solver"]
    ref, ref_aux = jax.jit(jax.vmap(
        lambda s: jax_solver.step_static(s, world["jax_oracle"], with_reparam=True)))(state)
    noise = replay(state.key, 1)
    got, aux = world["solver"].step_static(
        state_from_jax(to_np(state), device="cpu"), world["oracle"], noise, with_reparam=True)
    assert not noise.queue
    assert_states_close(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(ref_aux.field_loss), rtol=1e-5)
    np.testing.assert_allclose(aux.trajectory_loss.numpy(), np.asarray(ref_aux.trajectory_loss),
                               rtol=1e-5)


def test_run_20_steps_matches_jax(world):
    """20 steps crossing two reparametrizations, trajectory atol 2e-3 (the
    bound the JAX package holds its kernel and XLA paths to)."""
    state0 = world["state0"]
    noise = replay(state0.key, 20)
    got, aux = world["solver"].run(
        state_from_jax(to_np(state0), device="cpu"), world["oracle"], 20, noise)
    assert not noise.queue
    assert tuple(aux.field_loss.shape) == (BATCH, 20)
    ref = world["state20"]
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(ref.step_count))


@pytest.fixture(scope="module")
def dynamic_ref(world):
    """JAX's 11 steps from init (not a multiple of the reparametrization
    freq): (entry state, final state, aux)."""
    state0 = world["state0"]
    ref, aux = jax.jit(jax.vmap(lambda s: world["jax_solver"].run(s, world["jax_oracle"], 11)))(
        state0)
    return state0, ref, aux


@pytest.fixture(scope="module")
def mid_chunk_ref(world):
    """JAX's 10 steps from step 5 with allow_static=False: (entry state,
    final state, aux)."""
    run = world["jax_solver"].run
    state5, _ = jax.jit(jax.vmap(lambda s: run(s, world["jax_oracle"], 5)))(world["state0"])
    ref, aux = jax.jit(jax.vmap(lambda s: run(s, world["jax_oracle"], 10, allow_static=False)))(
        state5)
    return state5, ref, aux


def check_dynamic_run(world, solver, case):
    """`solver.run` from the case's entry state on JAX's draws against JAX's
    run: trajectories at atol 2e-3, step counts exact, and the first step's
    losses at test_step_static_matches_jax's rtol 1e-5. Returns (state, aux)."""
    entry, ref, ref_aux = case
    steps = ref_aux.field_loss.shape[1]
    noise = replay(entry.key, steps)
    got, aux = solver.run(state_from_jax(to_np(entry), device="cpu"), world["oracle"], steps,
                          noise)
    assert not noise.queue and tuple(aux.trajectory_loss.shape) == (BATCH, steps)
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(ref.step_count))
    for name in ("field_loss", "trajectory_loss"):
        np.testing.assert_allclose(getattr(aux, name)[:, 0].numpy(),
                                   np.asarray(getattr(ref_aux, name))[:, 0], rtol=1e-5)
    return got, aux


def test_dynamic_schedule_matches_jax(world, dynamic_ref):
    """11 steps (not a multiple of the reparametrization freq): every step
    decides from step_count, reparametrizing per problem where due."""
    check_dynamic_run(world, world["solver"], dynamic_ref)


def test_dynamic_schedule_through_the_step_program_matches_jax(world, dynamic_ref):
    """The same 11 steps on a with_aot copy (replays of the one-step program,
    on the CPU the step itself): JAX's run at the same tolerances, and the
    eager port's run bit for bit."""
    captured = world["solver"].with_aot("test")
    got = check_dynamic_run(world, captured, dynamic_ref)
    want = check_dynamic_run(world, world["solver"], dynamic_ref)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    assert [e["program"] for e in captured.aot_events] == [f"step-b{BATCH}"]


def test_run_entered_mid_chunk_matches_jax(world, mid_chunk_ref):
    """10 steps (a multiple of the reparametrization freq) from step 5: the
    problems are not at a chunk's start, so run keeps the dynamic schedule,
    as JAX's run does with allow_static=False."""
    check_dynamic_run(world, world["solver"], mid_chunk_ref)


def test_run_entered_mid_chunk_through_the_step_program_matches_jax(world, mid_chunk_ref):
    """The same 10 steps from step 5 on a with_aot copy: the one-step
    program's replays, held as the eager run against JAX and bit for bit
    against the eager port's run."""
    captured = world["solver"].with_aot("test")
    got = check_dynamic_run(world, captured, mid_chunk_ref)
    want = check_dynamic_run(world, world["solver"], mid_chunk_ref)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    assert [e["program"] for e in captured.aot_events] == [f"step-b{BATCH}"]


@pytest.mark.parametrize("field_freq", [2, 3])
def test_field_update_frequency_matches_jax(world, field_freq):
    """optimize_collision_model_freq 2 (divides the reparametrization freq:
    a static stride, no field noise drawn on skipped steps) and 3 (does not:
    the field update is computed every step and kept where due)."""
    jcfg = JCFG._replace(optimize_collision_model_freq=field_freq)
    jax_solver = JaxSolver(jcfg, jax_rectangle_collision)
    state0 = world["state0"]
    ref, _ = jax.jit(jax.vmap(lambda s: jax_solver.run(s, world["jax_oracle"], 10)))(state0)
    solver = ConstrainedSolver(CFG._replace(optimize_collision_model_freq=field_freq),
                               rectangle_collision, device="cpu")
    noise = replay(state0.key, 10, range(0, 10, 2) if field_freq == 2 else None)
    got, aux = solver.run(state_from_jax(to_np(state0), device="cpu"), world["oracle"], 10, noise)
    assert not noise.queue
    skipped = [i for i in range(10) if i % field_freq]
    assert (aux.field_loss[:, skipped] == 0).all() and (aux.field_loss[:, ::field_freq] > 0).all()
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    # from init, Adam's first update lr * g / (|g| + eps) turns rounding-level
    # differences of a near-zero gradient into up to ~2e-4 (one element seen)
    np.testing.assert_allclose(got.field_params["mlp2"]["w"].numpy(),
                               np.asarray(ref.field_params["mlp2"]["w"]), atol=1e-3)
    np.testing.assert_array_equal(got.field_opt_state.count.numpy(),
                                  np.asarray(ref.field_opt_state[0].count))


def test_live_updates_match_jax(world):
    """update_goal / update_start / retarget from a state 20 steps in,
    including a start moved exactly onto the goal (collapsed path)."""
    state, jax_solver, solver = world["state20"], world["jax_solver"], world["solver"]
    port = state_from_jax(to_np(state), device="cpu")
    goal = np.array([[2.2, 2.6, 0.3], [1.9, 2.7, -0.2]], np.float32)
    start = np.array([[0.6, 1.4, 0.1], [0.4, 1.6, 0.0]], np.float32)
    on_goal = np.asarray(state.goal)
    cases = [
        (jax_solver.update_goal, solver.update_goal, goal),
        (jax_solver.update_start, solver.update_start, start),
        (jax_solver.update_start, solver.update_start, on_goal),
    ]
    for jax_fn, fn, arg in cases:
        ref = jax.vmap(jax_fn)(state, jnp.asarray(arg))
        got = fn(port, arg)
        assert np.isfinite(got.trajectory.numpy()).all()
        assert_states_close(got, ref, rtol=1e-6, atol=1e-5)
    ref = jax.vmap(jax_solver.retarget)(state, jnp.asarray(start), jnp.asarray(goal))
    assert_states_close(solver.retarget(port, start, goal), ref, rtol=1e-6, atol=1e-6)


def test_pretraining_trains_the_field(world):
    """init_collision_iteration > 0: Adam steps on uniform points, drawn from
    the same generator after the init draws."""
    env, oracle = world["env"], world["oracle"]
    ends = [np.tile(np.asarray(a, np.float32)[None], (BATCH, 1))
            for a in (env.start, env.goal, env.bounds)]
    plain = world["solver"].init_state(torch.Generator().manual_seed(3), *ends, oracle)
    cfg = CFG._replace(init_collision_iteration=3, init_collision_points=20)
    solver = ConstrainedSolver(cfg, rectangle_collision, device="cpu")
    trained = solver.init_state(torch.Generator().manual_seed(3), *ends, oracle)
    np.testing.assert_array_equal(trained.buffer_points.numpy(), plain.buffer_points.numpy())
    np.testing.assert_array_equal(trained.field_opt_state.count.numpy(), [3] * BATCH)
    moved = trained.field_params["mlp1"]["w"] - plain.field_params["mlp1"]["w"]
    assert torch.isfinite(moved).all() and moved.abs().max() > 0


def test_evaluate_path_matches_jax(world):
    rng = np.random.RandomState(3)
    paths = np.concatenate([
        rng.uniform(0.0, 3.0, (4, N + 2, 2)), rng.uniform(-np.pi, np.pi, (4, N + 2, 1)),
    ], axis=-1).astype(np.float32)
    env = world["env"]
    straight = np.linspace(env.start, env.goal, N + 2).astype(np.float32)[None]
    collapsed = np.repeat(straight[:, :1], N + 2, axis=1)
    paths = np.concatenate([paths, straight, collapsed], axis=0)
    ref_coll, ref_len = jax.vmap(
        lambda p: jax_evaluate_path(jax_rectangle_collision, world["jax_oracle"], p)
    )(jnp.asarray(paths))
    coll, length = evaluate_path(rectangle_collision, world["oracle"], torch.tensor(paths))
    np.testing.assert_array_equal(coll.numpy(), np.asarray(ref_coll))
    np.testing.assert_allclose(length.numpy(), np.asarray(ref_len), rtol=1e-5, atol=1e-6)
    assert coll.any() and not coll.all()


def test_solver_defaults_to_cuda_and_never_falls_back(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConstrainedSolver(CFG, rectangle_collision)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_jax(to_np(world["state0"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(to_np(world["state0"].field_params))
