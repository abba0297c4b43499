"""The port's ConstrainedSolver in bf16 (bench.py's default precision: the
field's products in bf16 through onf_apply's casts) against the JAX
ConstrainedSolver in bf16, with JAX's own random draws handed to the port.

Setting of tests/test_torch_solver.py: car scene, rectangle footprint,
run_planner_config with the full-width field, cut to N=12 waypoints, K=12
buffer points and R=4 random points, B=2 problems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.solver import ConstrainedSolver as JaxSolver
from nfopp_tpu.worlds import RectangleOracle as JaxRectangleOracle
from nfopp_tpu.worlds import rectangle_collision as jax_rectangle_collision
from nfopp_tpu_torch.solver import ConstrainedSolver, state_from_jax
from nfopp_tpu_torch.worlds import (
    RectangleOracle,
    car_environment,
    pad_obstacle_points,
    rectangle_collision,
)
from test_torch_solver import BATCH, CFG, JCFG, replay, to_np

JCFG16 = JCFG._replace(onf=JCFG.onf._replace(compute_dtype="bfloat16"))
CFG16 = CFG._replace(onf=CFG.onf._replace(compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def world():
    env = car_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 64)
    box = np.array([-0.3, 0.2, -0.3, 0.2], np.float32)
    bounds = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    jax_oracle = JaxRectangleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(box),
                                    jnp.asarray(bounds))
    oracle = RectangleOracle(*(torch.tensor(a)[None] for a in (pts, mask, box, bounds)))
    return {"env": env, "jax_oracle": jax_oracle, "oracle": oracle}


@pytest.fixture(scope="module")
def bf16_world(world):
    jax_solver = JaxSolver(JCFG16, jax_rectangle_collision)
    env, jax_oracle = world["env"], world["jax_oracle"]
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    state0 = jax.jit(jax.vmap(lambda k: jax_solver.init_state(
        k, env.start, env.goal, jnp.asarray(env.bounds, jnp.float32), jax_oracle)))(keys)
    state20, _ = jax.jit(jax.vmap(lambda s: jax_solver.run(s, jax_oracle, 20)))(state0)
    return {"jax_solver": jax_solver, "state0": state0, "state20": state20,
            "solver": ConstrainedSolver(CFG16, rectangle_collision, device="cpu")}


def test_bf16_step_static_matches_jax(world, bf16_world):
    """One bf16 step (field update, trajectory update, reparametrization) from
    a state 20 bf16 steps in. The field loss comes from the entry field and
    agrees at rtol 1e-4 (a bf16 tie moves a logit by ~2^-8 of itself at
    most); the replay buffer is picked from the same scores. The trajectory
    step reads the field after one Adam update, whose lr * g / (|g| + eps)
    turns a tie in a near-zero gradient into a parameter difference of up to
    ~1e-3 (tests/test_torch_experimental.py's bf16 step): trajectory loss
    rtol 1e-3, trajectory atol 1e-4."""
    state = bf16_world["state20"]
    ref, ref_aux = jax.jit(jax.vmap(lambda s: bf16_world["jax_solver"].step_static(
        s, world["jax_oracle"], with_reparam=True)))(state)
    noise = replay(state.key, 1)
    got, aux = bf16_world["solver"].step_static(
        state_from_jax(to_np(state), device="cpu"), world["oracle"], noise, with_reparam=True)
    assert not noise.queue
    np.testing.assert_allclose(aux.field_loss.numpy(), np.asarray(ref_aux.field_loss), rtol=1e-4)
    np.testing.assert_allclose(got.buffer_points.numpy(), np.asarray(ref.buffer_points),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.buffer_ages.numpy(), np.asarray(ref.buffer_ages))
    np.testing.assert_allclose(aux.trajectory_loss.numpy(), np.asarray(ref_aux.trajectory_loss),
                               rtol=1e-3)
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=1e-4)


def test_bf16_run_20_steps_matches_jax(world, bf16_world):
    """20 bf16 steps crossing two reparametrizations: trajectory atol 2e-3,
    the bound of the f32 runs (tests/test_torch_solver.py)."""
    state0 = bf16_world["state0"]
    noise = replay(state0.key, 20)
    got, aux = bf16_world["solver"].run(
        state_from_jax(to_np(state0), device="cpu"), world["oracle"], 20, noise)
    assert not noise.queue
    assert tuple(aux.field_loss.shape) == (BATCH, 20)
    ref = bf16_world["state20"]
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(ref.trajectory), atol=2e-3)
    np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(ref.step_count))
