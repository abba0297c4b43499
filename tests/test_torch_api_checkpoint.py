"""The port's planner API (nfopp_tpu_torch.solver.api, utils.config) and
checkpointing (solver.checkpoint) against the JAX package: configs field by
field, the ContinuousPlanner interface of tests/test_api_service.py:70-100 on
the CPU, and the cases of tests/test_checkpoint.py:32-63 on the port's
trees, with the noise generator's state saved beside them."""
import dataclasses

import numpy as np
import pytest
import torch

from nfopp_tpu.solver import DEFAULT_PARAMETERS as JAX_DEFAULT_PARAMETERS
from nfopp_tpu.solver import config_from_parameters as jax_config_from_parameters
from nfopp_tpu.utils import AttributeDict as JaxAttributeDict
from nfopp_tpu.utils import Config as JaxConfig
from nfopp_tpu_torch.models import ONFConfig
from nfopp_tpu_torch.solver import (
    DEFAULT_PARAMETERS,
    ConstrainedSolver,
    HolonomicSolver,
    PlannerFactory,
    SolverConfig,
    TrackingCarry,
    config_from_parameters,
    restore_state,
    run_tracking_segment,
    save_state,
    tracking_init,
)
from nfopp_tpu_torch.utils.config import AttributeDict, Config
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map
from nfopp_tpu_torch.worlds import (
    CircleOracle,
    circle_collision,
    pad_obstacle_points,
    two_walls_environment,
    two_walls_se2_environment,
)
from torch_threads import one_thread  # noqa: F401

# tests/test_api_service.py:25-41
RUN_PLANNER_PARAMS = dict(
    trajectory_length=100,
    collision_model=dict(
        mean=0, sigma=1, use_cos=True, bias=True, use_normal_init=True,
        angle_encoding=True, name="ONF",
    ),
    collision_optimizer=dict(lr=5e-2, betas=(0.9, 0.9)),
    trajectory_optimizer=dict(lr=1e-2, betas=(0.9, 0.9)),
    planner=dict(
        name="ConstrainedNFOPPlanner", trajectory_random_offset=0.02,
        collision_weight=1, velocity_hessian_weight=0.5, random_field_points=10,
        init_collision_iteration=0, constraint_deltas_weight=20, multipliers_lr=0.1,
        init_collision_points=100, reparametrize_trajectory_freq=10,
        optimize_collision_model_freq=1, angle_weight=0.5, angle_offset=0.3,
        boundary_weight=1, collision_multipliers_lr=1e-3,
    ),
)


def oracle(env):
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    return CircleOracle(torch.tensor(pts)[None], torch.tensor(mask)[None], torch.tensor([0.3]),
                        torch.tensor([[0.0, 3.0, 0.0, 3.0]]))


def assert_config_equal(got, ref):
    """Every field of the two SolverConfigs, the ONF config's too, with its
    type (int stays int, float float, tuple tuple)."""
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        if name == "onf":
            assert a._fields == b._fields and tuple(a) == tuple(b)
            assert [type(x) for x in a] == [type(x) for x in b]
        else:
            assert a == b and type(a) is type(b), name


@pytest.mark.parametrize("schema", ["default", "run_planner", "override"])
def test_config_from_parameters_matches_jax(schema):
    if schema == "default":
        assert DEFAULT_PARAMETERS == JAX_DEFAULT_PARAMETERS
        got, ref = (config_from_parameters(DEFAULT_PARAMETERS),
                    jax_config_from_parameters(JAX_DEFAULT_PARAMETERS))
        assert got.onf.angle_encoding is False and got.constraint_deltas_weight == 0.2
    elif schema == "run_planner":
        got = config_from_parameters(AttributeDict(RUN_PLANNER_PARAMS))
        ref = jax_config_from_parameters(JaxAttributeDict(RUN_PLANNER_PARAMS))
        assert got.collision_lr == 5e-2 and got.onf.angle_encoding is True
    else:  # the run_bench_mr "nfomp" section override flow
        override = {"trajectory_length": 50, "planner": {"collision_weight": 7}}
        got = config_from_parameters(
            Config.from_dict(RUN_PLANNER_PARAMS).update(override).as_attribute_dict())
        ref = jax_config_from_parameters(
            JaxConfig.from_dict(RUN_PLANNER_PARAMS).update(override).as_attribute_dict())
        assert got.trajectory_length == 50 and got.multipliers_lr == 0.1
    assert_config_equal(got, ref)


def test_attribute_dict_wraps_nested_dicts():
    d = AttributeDict(a={"b": 1})
    assert d.a.b == 1 and isinstance(d["a"], AttributeDict)
    d.c = 2
    assert d["c"] == 2
    with pytest.raises(AttributeError):
        d.missing


def test_continuous_planner_interface():
    """tests/test_api_service.py:70-88 on the CPU: init, step, moved
    endpoints pinned, new bounds, step again."""
    env = two_walls_se2_environment()
    planner = PlannerFactory.make_constrained_onf_planner(
        circle_collision, oracle(env), RUN_PLANNER_PARAMS, device="cpu")
    assert isinstance(planner.solver, ConstrainedSolver)
    planner.init(env.start, env.goal, env.bounds)
    path = planner.get_path()
    assert path.shape == (102, 3)
    np.testing.assert_allclose(path[0], env.start, atol=1e-6)

    aux = planner.step(20)
    assert tuple(aux.trajectory_loss.shape) == (1, 20)
    np.testing.assert_allclose(planner.get_path()[-1], env.goal, atol=1e-6)

    planner.update_goal_point(np.array([2.0, 2.0, 0.3], np.float32))
    np.testing.assert_allclose(planner.get_path()[-1], [2.0, 2.0, 0.3], atol=1e-5)
    planner.update_start_point(np.array([0.6, 0.6, 0.0], np.float32))
    np.testing.assert_allclose(planner.get_path()[0], [0.6, 0.6, 0.0], atol=1e-5)
    planner.set_boundaries((0.0, 4.0, 0.0, 4.0))
    np.testing.assert_array_equal(planner.state.bounds.numpy(), [[0.0, 4.0, 0.0, 4.0]])
    planner.step(5)  # not a whole chunk: the dynamic schedule
    assert planner.state.step_count.tolist() == [5]
    assert np.isfinite(planner.get_path()).all()


def test_holonomic_factory():
    """tests/test_api_service.py:90-99: the demo config, pretrained field."""
    env = two_walls_environment()
    planner = PlannerFactory.make_onf_planner(circle_collision, oracle(env), device="cpu")
    assert isinstance(planner.solver, HolonomicSolver)
    assert planner.solver.config.init_collision_iteration == 400
    planner.init(env.start, env.goal, env.bounds)
    planner.step(10)
    assert planner.get_path().shape == (102, 2)
    with_params = PlannerFactory.make_onf_planner(circle_collision, oracle(env),
                                                  RUN_PLANNER_PARAMS, device="cpu")
    assert with_params.solver.config.onf.angle_encoding is False


def test_planner_seed_and_initial_trajectory_fn():
    """One seed, one solve; the initializer hook sets the first path."""
    env = two_walls_se2_environment()
    params = dict(RUN_PLANNER_PARAMS, trajectory_length=12)
    paths = []
    for _ in range(2):
        planner = PlannerFactory.make_constrained_onf_planner(
            circle_collision, oracle(env), params, seed=7, device="cpu")
        planner.init(env.start, env.goal, env.bounds)
        planner.step(10)
        paths.append(planner.get_path())
    np.testing.assert_array_equal(paths[0], paths[1])

    def zigzag(start, goal, length):
        line = np.linspace(start, goal, length + 2)[1:-1]
        line[::2, 1] += 0.1
        return line

    hooked = PlannerFactory.make_constrained_onf_planner(
        circle_collision, oracle(env), params, initial_trajectory_fn=zigzag, device="cpu")
    hooked.init(env.start, env.goal, env.bounds)
    np.testing.assert_allclose(hooked.get_path()[1:-1], zigzag(env.start, env.goal, 12),
                               atol=1e-6)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    env = two_walls_environment()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlannerFactory.make_onf_planner(circle_collision, oracle(env))


# ------------------------------------------------------------- checkpoints


@dataclasses.dataclass
class Solve:
    solver: ConstrainedSolver
    state: object
    oracle: object


@pytest.fixture(scope="module")
def solve():
    env = two_walls_se2_environment()
    cfg = SolverConfig(trajectory_length=12, collision_point_count=12, random_field_points=4,
                       onf=ONFConfig(hidden=16), angle_offset=0.3)
    solver = ConstrainedSolver(cfg, circle_collision, device="cpu")
    state = solver.init_state(torch.Generator().manual_seed(0), env.start[None], env.goal[None],
                              np.float32(env.bounds)[None], oracle(env))
    return Solve(solver, state, oracle(env))


def assert_trees_equal(a, b):
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(solve, tmp_path):
    advanced, _ = solve.solver.run(solve.state, solve.oracle, 25, torch.Generator().manual_seed(1))
    path = save_state(advanced, tmp_path / "state.npz")
    assert_trees_equal(restore_state(solve.state, path), advanced)


def test_resume_continues_identically(solve, tmp_path):
    """50 straight steps == 25 steps -> checkpoint (with the generator) ->
    restore into a fresh generator -> 25 steps, bit for bit."""
    g = torch.Generator().manual_seed(2)
    mid, _ = solve.solver.run(solve.state, solve.oracle, 25, g)
    path = save_state(mid, tmp_path / "mid.npz", generator=g)
    straight, _ = solve.solver.run(mid, solve.oracle, 25, g)

    fresh = torch.Generator().manual_seed(99)
    restored = restore_state(solve.state, path, generator=fresh)
    resumed, _ = solve.solver.run(restored, solve.oracle, 25, fresh)
    assert_trees_equal(resumed, straight)


def test_batched_state_checkpoint(solve, tmp_path):
    batch = tree_map(lambda x: torch.cat([x, x]), solve.state)
    restored = restore_state(batch, save_state(batch, tmp_path / "batch.npz"))
    assert tuple(restored.trajectory.shape) == (2, 12, 3)
    assert_trees_equal(restored, batch)


def test_shape_mismatch_raises(solve, tmp_path):
    path = save_state(solve.state, tmp_path / "s.npz")
    batch = tree_map(lambda x: torch.cat([x, x]), solve.state)
    with pytest.raises(ValueError, match="leaf trajectory: checkpoint shape"):
        restore_state(batch, path)


def test_structure_mismatch_and_missing_generator_raise(solve, tmp_path):
    path = save_state(solve.state, tmp_path / "s.npz")
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_state(tracking_init(solve.solver, solve.state), path)
    with pytest.raises(ValueError, match="no generator state"):
        restore_state(solve.state, path, generator=torch.Generator())


def test_tracking_carry_round_trip(solve, tmp_path):
    """A TrackingCarry mid-solve (bools, ints, infinities) round-trips, and
    the resumed tracked solve matches the uninterrupted one."""
    g = torch.Generator().manual_seed(3)
    carry = run_tracking_segment(solve.solver, tracking_init(solve.solver, solve.state),
                                 solve.oracle, 1, g, min_iterations=20, check_freq=10)
    assert isinstance(carry, TrackingCarry) and torch.isinf(carry.best_length).all()
    path = save_state(carry, tmp_path / "carry.npz", generator=g)
    straight = run_tracking_segment(solve.solver, carry, solve.oracle, 4, g, 20, 10)
    fresh = torch.Generator()
    restored = restore_state(tracking_init(solve.solver, solve.state), path, generator=fresh)
    assert_trees_equal(restored, carry)
    resumed = run_tracking_segment(solve.solver, restored, solve.oracle, 4, fresh, 20, 10)
    assert_trees_equal(resumed, straight)
