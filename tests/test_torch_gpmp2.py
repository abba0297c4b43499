"""The GPMP2 baseline of the port (nfopp_tpu_torch.baselines.gpmp2) against
the JAX package's (nfopp_tpu.baselines.gpmp2) on the same numpy inputs, on
the CPU.

Tolerances:
- `build_sdf`: bit for bit (both call scipy's distance transform).
- `sdf_lookup`: rtol 1e-6, atol 1e-6 (f32 bilinear arithmetic in both).
- residuals: rtol 1e-6, atol 1e-6 x the problem's largest residual.
- the Jacobian: rtol 1e-5, atol 1e-9 / fix_sigma (1e-5: the endpoint rows
  are weighted 1e4). A point on the clip bound (a column-0 cell centre) and
  one on the hinge (sdf = epsilon exactly) must take the tie derivative 0.5
  in both.
- J^T J and J^T r: |got - f64| <= 1e-5 x (|J|^T |J|) and 1e-5 x (|J|^T |r|)
  elementwise (f32 sums of 801 products: about sqrt(M) eps of the scale).
- the step: an f32 LU solve of a system whose condition number is ~3e7 (the
  endpoint rows weigh 1e4 beside GP rows near 1); held against an f64 solve
  of the same f32 system at backward error <= 1e-6 (|A d - b| over |A| |d| +
  |b|, max norms) and forward error <= 1e-3 in the 2-norm (~5e-5 seen).
- whole plans on tests/test_gpmp2.py's worlds: final cost rtol 1e-3 and
  path atol 1e-3 (the two f32 solves part by ~1e-5 per iteration; no step's
  accept decision flipped on these worlds), and the JAX tests' own holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfopp_tpu.baselines import gpmp2 as jax_gpmp2
from nfopp_tpu_torch.baselines import gpmp2
from torch_threads import one_thread  # noqa: F401


def block_world():
    """tests/test_gpmp2.py::test_sdf_signs_and_distances' grid."""
    blocked = np.zeros((20, 20), bool)
    blocked[8:12, 8:12] = True
    return blocked


def corridor_world():
    """tests/test_gpmp2.py::test_straight_corridor_plan_stays_clear's grid."""
    blocked = np.zeros((30, 30), bool)
    blocked[13:19, 10:20] = True
    return blocked


def random_world(seed=0, shape=(17, 23)):
    return np.random.RandomState(seed).rand(*shape) < 0.2


def both_sdfs(blocked, resolution=1.0, origin=(0.0, 0.0)):
    return (jax_gpmp2.build_sdf(blocked, resolution, origin),
            gpmp2.build_sdf(blocked, resolution, origin, device="cpu"))


def config_of(jax_config):
    return gpmp2.GPMP2Config(**jax_config._asdict())


@pytest.mark.parametrize("world, resolution, origin", [
    (block_world(), 1.0, (0.0, 0.0)),
    (corridor_world(), 1.0, (0.0, 0.0)),
    (random_world(0), 0.5, (-3.0, 1.25)),
])
def test_build_sdf_equals_jax(world, resolution, origin):
    want, got = both_sdfs(world, resolution, origin)
    assert got.values.shape == (1,) + world.shape
    np.testing.assert_array_equal(got.values[0].numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.origin[0].numpy(), np.asarray(want.origin))
    assert got.resolution.item() == float(want.resolution)


def test_stack_sdfs_batches_the_leaves():
    sdfs = [gpmp2.build_sdf(random_world(s), 1.0, device="cpu") for s in range(3)]
    batch = gpmp2.stack_sdfs(sdfs)
    assert batch.values.shape == (3, 17, 23) and batch.origin.shape == (3, 2)
    assert torch.equal(batch.values[2], sdfs[2].values[0])


@pytest.mark.parametrize("world, resolution, origin", [
    (block_world(), 1.0, (0.0, 0.0)),
    (random_world(1), 0.5, (-3.0, 1.25)),
])
def test_sdf_lookup_matches_jax(world, resolution, origin):
    """Random points in the grid and outside it (the clip), and points on
    the column-0 and row-0 cell centres (on the clip's lower bound)."""
    want_sdf, got_sdf = both_sdfs(world, resolution, origin)
    h, w = world.shape
    rng = np.random.RandomState(2)
    lo = np.asarray(origin) - 2 * resolution
    hi = np.asarray(origin) + np.array([w, h]) * resolution + 2 * resolution
    points = rng.uniform(lo, hi, (64, 2))
    cells = np.array([[0, 3], [5, 0], [0, 0], [w - 1, 2]])
    centres = np.asarray(origin) + (cells + 0.5) * resolution
    points = np.concatenate([points, centres]).astype(np.float32)
    want = np.asarray(jax_gpmp2.sdf_lookup(want_sdf, jnp.asarray(points)))
    got = gpmp2.sdf_lookup(got_sdf, torch.tensor(points)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sdf_signs_and_distances():
    """tests/test_gpmp2.py::test_sdf_signs_and_distances on the port."""
    sdf = gpmp2.build_sdf(block_world(), 1.0, device="cpu")
    q = torch.tensor([[[2.5, 2.5], [9.5, 9.5], [12.9, 9.5]]])
    d = gpmp2.sdf_lookup(sdf, q)[0].numpy()
    assert d[0] > 5.0
    assert d[1] < 0.0
    assert 0.0 < d[2] < 2.5


def tie_problem(n=12, epsilon=2.0):
    """A corridor-world problem of n states whose state 3 sits on a column-0
    cell centre (u = 0: the clip's lower bound) and state 6 on a cell centre
    whose distance is exactly epsilon (the hinge's kink); the rest random."""
    blocked = corridor_world()
    sdf = jax_gpmp2.build_sdf(blocked, 1.0)
    values = np.asarray(sdf.values)
    rows, cols = np.nonzero(values == epsilon)
    assert len(rows), "no cell centre at distance epsilon"
    rng = np.random.RandomState(3)
    states = np.concatenate([rng.uniform(1.0, 29.0, (n, 2)), rng.normal(0, 0.5, (n, 2))], 1)
    states[3, :2] = [0.5, 7.5]
    states[6, :2] = [cols[0] + 0.5, rows[0] + 0.5]
    start = np.concatenate([states[0, :2] + 0.01, [0.0, 0.0]])
    goal = np.concatenate([states[-1, :2] - 0.02, [0.0, 0.0]])
    config = jax_gpmp2.GPMP2Config(num_steps=n, epsilon=epsilon)
    f32 = np.float32
    return blocked, states.astype(f32), start.astype(f32), goal.astype(f32), config


def jax_problem(blocked, states, start, goal, config):
    sdf = jax_gpmp2.build_sdf(blocked, 1.0)
    dt = config.total_time / (config.num_steps - 1)
    whitener = jnp.asarray(jax_gpmp2._gp_whitener(dt, config.qc))
    flat = jnp.asarray(states.reshape(-1))
    fn = lambda x: jax_gpmp2._residuals(x, jnp.asarray(start), jnp.asarray(goal), sdf, config,
                                        whitener)
    return flat, fn


def torch_problem(blocked, start, goal, config):
    sdf = gpmp2.build_sdf(blocked, 1.0, device="cpu")
    dt = config.total_time / (config.num_steps - 1)
    whitener = torch.tensor(gpmp2._gp_whitener(dt, config.qc))
    problem = gpmp2._Problem(torch.tensor(start)[None], torch.tensor(goal)[None], sdf, whitener)
    return problem, config_of(config)


def test_residuals_and_jacobian_match_jax_at_the_ties():
    blocked, states, start, goal, jconfig = tie_problem()
    flat_j, fn = jax_problem(blocked, states, start, goal, jconfig)
    problem, config = torch_problem(blocked, start, goal, jconfig)
    flat = torch.tensor(states.reshape(1, -1))
    args = (problem.start, problem.goal, problem.sdf, config, problem.whitener)

    want_r = np.asarray(fn(flat_j))
    got_r = gpmp2._residuals(flat, *args)[0].numpy()
    assert got_r.shape == want_r.shape == (4 * 11 + 12 + 11 * 3 + 8,)
    np.testing.assert_allclose(got_r, want_r, rtol=1e-6, atol=1e-6 * np.abs(want_r).max())

    want_j = np.asarray(jax.jacfwd(fn)(flat_j))
    got_j = gpmp2._jacobian(flat, *args)[0].numpy()
    np.testing.assert_allclose(got_j, want_j, rtol=1e-5, atol=1e-9 / config.fix_sigma)

    # the two ties: obstacle rows of states 3 (clip) and 6 (hinge)
    obstacle = 4 * 11
    clip_row, hinge_row = got_j[obstacle + 3], got_j[obstacle + 6]
    assert want_r[obstacle + 6] == 0.0  # on the kink: eps - d == 0
    full = np.asarray(jax.jacfwd(lambda x: -jax_gpmp2.sdf_lookup(
        jax_gpmp2.build_sdf(blocked, 1.0), x[None])[0] / jconfig.cost_sigma)(
        jnp.asarray(states[6, :2])))
    np.testing.assert_allclose(hinge_row[24:26], 0.5 * full, rtol=1e-6)
    assert np.any(hinge_row[24:26] != 0)
    # at the clip bound only the row direction moves the sample; the column
    # derivative is halved by the tie in both packages
    np.testing.assert_allclose(clip_row[12:14], want_j[obstacle + 3, 12:14], rtol=1e-6)


def test_torch_clamp_would_miss_the_tie():
    """The reason sdf_lookup spells its clip out: torch.clamp passes the
    whole derivative at a bound, jnp.clip half of it."""
    x = torch.tensor(0.0)
    ours = torch.func.jacfwd(lambda u: torch.minimum(torch.maximum(u, torch.zeros_like(u)),
                                                     torch.ones_like(u)))(x)
    assert float(ours) == float(jax.jacfwd(lambda u: jnp.clip(u, 0.0, 1.0))(0.0)) == 0.5
    assert float(torch.func.jacfwd(lambda u: torch.clamp(u, 0.0, 1.0))(x)) == 1.0


def backward_and_forward_error(a, b, d):
    """(backward, forward) errors of the f32 solution d of a d = b against
    an f64 solve of the same f32 system."""
    a64, b64, d64 = a.double(), b.double(), d.double()
    exact = torch.linalg.solve(a64, b64)
    residual = (a64 @ d64[..., None])[..., 0] - b64
    backward = residual.abs().amax(-1) / (a64.abs().sum(-1).amax(-1) * d64.abs().amax(-1)
                                           + b64.abs().amax(-1))
    forward = (d64 - exact).norm(dim=-1) / exact.norm(dim=-1)
    return backward, forward


def test_one_gauss_newton_iteration_matches_jax():
    """On the straight-corridor world's straight-line init (N=50): J^T J and
    J^T r against an f64 product of the same Jacobian, and against JAX's at
    the same states;
    the step against an f64 solve of the same system, JAX's step too."""
    jconfig = jax_gpmp2.GPMP2Config(num_steps=50, epsilon=2.0, iterations=1)
    blocked = corridor_world()
    start_xy, goal_xy = np.array([[5.0, 15.0]], np.float32), np.array([[25.0, 15.0]], np.float32)
    sdf = gpmp2.build_sdf(blocked, 1.0, device="cpu")
    config = config_of(jconfig)
    flat, problem = gpmp2._setup(sdf, start_xy, goal_xy, config)
    r, jtj, jtr = gpmp2._normal_equations(flat, problem, config)
    jac = gpmp2._jacobian(flat, problem.start, problem.goal, sdf, config, problem.whitener)
    j64, r64 = jac.double(), r.double()
    scale_jtj = j64.abs().transpose(1, 2) @ j64.abs()
    scale_jtr = (j64.abs().transpose(1, 2) @ r64.abs()[..., None])[..., 0]
    assert ((jtj.double() - j64.transpose(1, 2) @ j64).abs() <= 1e-5 * scale_jtj).all()
    assert ((jtr.double() - (j64.transpose(1, 2) @ r64[..., None])[..., 0]).abs()
            <= 1e-5 * scale_jtr).all()

    # JAX's normal equations of the same problem (its own init)
    dt = jconfig.total_time / (jconfig.num_steps - 1)
    t = jnp.linspace(0.0, 1.0, jconfig.num_steps)[:, None]
    init = jnp.asarray(start_xy[0])[None] * (1 - t) + jnp.asarray(goal_xy[0])[None] * t
    flat_j = jnp.concatenate([init, jnp.gradient(init, axis=0) / dt], axis=1).reshape(-1)
    # positions within an ulp (of 25: 1.9e-6), velocities within an ulp over dt;
    # JAX's normal equations are then taken at the port's init (same inputs)
    np.testing.assert_allclose(flat[0].numpy(), np.asarray(flat_j), rtol=1e-6, atol=1e-5)
    flat_j = jnp.asarray(flat[0].numpy())
    start = jnp.concatenate([jnp.asarray(start_xy[0]), jnp.zeros(2)])
    goal = jnp.concatenate([jnp.asarray(goal_xy[0]), jnp.zeros(2)])
    whitener = jnp.asarray(jax_gpmp2._gp_whitener(dt, jconfig.qc))
    jsdf = jax_gpmp2.build_sdf(blocked, 1.0)
    fn = lambda x: jax_gpmp2._residuals(x, start, goal, jsdf, jconfig, whitener)
    jj = jax.jacfwd(fn)(flat_j)
    want_jtj, want_jtr = np.asarray(jj.T @ jj), np.asarray(jj.T @ fn(flat_j))
    assert (np.abs(jtj[0].double().numpy() - want_jtj) <= 2e-5 * scale_jtj[0].numpy()).all()
    assert (np.abs(jtr[0].double().numpy() - want_jtr) <= 2e-5 * scale_jtr[0].numpy()).all()

    damped = jtj + config.damping * torch.diag_embed(torch.diagonal(jtj, dim1=1, dim2=2))
    system = damped + 1e-8 * torch.eye(jtj.shape[-1])
    step = gpmp2._step(jtj, jtr, config)
    backward, forward = backward_and_forward_error(system, jtr, step)
    assert backward.max() <= 1e-6 and forward.max() <= 1e-3, (backward, forward)
    jax_damped = jnp.asarray(want_jtj) + jconfig.damping * jnp.diag(jnp.diag(jnp.asarray(want_jtj)))
    jax_step = np.asarray(jnp.linalg.solve(jax_damped + 1e-8 * jnp.eye(want_jtj.shape[0]),
                                           jnp.asarray(want_jtr)))
    exact = torch.linalg.solve(system.double(), jtr.double())[0].numpy()
    assert np.linalg.norm(jax_step - exact) <= 1e-3 * np.linalg.norm(exact)

    # the accepted iterate: one iteration of each package
    got = gpmp2.gpmp2_plan(sdf, start_xy, goal_xy, config)[0].numpy()
    want = np.asarray(jax_gpmp2.gpmp2_plan(jsdf, jnp.asarray(start_xy[0]),
                                           jnp.asarray(goal_xy[0]), jconfig))
    np.testing.assert_allclose(got, want, atol=1e-3)


def final_cost(states, blocked, start_xy, goal_xy, jconfig):
    dt = jconfig.total_time / (jconfig.num_steps - 1)
    whitener = jnp.asarray(jax_gpmp2._gp_whitener(dt, jconfig.qc))
    start = jnp.concatenate([jnp.asarray(start_xy), jnp.zeros(2)])
    goal = jnp.concatenate([jnp.asarray(goal_xy), jnp.zeros(2)])
    return float(jax_gpmp2.gpmp2_cost(jnp.asarray(states.reshape(-1)), start, goal,
                                      jax_gpmp2.build_sdf(blocked, 1.0), jconfig, whitener))


def test_batched_worlds_match_jax():
    """tests/test_gpmp2.py::test_batched_plans' two worlds, one batch in each
    package: path atol 1e-3, final cost rtol 1e-3, and that test's holds."""
    blocked = np.zeros((2, 16, 16), bool)
    blocked[0, 7:11, 6:10] = True
    starts = np.array([[2.0, 8.0], [2.0, 2.0]], np.float32)
    goals = np.array([[14.0, 8.0], [14.0, 14.0]], np.float32)
    jconfig = jax_gpmp2.GPMP2Config(num_steps=30, iterations=20, epsilon=1.5)
    sdfs = [jax_gpmp2.build_sdf(blocked[i], 1.0) for i in range(2)]
    sdf_batch = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *sdfs)
    plan = jax.jit(jax.vmap(lambda s, a, b: jax_gpmp2.gpmp2_plan(s, a, b, jconfig)))
    want = np.asarray(plan(sdf_batch, jnp.asarray(starts), jnp.asarray(goals)))

    sdf = gpmp2.stack_sdfs([gpmp2.build_sdf(blocked[i], 1.0, device="cpu") for i in range(2)])
    got = gpmp2.gpmp2_plan(sdf, starts, goals, config_of(jconfig)).numpy()
    assert got.shape == (2, 30, 4) and np.isfinite(got).all()
    assert got[0, :, 1].min() < 6.5  # problem 0 detours below the block
    np.testing.assert_allclose(got, want, atol=1e-3)
    for b in range(2):
        assert final_cost(got[b], blocked[b], starts[b], goals[b], jconfig) == pytest.approx(
            final_cost(want[b], blocked[b], starts[b], goals[b], jconfig), rel=1e-3)


def test_straight_corridor_plan_matches_jax():
    """tests/test_gpmp2.py::test_straight_corridor_plan_stays_clear in both
    packages: path atol 1e-3, final cost rtol 1e-3, and that test's holds."""
    blocked = corridor_world()
    jconfig = jax_gpmp2.GPMP2Config(num_steps=50, epsilon=2.0, iterations=40)
    start, goal = np.array([5.0, 15.0], np.float32), np.array([25.0, 15.0], np.float32)
    jsdf = jax_gpmp2.build_sdf(blocked, 1.0)
    want = np.asarray(jax_gpmp2.gpmp2_plan(jsdf, jnp.asarray(start), jnp.asarray(goal), jconfig))
    sdf = gpmp2.build_sdf(blocked, 1.0, device="cpu")
    got = gpmp2.gpmp2_plan(sdf, start[None], goal[None], config_of(jconfig))[0].numpy()
    xy = got[:, :2]
    np.testing.assert_allclose(xy[0], [5, 15], atol=0.1)
    np.testing.assert_allclose(xy[-1], [25, 15], atol=0.1)
    d = gpmp2.sdf_lookup(sdf, torch.tensor(xy)[None])[0].numpy()
    assert (d > 0.5).all(), f"min clearance {d.min():.2f}"
    assert xy[:, 1].min() < 13.0
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert final_cost(got, blocked, start, goal, jconfig) == pytest.approx(
        final_cost(want, blocked, start, goal, jconfig), rel=1e-3)


# the forward error of one f32 Gauss-Newton step against an f64 solve of the
# same system (test_one_gauss_newton_iteration_matches_jax; cond(J^T J) ~3e7)
STEP_FORWARD_ERROR = 1e-3


def gauss_newton_run(sdf, starts, goals, config, init, dtype=torch.float32):
    """config.iterations of _gn_step on the f32 problem, computed in `dtype`:
    (final states [B, N, 4], accepted [B, iterations], the norms of the
    accepted steps [B, iterations], the per-step forward errors [B, iterations]
    of the f32 solve against an f64 solve of the same system)."""
    flat, problem = gpmp2._setup(sdf, starts, goals, config, init)
    cast = lambda x: x.to(dtype)
    problem = gpmp2._Problem(cast(problem.start), cast(problem.goal),
                             gpmp2.SDF(*map(cast, problem.sdf)), cast(problem.whitener))
    flat = cast(flat)
    accepted, norms, forward = [], [], []
    for _ in range(config.iterations):
        _, jtj, jtr = gpmp2._normal_equations(flat, problem, config)
        step = gpmp2._step(jtj, jtr, config)
        damped = jtj + config.damping * torch.diag_embed(torch.diagonal(jtj, dim1=1, dim2=2))
        forward.append(backward_and_forward_error(
            damped + 1e-8 * torch.eye(jtj.shape[-1], dtype=dtype), jtr, step)[1])
        new = gpmp2._gn_step(flat, problem, config)
        moved = (new != flat).any(dim=1)
        accepted.append(moved)
        norms.append(torch.where(moved, (new - flat).double().norm(dim=1), 0.0))
        flat = new
    return (flat.reshape(flat.shape[0], config.num_steps, 4), torch.stack(accepted, 1),
            torch.stack(norms, 1), torch.stack(forward, 1))


def test_costs_never_rise_and_batch_equals_each_problem_alone():
    """Three random worlds with a wavefront-like bent init: the cost of every
    problem never rises over the iterations (the accept rule), and the
    batch's plans equal each problem solved alone: both accept the same
    steps as an f64 run of the same problem, and each lies within the f32
    error of that run. The batched products may sum in another order than
    the single ones, so the two f32 runs are held against f64, not against
    each other: every f32 step is within STEP_FORWARD_ERROR of its f64
    solve (checked), so after K accepted steps the iterate is within
    STEP_FORWARD_ERROR * sum of the f64 steps' norms, compounded by
    (1 + STEP_FORWARD_ERROR) per iteration."""
    config = gpmp2.GPMP2Config(num_steps=20, iterations=6, epsilon=1.5)
    worlds = [random_world(s, (16, 16)) & ~np.eye(16, dtype=bool) for s in range(3)]
    sdf = gpmp2.stack_sdfs([gpmp2.build_sdf(w, 1.0, device="cpu") for w in worlds])
    starts = np.array([[0.5, 0.5], [1.5, 2.5], [0.5, 3.0]], np.float32)
    goals = np.array([[15.5, 15.5], [14.5, 12.5], [12.0, 15.5]], np.float32)
    rng = np.random.RandomState(4)
    t = np.linspace(0, 1, 20, dtype=np.float32)[None, :, None]
    init = starts[:, None] * (1 - t) + goals[:, None] * t + rng.normal(0, 0.5, (3, 20, 2)).astype(
        np.float32) * np.sin(np.pi * t)

    flat, problem = gpmp2._setup(sdf, starts, goals, config, init)
    costs = [gpmp2.gpmp2_cost(flat, problem.start, problem.goal, sdf, config, problem.whitener)]
    for _ in range(config.iterations):
        flat = gpmp2._gn_step(flat, problem, config)
        costs.append(gpmp2.gpmp2_cost(flat, problem.start, problem.goal, sdf, config,
                                      problem.whitener))
    costs = torch.stack(costs, dim=1)
    assert (costs[:, 1:] <= costs[:, :-1]).all()
    assert (costs[:, -1] < costs[:, 0]).all()

    batch = gpmp2.gpmp2_plan(sdf, starts, goals, config, init)
    assert torch.equal(batch, flat.reshape(3, 20, 4))
    ran, batch_accepted, _, batch_forward = gauss_newton_run(sdf, starts, goals, config, init)
    assert torch.equal(ran, batch)
    exact, exact_accepted, exact_norms, _ = gauss_newton_run(sdf, starts, goals, config, init,
                                                             torch.float64)
    assert torch.equal(batch_accepted, exact_accepted)
    assert exact_accepted[:, 0].all()
    growth = (1 + STEP_FORWARD_ERROR) ** config.iterations
    bound = STEP_FORWARD_ERROR * exact_norms.sum(dim=1) * growth
    for b in range(3):
        single = gpmp2.stack_sdfs([gpmp2.build_sdf(worlds[b], 1.0, device="cpu")])
        args = (single, starts[b:b + 1], goals[b:b + 1], config, init[b:b + 1])
        alone = gpmp2.gpmp2_plan(*args)
        ran, accepted, _, forward = gauss_newton_run(*args)
        assert torch.equal(ran, alone)
        assert torch.equal(accepted[0], exact_accepted[b])
        for run, steps in ((alone[0], forward[0]), (batch[b], batch_forward[b])):
            assert (steps <= STEP_FORWARD_ERROR).all(), steps
            assert (run.double() - exact[b]).norm() <= bound[b]


def test_default_init_is_the_straight_line():
    config = gpmp2.GPMP2Config(num_steps=10, iterations=0)
    sdf = gpmp2.build_sdf(np.zeros((8, 8), bool), 1.0, device="cpu")
    out = gpmp2.gpmp2_plan(sdf, np.array([[1.0, 1.0]]), np.array([[7.0, 4.0]]), config)[0]
    np.testing.assert_allclose(out[:, 0].numpy(), np.linspace(1, 7, 10), atol=1e-6)
    # x moves 6 over 9 segments of dt = 10 / 9 s: vx = 0.6
    np.testing.assert_allclose(out[:, 2].numpy(), 0.6, atol=1e-5)


def test_build_sdf_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpmp2.build_sdf(np.zeros((4, 4), bool), 1.0)
