"""The port's problem mesh (nfopp_tpu_torch/parallel/mesh.py) on the CPU:
two ranks over gloo (a file rendezvous under the test's temporary
directory) against the JAX package on its 2-device virtual CPU mesh and
against the port's own 1-rank runs.

One 2-rank run (this file as a script, `--worker`) computes everything the
tests below read: the cross-rank mean, a gather round trip, BatchPlanner's
inits (independent, grouped within a rank, one group spanning both ranks),
ten steps of `run`, the group-mean field gradients of one step with JAX's
draws given (one group over both ranks, and groups of 4 over 6 rows per
rank, whose second group straddles them), a tracked loop whose ranks finish
at different chunks, `run_grouped` in the straddling and the crossing
layouts (eager and captured), the Jacobi and merged orders, and fleet
sessions whose sub-fleets straddle the ranks.
Small solver (N=12, K=12, R=4, hidden 16), as tests/test_torch_batch_planner.py.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nfopp_tpu_torch.models import ONFConfig  # noqa: E402
from nfopp_tpu_torch.parallel import BatchPlanner, batch_sharding, shard_batch  # noqa: E402
from nfopp_tpu_torch.parallel.mesh import ProblemMesh  # noqa: E402
from nfopp_tpu_torch.solver import ConstrainedSolver, SolverConfig  # noqa: E402
from nfopp_tpu_torch.utils.tree import tree_leaves, tree_map, tree_named_leaves  # noqa: E402
from nfopp_tpu_torch.worlds import (  # noqa: E402
    CircleOracle,
    circle_collision,
    pad_obstacle_points,
    two_walls_se2_environment,
)
from torch_threads import one_thread  # noqa: E402, F401

BATCH = 8  # global batch of the 2-rank run: 4 rows per rank
GRAD_BATCH = 4  # the gradient check: one group of 4 over 2 rows per rank
CFG = SolverConfig(trajectory_length=12, collision_point_count=12, random_field_points=4,
                   onf=ONFConfig(angle_encoding=True, hidden=16), angle_offset=0.3)
N = CFG.trajectory_length
RUN_STEPS = 10
TIMEOUT = 300  # seconds for each rank, and for each of its collectives
# the straddling layout: 6 rows per rank in groups of 4, group 1 (rows 4-7)
# held by both ranks; the crossing layout: one group of all 12
STRADDLE, STRADDLE_GROUP = 12, 4
LAYOUTS = {"straddle": STRADDLE_GROUP, "crossing": STRADDLE}
FIELD_TOL = {"rtol": 2e-4, "atol": 2e-5}  # tests/test_field_grad_fused.py's


def scene(batch: int):
    """(solver, starts, goals, bounds, oracle) of `batch` copies of the
    two-walls scene on the CPU; the oracle per problem."""
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    oracle = CircleOracle(torch.tensor(pts)[None].repeat(batch, 1, 1),
                          torch.tensor(mask)[None].repeat(batch, 1), torch.full((batch,), 0.3),
                          torch.tensor([[0.0, 3.0, 0.0, 3.0]]).repeat(batch, 1))

    def tile(a):
        return np.tile(np.asarray(a, np.float32)[None], (batch, 1))

    return (ConstrainedSolver(CFG, circle_collision, device="cpu"), tile(env.start),
            tile(env.goal), tile(env.bounds), oracle)


def inits(planner, batch: int) -> dict:
    """The planner's three inits of `batch` problems: independent, groups of
    2, one group of the whole batch."""
    _, starts, goals, bounds, oracle = scene(batch)
    return {
        "plain": planner.init_batch(torch.Generator().manual_seed(0), starts, goals, bounds,
                                    oracle),
        "groups_of_2": planner.init_batch_grouped(torch.Generator().manual_seed(1), starts,
                                                  goals, bounds, oracle, 2),
        "one_group": planner.init_batch_grouped(torch.Generator().manual_seed(2), starts, goals,
                                                bounds, oracle, batch),
    }


class ReplayNoise:
    """Noise source that hands out pre-drawn arrays in call order."""

    def __init__(self, blocks):
        self.queue = list(blocks)

    def _next(self, kind, shape, device):
        want, array = self.queue.pop(0)
        assert want == kind and array.shape == tuple(shape), (want, kind, array.shape, shape)
        return torch.tensor(array, device=device)

    def uniform(self, shape, device):
        return self._next("uniform", shape, device)

    def normal(self, shape, device):
        return self._next("normal", shape, device)


class Descending(NamedTuple):
    trajectory: torch.Tensor  # [B, N, 2]
    start: torch.Tensor
    goal: torch.Tensor
    top: torch.Tensor  # [B] the path's height at step 0


class DescendingSolver:
    """Stand-in solver: each path is flat at height max(0.5, top - 0.01 *
    steps); it collides above 1.0, so a problem turns feasible, shortens
    while it descends, and stops improving at 0.5. Counts its runs."""

    mesh = None

    def __init__(self):
        self.runs = 0
        self.steps = 0

    @staticmethod
    def oracle_fn(oracle_params, points):
        return points[..., 1] > 1.0

    def run(self, state, oracle_params, num_steps, noise):
        self.runs += 1
        self.steps += num_steps
        height = torch.clamp(state.top - 0.01 * self.steps, min=0.5)
        trajectory = state.trajectory.clone()
        trajectory[..., 1] = height[:, None]
        return state._replace(trajectory=trajectory), None

    def full_trajectory(self, state):
        return torch.cat([state.start[:, None], state.trajectory, state.goal[:, None]], dim=1)


def descending(rows: slice) -> Descending:
    """Rows of 4 problems: two that settle early (top 1.05) and two late
    (top 2.0), the late ones all on rank 1 of two."""
    top = torch.tensor([1.05, 1.05, 2.0, 2.0])[rows]
    b = top.shape[0]
    x = torch.linspace(0.1, 0.9, N)
    trajectory = torch.stack([x.expand(b, N), top[:, None].expand(b, N)], dim=-1)
    return Descending(trajectory.contiguous(), torch.tensor([[0.0, 0.5]]).repeat(b, 1),
                      torch.tensor([[1.0, 0.5]]).repeat(b, 1), top)


def tracked(mesh, rows: slice):
    """The tracked loop on the stand-in (min_iterations 0, check_freq 10, 30
    chunks): (its carry, the solver's run count)."""
    from nfopp_tpu_torch.solver.tracking import run_tracking_segment, tracking_init

    solver = DescendingSolver()
    carry = tracking_init(solver, descending(rows))
    carry = run_tracking_segment(solver, carry, None, 30, None, min_iterations=0, check_freq=10,
                                 mesh=mesh)
    return carry, solver.runs


def fleet_paths(mesh, group_size: int, robots: int = BATCH, default_mesh: bool = False):
    """Every robot's path after two cycles of a FleetReplanningService of
    `robots` on one world (one chunk per cycle: a zero budget), and the
    service's field leaves gathered. `default_mesh`: the service picks its
    mesh (mesh=None)."""
    from nfopp_tpu_torch.parallel import gather_batch
    from nfopp_tpu_torch.service import FleetReplanningService

    solver, _, _, bounds, oracle = scene(1)
    svc = FleetReplanningService(solver, robots, bounds[0], oracle, planning_timeout=0.0,
                                 group_size=group_size, seed=5,
                                 mesh=None if default_mesh else mesh)
    poses = np.random.default_rng(3).uniform(0.3, 2.7, (2, robots, 3)).astype(np.float32)
    for r in range(robots):
        svc.update_robot_pose(r, poses[0, r])
    for r in range(robots):
        assert svc.set_goal(r, poses[1, r])
    paths = [svc.replan_cycle() for _ in range(2)][-1]
    field = svc._states.field_params if mesh is None else gather_batch(
        svc._states.field_params, svc.mesh)
    return np.stack([paths[r] for r in range(robots)]), [a.numpy() for a in tree_leaves(field)]


def dynamic_traces(mesh) -> list:
    """Three cycles of `fleet_dynamic_session` of BATCH robots in fields of
    2 (the solver on `mesh`, or alone): the traces of the whole fleet."""
    from nfopp_tpu_torch.service import fleet_dynamic_session

    solver, starts, goals, bounds, oracle = scene(BATCH)
    world = scene(1)[-1]
    planner = BatchPlanner(solver, mesh)
    states = planner.init_batch_grouped(torch.Generator().manual_seed(6), starts, goals, bounds,
                                        oracle, 2)
    _, aux = fleet_dynamic_session(planner.solver, states, lambda xs: world, range(3), goals,
                                   steps_per_cycle=10, step_dist=0.1, group_size=2,
                                   noise=torch.Generator().manual_seed(6))
    return [a.numpy() for a in aux]


def named(tree) -> dict:
    return {name: a.numpy() for name, a in tree_named_leaves(tree)}


def grouped_run(solver, mesh, group_size: int, aot: bool = False,
                batch: int = STRADDLE) -> tuple[dict, int]:
    """RUN_STEPS steps of `run_grouped` (or of `run`, group_size 1) of
    `batch` problems from BatchPlanner's init: the whole batch's leaves by
    name, and the run's collectives."""
    from nfopp_tpu_torch.parallel import gather_batch
    from nfopp_tpu_torch.parallel.mesh import COLLECTIVES, reset_collectives

    _, starts, goals, bounds, oracle = scene(batch)
    planner = BatchPlanner(solver, mesh, aot_prefix="mesh" if aot else None)
    if group_size == 1:
        state = planner.init_batch(torch.Generator().manual_seed(7), starts, goals, bounds, oracle)
    else:
        state = planner.init_batch_grouped(torch.Generator().manual_seed(7), starts, goals, bounds,
                                           oracle, group_size)
    reset_collectives()
    if group_size == 1:
        ran, _ = planner.run(state, oracle, RUN_STEPS, torch.Generator().manual_seed(8))
    else:
        ran, _ = planner.run_grouped(state, oracle, RUN_STEPS, group_size,
                                     torch.Generator().manual_seed(8))
    collectives = COLLECTIVES["count"]
    return named(ran if mesh is None else gather_batch(ran, mesh)), collectives


def replicas_equal(leaves: dict, group_size: int) -> bool:
    """Every leaf of a run's fields (parameters and Adam moments) the same
    within each group."""
    field = [a for name, a in leaves.items()
             if name.startswith(("field_params", "field_opt_state/mu", "field_opt_state/nu"))]
    return len(field) > 8 and all((g == g[:, :1]).all() for a in field
                                  for g in [a.reshape((-1, group_size) + a.shape[1:])])


def order_solver(order: str):
    from nfopp_tpu_torch.experimental import ExperimentalConstrainedSolver

    return ExperimentalConstrainedSolver(CFG, circle_collision, device="cpu",
                                         **{f"{order}_step": True})


# (order, group size) of the orders' runs of BATCH problems: independent,
# groups inside the ranks, one group over both
ORDER_RUNS = (("jacobi", 1), ("jacobi", 2), ("merged", 1), ("merged", 2), ("merged", BATCH))


def fleet_session(mesh, group_size: int) -> dict:
    """Two goals x 2 cycles of `fleet_replan_session` of STRADDLE robots in
    3 sub-fleets of 4 (sub-fleet 1, robots 4-7, straddles two ranks of 6),
    one field per `group_size`: the final states' leaves and the traces of
    the whole fleet, by name."""
    from nfopp_tpu_torch.parallel import gather_batch
    from nfopp_tpu_torch.service import fleet_replan_session, subfleet_generators

    solver, starts, goals, bounds, oracle = scene(STRADDLE)
    planner = BatchPlanner(solver, mesh)
    state = planner.init_batch_grouped(torch.Generator().manual_seed(9), starts, goals, bounds,
                                       oracle, group_size)
    rows = np.stack([goals, starts + np.linspace(0.0, 0.2, STRADDLE, dtype=np.float32)[:, None]])
    final, aux = fleet_replan_session(planner.solver, state, oracle, rows, 2, 10, group_size,
                                      subfleet_generators(9, 3, "cpu"), subgroups=3)
    return {**named(final if mesh is None else gather_batch(final, mesh)),
            **{f"aux/{name}": a for name, a in named(aux).items()}}


# --------------------------------------------------------------- the worker

def worker(args) -> None:
    """One rank: every quantity the tests read, gathered, written by rank 0."""
    import torch.distributed as dist

    from nfopp_tpu_torch.parallel import (
        gather_batch, initialize_distributed, mean_over_problems, problem_mesh,
    )
    from nfopp_tpu_torch.parallel.mesh import COLLECTIVES, reset_collectives
    from nfopp_tpu_torch.solver import restore_state

    initialize_distributed(None, 2, args.rank, "gloo",
                           init_method=pathlib.Path(args.init_file).as_uri(), timeout=TIMEOUT)
    mesh = problem_mesh(device="cpu")
    inputs = np.load(args.inputs)
    out = {}

    x = inputs["values"]
    local = shard_batch(torch.tensor(x), mesh)
    out["mean"] = mean_over_problems(local, mesh).numpy()
    flags = torch.tensor(x[:, 0] > 0)
    gathered = gather_batch((local, flags[batch_sharding(mesh, len(x))],
                             torch.arange(len(x), dtype=torch.int32)[batch_sharding(mesh, len(x))]),
                            mesh)
    assert torch.equal(gathered[0], torch.tensor(x)) and torch.equal(gathered[1], flags)
    assert torch.equal(gathered[2], torch.arange(len(x), dtype=torch.int32))

    solver, _, _, _, oracle = scene(BATCH)
    planner = BatchPlanner(solver, mesh)
    for name, state in inits(planner, BATCH).items():
        out.update({f"init_{name}_{i}": a.numpy()
                    for i, a in enumerate(tree_leaves(gather_batch(state, mesh)))})
        if name == "plain":
            ran, _ = planner.run(state, oracle, RUN_STEPS, torch.Generator().manual_seed(3))
            out.update({f"run_{i}": a.numpy()
                        for i, a in enumerate(tree_leaves(gather_batch(ran, mesh)))})

    # one step's group-mean field gradients, the group spanning both ranks
    grad_solver, starts, goals, bounds, grad_oracle = scene(GRAD_BATCH)
    template = grad_solver.init_state(torch.Generator().manual_seed(0), starts, goals, bounds,
                                      grad_oracle)
    state = shard_batch(restore_state(template, args.state), mesh)
    mesh_solver = grad_solver.with_mesh(mesh)
    # JAX's draws for the whole group, each rank cutting its rows
    noise = mesh_solver._noise(ReplayNoise([("uniform", inputs["u"]),
                                            ("normal", inputs["normal"])]), GRAD_BATCH // 2)
    _, loss, grads = mesh_solver._field_grads(state, shard_batch(grad_oracle, mesh), noise,
                                              group_size=GRAD_BATCH)
    out.update({f"grad/{name}": a.numpy()
                for name, a in tree_named_leaves(gather_batch(grads, mesh))})
    out["field_loss"] = gather_batch(loss, mesh).numpy()

    # the same in the straddling layout: groups of 4 over 6 rows per rank
    grad_solver, starts, goals, bounds, grad_oracle = scene(STRADDLE)
    template = grad_solver.init_state(torch.Generator().manual_seed(0), starts, goals, bounds,
                                      grad_oracle)
    state = shard_batch(restore_state(template, args.straddle_state), mesh)
    mesh_solver = grad_solver.with_mesh(mesh)
    noise = mesh_solver._noise(ReplayNoise([("uniform", inputs["straddle_u"]),
                                            ("normal", inputs["straddle_normal"])]), STRADDLE // 2)
    reset_collectives()
    _, loss, grads = mesh_solver._field_grads(state, shard_batch(grad_oracle, mesh), noise,
                                              group_size=STRADDLE_GROUP)
    out["straddle_grad_collectives"] = np.asarray(COLLECTIVES["count"])
    out.update({f"straddle_grad/{name}": a.numpy()
                for name, a in tree_named_leaves(gather_batch(grads, mesh))})
    out["straddle_field_loss"] = gather_batch(loss, mesh).numpy()

    # run_grouped in both layouts, eager then captured, and the collectives of each
    for layout, group_size in LAYOUTS.items():
        for mode in ("eager", "captured"):
            leaves, collectives = grouped_run(solver, mesh, group_size, aot=mode == "captured")
            out[f"{layout}_{mode}_collectives"] = np.asarray(collectives)
            out.update({f"{layout}_{mode}/{name}": a for name, a in leaves.items()})
    for order, group_size in ORDER_RUNS:
        leaves, _ = grouped_run(order_solver(order), mesh, group_size, batch=BATCH)
        out.update({f"{order}_{group_size}/{name}": a for name, a in leaves.items()})
    for group_size in (2, STRADDLE_GROUP):  # groups inside the ranks; one straddling
        out.update({f"session_{group_size}/{name}": a
                    for name, a in fleet_session(mesh, group_size).items()})

    for group_size in (4, BATCH):  # a field per rank's robots; one spanning both ranks
        paths, field = fleet_paths(mesh, group_size)
        out[f"fleet_{group_size}_paths"] = paths
        out.update({f"fleet_{group_size}_field_{i}": a for i, a in enumerate(field)})
    # 3 robots: the default mesh is the most ranks that divide the fleet, rank 0 alone
    if mesh.rank == 0:
        out["odd_fleet_paths"], _ = fleet_paths(mesh, 3, robots=3, default_mesh=True)
    else:
        try:
            fleet_paths(mesh, 3, robots=3, default_mesh=True)
            raise AssertionError("rank 1 joined a fleet mesh of 1 rank")
        except ValueError as e:
            assert "outside the fleet's mesh of 1 ranks" in str(e), e

    out.update({f"dynamic_{i}": a for i, a in enumerate(dynamic_traces(mesh))})

    carry, runs = tracked(mesh, batch_sharding(mesh, 4))
    out.update({f"tracked_{i}": a.numpy()
                for i, a in enumerate(tree_leaves(gather_batch(carry, mesh)))})
    out[f"tracked_runs_rank{mesh.rank}"] = np.asarray(runs)
    runs_all = gather_batch(torch.tensor([runs]), mesh)
    out["tracked_runs"] = runs_all.numpy()
    if mesh.rank == 0:
        np.savez(args.out, **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------- the tests

def jax_grouped_gradients(path: pathlib.Path, batch: int = GRAD_BATCH,
                          group_size: int = GRAD_BATCH) -> dict:
    """JAX's one-step grouped field gradients of `batch` problems in groups
    of `group_size` sharing a field (by default one group of GRAD_BATCH),
    with the state (as the port's checkpoint at `path`) and the draws the
    worker replays."""
    import jax
    import jax.numpy as jnp

    from nfopp_tpu.models import ONFConfig as JaxONFConfig
    from nfopp_tpu.solver import ConstrainedSolver as JaxSolver
    from nfopp_tpu.solver import SolverConfig as JaxSolverConfig
    from nfopp_tpu.worlds import CircleOracle as JaxCircleOracle
    from nfopp_tpu.worlds import circle_collision as jax_circle_collision
    from nfopp_tpu_torch.models.onf import params_from_jax
    from nfopp_tpu_torch.solver import save_state, state_from_jax

    jcfg = JaxSolverConfig(**{**CFG._asdict(), "onf": JaxONFConfig(**CFG.onf._asdict())})
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    jax_oracle = JaxCircleOracle(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.3),
                                 jnp.asarray([0.0, 3.0, 0.0, 3.0], jnp.float32))
    jax_solver = JaxSolver(jcfg, jax_circle_collision)
    k_problems, k_field = jax.random.split(jax.random.PRNGKey(4))
    keys = jax.random.split(k_problems, batch)
    # one field key per group (parallel/batch.py:219-221); one group keeps k_field
    field_keys = (jnp.broadcast_to(k_field, (batch,) + k_field.shape) if group_size == batch
                  else jnp.repeat(jax.random.split(k_field, batch // group_size), group_size,
                                  axis=0))
    states = jax.jit(jax.vmap(lambda k, fk: jax_solver.init_state(
        k, jnp.asarray(env.start), jnp.asarray(env.goal), jnp.asarray(env.bounds, jnp.float32),
        jax_oracle, field_key=fk)))(keys, field_keys)
    oracles = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (batch,) + (1,) * x.ndim),
                                     jax_oracle)
    step_keys = jax.random.split(jax.random.PRNGKey(5), batch)
    _, losses, grads = jax.jit(lambda s, k: jax_solver._field_grads_grouped(
        s, oracles, k, group_size))(states, step_keys)
    cand = CFG.collision_point_count + N - 1

    def draws(key):
        k_uni, k_norm = jax.random.split(key, 2)
        return (jax.random.uniform(k_uni, ((N - 1) + cand + CFG.random_field_points * 3,)),
                jax.random.normal(k_norm, (2, N - 1, 3)))

    u, normal = jax.vmap(draws)(step_keys)
    save_state(state_from_jax(jax.device_get(states), device="cpu"), path)
    return {"u": np.asarray(u), "normal": np.asarray(normal), "loss": np.asarray(losses),
            "grads": {name: a.numpy() for name, a in tree_named_leaves(
                params_from_jax(jax.device_get(grads), "cpu"))}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank worker's arrays, and JAX's gradients it was given."""
    tmp = tmp_path_factory.mktemp("mesh")
    jax_side = jax_grouped_gradients(tmp / "state.npz")
    jax_side["straddle"] = jax_grouped_gradients(tmp / "straddle.npz", STRADDLE, STRADDLE_GROUP)
    values = np.random.default_rng(0).normal(size=(BATCH, 5)).astype(np.float32)
    np.savez(tmp / "inputs.npz", values=values, u=jax_side["u"], normal=jax_side["normal"],
             straddle_u=jax_side["straddle"]["u"], straddle_normal=jax_side["straddle"]["normal"])
    logs = [tmp / f"rank{r}.log" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", "--rank", str(r), "--init-file",
         str(tmp / "rendezvous"), "--inputs", str(tmp / "inputs.npz"), "--state",
         str(tmp / "state.npz"), "--straddle-state", str(tmp / "straddle.npz"), "--out",
         str(tmp / "out.npz")],
        cwd=str(ROOT), stdout=log.open("w"), stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, "\n".join(log.read_text().splitlines()[-30:])
    with np.load(tmp / "out.npz") as out:
        return dict(out), values, jax_side


def test_mean_over_problems_matches_jax_on_two_devices(two_ranks):
    import jax
    import jax.numpy as jnp

    from nfopp_tpu.parallel import mean_over_problems as jax_mean
    from nfopp_tpu.parallel import problem_mesh as jax_mesh
    from nfopp_tpu.parallel import shard_batch as jax_shard

    out, values, _ = two_ranks
    want = jax.jit(jax_mean)(jax_shard(jnp.asarray(values), jax_mesh(jax.devices()[:2])))
    np.testing.assert_allclose(out["mean"], np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_shard_rows_follow_jax_device_order(size):
    import jax
    import jax.numpy as jnp

    from nfopp_tpu.parallel import problem_mesh as jax_mesh
    from nfopp_tpu.parallel import shard_batch as jax_shard

    values = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    sharded = jax_shard(jnp.asarray(values), jax_mesh(jax.devices()[:size]))
    shards = sorted(sharded.addressable_shards, key=lambda s: s.device.id)
    tree = {"rows": torch.tensor(values), "shared": torch.ones(1, 2)}
    for rank, shard in enumerate(shards):
        mesh = ProblemMesh(None, rank, size, torch.device("cpu"))
        rows = batch_sharding(mesh, 16)
        assert (rows.start, rows.stop) == (shard.index[0].start, shard.index[0].stop)
        local = shard_batch(tree, mesh)
        np.testing.assert_array_equal(local["rows"].numpy(), np.asarray(shard.data))
        assert torch.equal(local["shared"], tree["shared"])  # a leading axis of 1 is shared
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(ProblemMesh(None, 0, 3, torch.device("cpu")), 16)
    with pytest.raises(ValueError, match="neither the batch axis"):
        shard_batch({"a": torch.zeros(16), "b": torch.zeros(5)}, ProblemMesh(None, 0, 2,
                                                                             torch.device("cpu")))


def test_group_mean_gradients_across_ranks_match_jax(two_ranks):
    """One group of 4 over 2 rows per rank: the all_reduced mean gradient
    against JAX's `_field_grads_grouped` with the same state and draws, at
    tests/test_field_grad_fused.py's tolerances; every replica the same bits."""
    out, _, jax_side = two_ranks
    np.testing.assert_allclose(out["field_loss"], jax_side["loss"], rtol=1e-5)
    assert len(jax_side["grads"]) == len([k for k in out if k.startswith("grad/")]) > 8
    for name, want in jax_side["grads"].items():
        got = out[f"grad/{name}"]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        assert (got == got[:1]).all(), "replicas differ"


@pytest.mark.parametrize("name", ["plain", "groups_of_2", "one_group"])
def test_two_rank_init_is_the_one_rank_init_bit_for_bit(two_ranks, name):
    out, _, _ = two_ranks
    solver = scene(BATCH)[0]
    want = tree_leaves(inits(BatchPlanner(solver), BATCH)[name])
    for i, leaf in enumerate(want):
        np.testing.assert_array_equal(out[f"init_{name}_{i}"], leaf.numpy())


def test_two_rank_run_is_the_one_rank_run_bit_for_bit(two_ranks):
    """Ten steps of `run` from the plain init: every row's noise is cut from
    the global block, so the rows the ranks compute alone are the 1-rank
    run's."""
    out, _, _ = two_ranks
    solver, _, _, _, oracle = scene(BATCH)
    planner = BatchPlanner(solver)
    state = inits(planner, BATCH)["plain"]
    ran, _ = planner.run(state, oracle, RUN_STEPS, torch.Generator().manual_seed(3))
    for i, leaf in enumerate(tree_leaves(ran)):
        np.testing.assert_array_equal(out[f"run_{i}"], leaf.numpy())


def test_tracked_loop_ranks_agree_on_when_to_stop(two_ranks):
    """Rank 0's problems stop at chunk 7, rank 1's at 16: both ranks run 16
    chunks (a rank that stopped alone would leave the other's collectives
    waiting), and the gathered carry is the 1-rank loop's."""
    out, _, _ = two_ranks
    carry, runs = tracked(None, slice(0, 4))
    done_local, _ = tracked(None, slice(0, 2))
    assert runs == 16
    assert int(done_local.chunk.max()) == 7 < runs  # rank 0's rows alone would stop at 7
    np.testing.assert_array_equal(out["tracked_runs"], [runs, runs])
    for i, leaf in enumerate(tree_leaves(carry)):
        np.testing.assert_array_equal(out[f"tracked_{i}"], leaf.numpy())


def test_fleet_service_on_two_ranks(two_ranks):
    """FleetReplanningService(mesh=) on 2 ranks: every robot's path on every
    rank; a field per rank's 4 robots equals the 1-process service bit for
    bit, one field over all 8 keeps its replicas bit-identical across the
    ranks and its paths within JAX's fleet tolerance (atol 0.1) of one
    process. A fleet of 3 takes the default mesh of the most ranks that
    divide it: rank 0 alone serves it (as one process would), rank 1 is
    refused."""
    out, _, _ = two_ranks
    paths, field = fleet_paths(None, 4)
    np.testing.assert_array_equal(out["fleet_4_paths"], paths)
    for i, a in enumerate(field):
        np.testing.assert_array_equal(out[f"fleet_4_field_{i}"], a)
    paths, _ = fleet_paths(None, 3, robots=3)  # rank 0 alone served the odd fleet
    np.testing.assert_array_equal(out["odd_fleet_paths"], paths)
    paths, field = fleet_paths(None, BATCH)
    np.testing.assert_allclose(out[f"fleet_{BATCH}_paths"], paths, atol=0.1)
    for i, a in enumerate(field):
        got = out[f"fleet_{BATCH}_field_{i}"]
        assert (got == got[:1]).all(), "replicas differ across ranks"
        np.testing.assert_allclose(got, a, rtol=2e-4, atol=2e-5)


def test_fleet_dynamic_session_on_two_ranks_is_one_process_s(two_ranks):
    """The dynamic fleet session with fields of 2 inside each rank: its
    traces, gathered over the fleet, are the 1-process session's bit for
    bit."""
    out, _, _ = two_ranks
    for i, a in enumerate(dynamic_traces(None)):
        assert out[f"dynamic_{i}"].shape[1] == BATCH
        np.testing.assert_array_equal(out[f"dynamic_{i}"], a)


def test_group_sizes_a_mesh_refuses():
    """A mesh takes any group size that divides the global batch, as JAX
    does, and refuses the others (JAX's own refusals); `run_batch` runs on
    one device only."""
    solver, starts, goals, bounds, oracle = scene(4)
    mesh = ProblemMesh(None, 0, 2, torch.device("cpu"))  # rank 0 of 2: sizes only
    sharded = solver.with_mesh(mesh)
    state = solver.init_state(torch.Generator().manual_seed(0), starts, goals, bounds, oracle)
    for group_size in (3, 12):
        with pytest.raises(ValueError, match="global batch 8 not divisible"):
            sharded.run_grouped(state, oracle, 10, group_size, torch.Generator())
    with pytest.raises(ValueError, match="not divisible"):
        solver.run_grouped(state, oracle, 10, 8, torch.Generator())
    with pytest.raises(ValueError, match="global batch 6 not divisible"):
        sharded.init_state(torch.Generator(), starts[:3], goals[:3], bounds[:3],
                           tree_map(lambda x: x[:3], oracle), group_size=4)
    with pytest.raises(NotImplementedError, match="one device"):
        order_solver("jacobi").with_mesh(mesh).run_batch(state, oracle, 10, torch.Generator())


def test_straddling_group_gradients_across_ranks_match_jax(two_ranks):
    """Groups of 4 over 6 rows per rank (group 1 straddles the ranks): the
    mean gradients against JAX's `_field_grads_grouped` with the same state
    and draws, at test_group_mean_gradients_across_ranks_match_jax's
    tolerances, in one collective; every group's replicas the same bits."""
    out, _, jax_side = two_ranks
    want = jax_side["straddle"]
    np.testing.assert_allclose(out["straddle_field_loss"], want["loss"], rtol=1e-5)
    assert int(out["straddle_grad_collectives"]) == 1
    for name, w in want["grads"].items():
        got = out[f"straddle_grad/{name}"]
        np.testing.assert_allclose(got, w, **FIELD_TOL)
        grouped = got.reshape((-1, STRADDLE_GROUP) + got.shape[1:])
        assert (grouped == grouped[:, :1]).all(), f"replicas differ in {name}"


def results(out: dict, prefix: str) -> dict:
    """The worker's arrays under `prefix/`, by leaf name."""
    return {k[len(prefix) + 1:]: a for k, a in out.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grouped_run_across_ranks_against_one_rank(two_ranks, layout):
    """RUN_STEPS of run_grouped with groups that cross the ranks, in the
    straddling and the crossing layouts: within JAX's tolerances of the
    1-rank run (trajectories atol 2e-5, tests/test_parallel.py:79; every
    leaf at the gradients' tolerances), every problem's feasibility the
    same, each group's replicas bit-equal across the ranks."""
    from nfopp_tpu_torch.solver import evaluate_path

    out, _, _ = two_ranks
    group_size = LAYOUTS[layout]
    want, _ = grouped_run(scene(1)[0], None, group_size)
    got = results(out, f"{layout}_eager")
    assert got.keys() == want.keys() and replicas_equal(got, group_size)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, **FIELD_TOL, err_msg=name)
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], atol=2e-5)
    solver, _, _, _, oracle = scene(STRADDLE)

    def feasible(leaves):
        paths = torch.cat([torch.tensor(leaves["start"])[:, None],
                           torch.tensor(leaves["trajectory"]),
                           torch.tensor(leaves["goal"])[:, None]], dim=1)
        return ~evaluate_path(solver.oracle_fn, oracle, paths)[0]

    assert torch.equal(feasible(got), feasible(want))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_captured_mesh_run_is_the_eager_mesh_run_bit_for_bit(two_ranks, layout):
    """A `with_aot` copy (BatchPlanner(aot_prefix=)) of a run whose groups
    cross the ranks equals the eager mesh run bit for bit, with as many
    collectives: one per field step."""
    out, _, _ = two_ranks
    eager, captured = results(out, f"{layout}_eager"), results(out, f"{layout}_captured")
    assert eager.keys() == captured.keys() and len(eager) > 8
    for name, a in eager.items():
        np.testing.assert_array_equal(captured[name], a, err_msg=name)
    assert int(out[f"{layout}_captured_collectives"]) == int(out[f"{layout}_eager_collectives"])
    assert int(out[f"{layout}_eager_collectives"]) == RUN_STEPS


def rank_alone(solver, group_size: int, rank: int) -> dict:
    """`grouped_run` of rank `rank`'s rows of BATCH problems alone in this
    process, laid out as rank `rank` of 2 without a process group: the
    rank's draws and batch size (for groups inside the ranks, which make no
    collective)."""
    mesh = ProblemMesh(None, rank, 2, torch.device("cpu"))
    return grouped_run(solver.with_mesh(mesh), mesh, group_size, batch=BATCH)[0]


@pytest.mark.parametrize("order", ["jacobi", "merged"])
def test_orders_on_two_ranks(two_ranks, order):
    """ExperimentalConstrainedSolver's Jacobi and merged orders on the mesh:
    independent problems, groups inside the ranks, and (merged) one group
    over both ranks, its replicas equal. Where no group crosses the ranks,
    each rank's rows are bit for bit the same rows run alone in one process
    (`rank_alone`), and Jacobi's are the 1-rank run's. Against the 1-rank
    run the merged order is held at the field tolerances throughout: its
    hand-written backward calls torch.sigmoid, whose CPU kernel rounds the
    elements past the last full vector of a tensor differently from those
    inside one, so a rank's half-batch tensor and the whole batch's can
    differ in the last bit (on the card its reductions and batched products
    sum in an order that follows the batch size; chip_smoke.py's phase 15e
    holds the same witness)."""
    out, _, _ = two_ranks
    for group_size in [g for o, g in ORDER_RUNS if o == order]:
        want, _ = grouped_run(order_solver(order), None, group_size, batch=BATCH)
        got = results(out, f"{order}_{group_size}")
        assert got.keys() == want.keys()
        if group_size < BATCH // 2:
            halves = [rank_alone(order_solver(order), group_size, r) for r in range(2)]
            for name, a in got.items():
                np.testing.assert_array_equal(
                    a, np.concatenate([h[name] for h in halves]), err_msg=name)
        for name, w in want.items():
            if order == "jacobi":
                np.testing.assert_array_equal(got[name], w, err_msg=name)
            else:
                np.testing.assert_allclose(got[name], w, **FIELD_TOL, err_msg=name)
        assert group_size == 1 or replicas_equal(got, group_size)


def test_straddling_fleet_session_against_one_process(two_ranks):
    """fleet_replan_session of 12 robots in 3 sub-fleets of 4 on two ranks of
    6: sub-fleet 1 straddles the ranks. With fields of 2 (inside the ranks)
    the session is the 1-process one bit for bit; with fields of 4 (sub-
    fleet 1's crossing the ranks) within the field tolerances, its replicas
    equal."""
    out, _, _ = two_ranks
    for name, w in fleet_session(None, 2).items():
        np.testing.assert_array_equal(out[f"session_2/{name}"], w, err_msg=name)
    want = fleet_session(None, STRADDLE_GROUP)
    got = results(out, f"session_{STRADDLE_GROUP}")
    assert got.keys() == want.keys() and replicas_equal(got, STRADDLE_GROUP)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, **FIELD_TOL, err_msg=name)


@pytest.mark.parametrize("field_freq", [1, 2])
def test_a_rank_without_rows_joins_each_field_step_s_collective(monkeypatch, field_freq):
    """Three ranks holding rows 0-4, none and 4-8 of one group of 8 (a
    sub-fleet the middle rank holds none of): `join_grouped` on the middle
    rank makes the collectives that `run_grouped` makes on rank 0, one per
    field step of the same static schedule, on wires of the same shape."""
    from nfopp_tpu_torch.solver import constrained

    calls = []

    def counted(wire, mesh):
        calls.append((mesh.rank, tuple(wire.shape), wire.dtype))
        return wire

    monkeypatch.setattr(constrained, "sum_over_ranks", counted)
    solver = ConstrainedSolver(CFG._replace(optimize_collision_model_freq=field_freq),
                               circle_collision, device="cpu")
    _, starts, goals, bounds, oracle = scene(4)
    state = solver.init_state(torch.Generator().manual_seed(0), starts, goals, bounds, oracle,
                              group_size=4)
    spans, steps = ((0, 4), (4, 4), (4, 8)), 2 * CFG.reparametrize_trajectory_freq
    rank = [solver.with_mesh(ProblemMesh(None, r, 3, torch.device("cpu"))).with_rows(spans)
            for r in range(2)]
    rank[0].run_grouped(state, oracle, steps, 8, torch.Generator().manual_seed(1))
    rank[1].join_grouped(steps, 8, sum(x[0].numel() for x in tree_leaves(state.field_params)))
    ran, joined = ([c[1:] for c in calls if c[0] == r] for r in range(2))
    assert ran == joined and len(ran) == steps // field_freq


@pytest.mark.parametrize("spans, group_size, crossing", [
    (((0, 6), (6, 12)), 4, (1,)),
    (((0, 6), (6, 12)), 12, (0,)),
    (((0, 6), (6, 12)), 3, ()),
    (((0, 4), (4, 6), (6, 8)), 2, ()),
    (((0, 3), (3, 3), (3, 8)), 4, (0,)),
])
def test_crossing_groups_of_a_layout(spans, group_size, crossing):
    """The groups whose rows several ranks hold (a rank may hold none), and
    every rank's rows cut at the group boundaries."""
    from nfopp_tpu_torch.solver.constrained import _crossing_groups, _segments

    assert _crossing_groups(spans, group_size) == crossing
    for lo, hi in spans:
        segments = _segments(lo, hi - lo, group_size) if hi > lo else ()
        assert [r for _, a, b in segments for r in range(a, b)] == list(range(hi - lo))
        for group, a, b in segments:
            assert all((lo + r) // group_size == group for r in range(a, b))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--rank", type=int)
    parser.add_argument("--init-file")
    parser.add_argument("--inputs")
    parser.add_argument("--state")
    parser.add_argument("--straddle-state")
    parser.add_argument("--out")
    worker(parser.parse_args())
