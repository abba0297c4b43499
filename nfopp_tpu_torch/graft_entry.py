"""Entry points of the port for a compile check and a multi-chip dry run
(counterpart of the root's `__graft_entry__.py`, which stays the JAX
package's).

`entry()` returns one batched solver step and its example arguments.
`dryrun_multichip(n_ranks)` runs the production pipeline on a mesh of
`n_ranks` processes over gloo against a 1-rank control, stage by stage as
`__graft_entry__.py::dryrun_multichip` does: a one-step smoke with the
cross-rank mean, a shared field spanning every rank, the suite pipeline
(tracked solve, shortcut pass, restart round, checkpoints), checkpoint
kill -> resume, the fleet session with whole-fleet and 2-sub-fleet
schedules, and the polygon-oracle tracked solve.

    python -m nfopp_tpu_torch.graft_entry --ranks 2 --device cpu
    python -m nfopp_tpu_torch.graft_entry --ranks 2          # both ranks on cuda:0

What the 1-rank control must equal: every rank cuts its rows from the
random blocks drawn for the global batch, so the init is bit-equal on any
mesh, and so is everything the ranks compute row by row without talking
(`BITS_HOLD`: the smoke step, the pipeline, the polygon solve; and the
sub-fleet schedule while each sub-fleet's field lies in one rank, as on 2
ranks). A shared field whose rows several ranks hold, wherever its group
lies, averages its gradients as a sum of per-rank sums, which rounds
differently from the 1-rank mean, so those stages (`shared`, `fleet`, and
`subfleets` on more than 2 ranks, whose sub-fleets then straddle or cover
several ranks) and the cross-rank mean are held at JAX's tolerances, their
replicas bit-equal across ranks. Kill -> resume is bit-equal on the same
mesh.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

# stages whose arrays equal the 1-rank control's bit for bit (see the module)
BITS_HOLD = ("init", "smoke", "pipeline_init", "pipeline", "polygon")
RANK_TIMEOUT = 600.0  # seconds for a rank of the dry run, and for each collective


def _make_problem(trajectory_length: int, buffer_size: int, device):
    """Small constrained problem on the two-wall scene (the oracle with a
    leading axis of 1)."""
    from .models import ONFConfig
    from .solver import ConstrainedSolver, SolverConfig
    from .worlds import CircleOracle, circle_collision, pad_obstacle_points
    from .worlds import two_walls_se2_environment

    config = SolverConfig(
        trajectory_length=trajectory_length,
        collision_point_count=buffer_size,
        onf=ONFConfig(mean=0.0, sigma=1.0, use_cos=True, angle_encoding=True),
        angle_offset=0.3,
    )
    env = two_walls_se2_environment()
    pts, mask = pad_obstacle_points(env.obstacle_points.astype(np.float32), 32)
    solver = ConstrainedSolver(config, circle_collision, device=device)
    oracle = CircleOracle(
        torch.tensor(pts, device=solver.device)[None],
        torch.tensor(mask, device=solver.device)[None],
        torch.tensor([0.3], device=solver.device),
        torch.tensor([[0.0, 3.0, 0.0, 3.0]], device=solver.device),
    )
    return solver, env, oracle


def _tile(x, batch: int):
    """`batch` copies of an array (numpy) or of a one-world oracle leaf."""
    if torch.is_tensor(x):
        return x.repeat((batch,) + (1,) * (x.ndim - 1))
    return np.tile(np.asarray(x, np.float32)[None], (batch, 1))


def entry(device=None):
    """(fn, example_args): one batched solver step (field + trajectory
    update) of 8 problems, N=32, K=32, on `device` (default: the card)."""
    from .utils.tree import tree_map

    solver, env, oracle = _make_problem(trajectory_length=32, buffer_size=32,
                                        device="cuda" if device is None else device)
    batch = 8
    generator = torch.Generator(device=solver.device).manual_seed(0)
    oracles = tree_map(lambda x: _tile(x, batch), oracle)
    states = solver.init_state(generator, _tile(env.start, batch), _tile(env.goal, batch),
                               _tile(env.bounds, batch), oracles)

    def step_fn(states, oracles):
        new_states, aux = solver.step(states, oracles, generator)
        return new_states.trajectory, aux.trajectory_loss

    return step_fn, (states, oracles)


def _pipeline_parameters(trajectory_length: int = 64):
    """The production parameter schema at dry-run scale (as the JAX
    entry's)."""
    from .utils import AttributeDict

    return AttributeDict(
        trajectory_length=trajectory_length,
        collision_model=AttributeDict(
            mean=0.0, sigma=2.0, use_cos=True, bias=True, use_normal_init=True,
            angle_encoding=True, name="ONF",
        ),
        collision_optimizer=AttributeDict(lr=2e-2, betas=(0.9, 0.9)),
        trajectory_optimizer=AttributeDict(lr=5e-2, betas=(0.9, 0.9)),
        planner=AttributeDict(
            name="ConstrainedNFOPPlanner",
            trajectory_random_offset=0.02, collision_weight=100.0,
            velocity_hessian_weight=0.5, random_field_points=10,
            init_collision_iteration=20, constraint_deltas_weight=100.0,
            multipliers_lr=0.1, init_collision_points=64,
            reparametrize_trajectory_freq=10, optimize_collision_model_freq=1,
            angle_weight=5.0, angle_offset=0.3, boundary_weight=1.0,
            direction_delta_weight=100.0, collision_multipliers_lr=1e-3,
            collision_beta=10.0, course_random_offset=1.5,
        ),
    )


def _pipeline_scenarios(batch: int):
    """`batch` 24x24 grid worlds: walls with a gap at varying rows, and one
    sealed box around the start (infeasible), so a restart round runs."""
    from .worlds.scenarios import GridScenario

    scenarios = []
    for s in range(batch - 1):
        blocked = np.zeros((24, 24), bool)
        blocked[3:21, 12] = True
        gap = 4 + (s * 3) % 16
        blocked[gap:gap + 3, 12] = False
        scenarios.append(GridScenario(blocked, resolution=1.0,
                                      start=np.array([5.5, 12.5, 0.0], np.float32),
                                      goal=np.array([19.5, 12.5, 0.0], np.float32)))
    blocked = np.zeros((24, 24), bool)
    blocked[2:9, 2:9] = True
    blocked[3:8, 3:8] = False
    scenarios.append(GridScenario(blocked, resolution=1.0,
                                  start=np.array([5.5, 5.5, 0.0], np.float32),
                                  goal=np.array([20.5, 20.5, 0.0], np.float32)))
    return scenarios


def _run_pipeline(scenarios, mesh, checkpoint_path, resume: bool = False):
    """The production suite pipeline (`bench/runner.py::run_grid_suite`) at
    dry-run scale: wavefront init, endpoint checks, the tracked solve with
    early stop, the shortcut pass, one restart round, checkpoints."""
    from .bench.runner import run_grid_suite

    return run_grid_suite(
        scenarios, _pipeline_parameters(), max_iterations=60, min_iterations=10,
        check_freq=10, stop_on_plateau=True, restart_failed=2, restart_rounds=1,
        shortcut_trials=8, checkpoint_path=checkpoint_path, checkpoint_every_chunks=2,
        resume=resume, mesh=mesh,
    )


def _suite_arrays(result) -> dict:
    return {"paths": result.paths, "lengths": result.lengths, "feasible": result.feasible,
            "iterations": result.iterations,
            "restart_rounds_used": np.asarray(result.restart_rounds_used)}


def _numpy(tree) -> list:
    from .utils.tree import tree_leaves

    return [leaf.detach().cpu().numpy() for leaf in tree_leaves(tree)]


def _leaves(prefix: str, tree) -> dict:
    return {f"{prefix}{i}": a for i, a in enumerate(_numpy(tree))}


def _field_replicas_equal(field, spans) -> bool:
    """Every leaf of a gathered field equal, bit for bit, within each span
    [lo, hi) of rows."""
    return all(np.array_equal(a[lo:hi], np.broadcast_to(a[lo:lo + 1], a[lo:hi].shape))
               for a in _numpy(field) for lo, hi in spans)


def _stages(mesh, n: int, workdir: pathlib.Path) -> dict:
    """Every stage on this rank's mesh at the batch sizes of an `n`-rank dry
    run; returns {stage: {name: array}} of gathered arrays (the same on
    every rank). Asserts what one run can show: rows spread over the mesh,
    finite means, replicas bit-equal, the pipeline's decisions, and kill ->
    resume bit-equal."""
    from .parallel import BatchPlanner, gather_batch, mean_over_problems
    from .parallel import batch as batch_module
    from .service import fleet_replan_session, subfleet_generators
    from .solver import ConstrainedSolver
    from .utils.tree import tree_map
    from .worlds import PolygonOracle, pad_polygons, polygon_collision

    device = mesh.device
    out: dict = {}

    def generator(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    # ---- smoke: one step, the cross-rank mean
    solver, env, oracle = _make_problem(trajectory_length=16, buffer_size=16, device=device)
    planner = BatchPlanner(solver, mesh)
    batch = 2 * n
    starts, goals, bounds = (_tile(x, batch) for x in (env.start, env.goal, env.bounds))
    oracles = tree_map(lambda x: _tile(x, batch), oracle)
    states = planner.init_batch(generator(0), starts, goals, bounds, oracles)
    out["init"] = _leaves("leaf", gather_batch(states, mesh))
    new_states, aux = planner.run(states, oracles, 1, generator(0))
    assert new_states.trajectory.shape[0] == batch // mesh.size, \
        "batch axis not spread over the mesh"
    mean_loss = mean_over_problems(aux.trajectory_loss[:, -1], mesh)
    assert bool(torch.isfinite(mean_loss)), "non-finite mean trajectory loss"
    out["smoke"] = {"trajectory": _numpy(gather_batch(new_states.trajectory, mesh))[0]}
    out["mean"] = {"mean_loss": mean_loss.cpu().numpy()}

    # ---- one shared field for the whole batch: a group spanning every rank
    freq = solver.config.reparametrize_trajectory_freq
    g_states = planner.init_batch_grouped(generator(1), starts, goals, bounds, oracles,
                                          group_size=batch)
    g_states, _ = planner.run_grouped(g_states, oracles, freq, batch, generator(1))
    field = gather_batch(g_states.field_params, mesh)
    assert _field_replicas_equal(field, [(0, batch)]), "shared-field replicas diverged"
    out["shared"] = _leaves("field", field)

    # ---- the suite pipeline; its init first
    scenarios = _pipeline_scenarios(4 * n)
    from .solver import config_from_parameters
    from .worlds.oracle import grid_collision

    sv = ConstrainedSolver(config_from_parameters(_pipeline_parameters()), grid_collision,
                           device=device)
    pipe_oracles = tree_map(lambda *xs: torch.cat(xs),
                            *[s.oracle(0.0, device) for s in scenarios])
    pipe_init = BatchPlanner(sv, mesh).init_batch(
        generator(0), np.stack([s.start for s in scenarios]),
        np.stack([s.goal for s in scenarios]),
        np.stack([np.asarray(s.bounds, np.float32) for s in scenarios]), pipe_oracles)
    out["pipeline_init"] = _leaves("leaf", gather_batch(pipe_init, mesh))
    multi = _suite_arrays(_run_pipeline(scenarios, mesh, workdir / "multi.npz"))
    assert not multi["feasible"][-1], "sealed box unexpectedly feasible"
    assert multi["feasible"][:-1].all(), \
        f"wall lanes failed: {np.where(~multi['feasible'][:-1])[0]}"
    assert int(multi["restart_rounds_used"]) == 1, "the restart round did not run"
    out["pipeline"] = multi

    # ---- checkpoint kill -> resume on the same mesh: every rank stops right
    # after the second checkpoint is on disk, then resumes from it
    real_write = batch_module.BatchPlanner._write_checkpoint
    writes = {"n": 0}

    def dying_write(self, *args):
        real_write(self, *args)
        writes["n"] += 1
        if writes["n"] >= 2:
            raise KeyboardInterrupt("simulated preemption")

    batch_module.BatchPlanner._write_checkpoint = dying_write
    try:
        _run_pipeline(scenarios, mesh, workdir / "killed.npz")
        raise AssertionError("simulated preemption did not fire")
    except KeyboardInterrupt:
        pass
    finally:
        batch_module.BatchPlanner._write_checkpoint = real_write
    assert (workdir / "killed.npz").exists(), "no checkpoint written before the kill"
    resumed = _suite_arrays(_run_pipeline(scenarios, mesh, workdir / "killed.npz", resume=True))
    for name, a in multi.items():
        assert np.array_equal(a, resumed[name]), f"killed-and-resumed pipeline diverged on {name}"

    # ---- serving: the fleet session, the whole fleet one shared field
    fleet = 2 * n
    goal_rows = np.stack([_tile(env.goal, fleet), _tile(env.start, fleet)])
    f_oracles = tree_map(lambda x: _tile(x, fleet), oracle)
    f_states = planner.init_batch_grouped(generator(7), _tile(env.start, fleet),
                                          _tile(env.goal, fleet), _tile(env.bounds, fleet),
                                          f_oracles, group_size=fleet)
    f_out, f_aux = fleet_replan_session(planner.solver, f_states, f_oracles, goal_rows,
                                        cycles_per_goal=2, steps_per_cycle=freq,
                                        group_size=fleet, noise=generator(7))
    f_out = gather_batch(f_out, mesh)
    assert _field_replicas_equal(f_out.field_params, [(0, fleet)]), \
        "fleet shared-field replicas diverged across ranks"
    out["fleet"] = {"goal": _numpy(f_out.goal)[0], "trajectory": _numpy(f_out.trajectory)[0],
                    "path_length": f_aux.path_length.cpu().numpy()}
    # the sub-fleet schedule: 2 sequential bursts per cycle, one field each
    half = fleet // 2
    s_states = planner.init_batch_grouped(generator(9), _tile(env.start, fleet),
                                          _tile(env.goal, fleet), _tile(env.bounds, fleet),
                                          f_oracles, group_size=half)
    s_out, s_aux = fleet_replan_session(planner.solver, s_states, f_oracles, goal_rows,
                                        cycles_per_goal=2, steps_per_cycle=freq,
                                        group_size=half, subgroups=2,
                                        noise=subfleet_generators(9, 2, device))
    s_out = gather_batch(s_out, mesh)
    assert _field_replicas_equal(s_out.field_params, [(0, half), (half, fleet)]), \
        "sub-fleet replicas diverged"
    assert np.isfinite(s_aux.path_length.cpu().numpy()).all(), "non-finite sub-fleet lengths"
    assert np.array_equal(_numpy(s_out.goal)[0], out["fleet"]["goal"])
    out["subfleets"] = {"goal": _numpy(s_out.goal)[0], "trajectory": _numpy(s_out.trajectory)[0],
                        "path_length": s_aux.path_length.cpu().numpy()}

    # ---- exact geometry: the polygon oracle's tracked solve
    pbatch = 2 * n
    vertices, masks = [], []
    for i in range(pbatch):
        off = 0.08 * (i % 4)  # shifted per lane, off the diagonal's symmetric saddle
        square = np.asarray([[1.2 + off, 1.0], [1.9 + off, 1.0], [1.9 + off, 1.6],
                             [1.2 + off, 1.6]], np.float32)
        v, m = pad_polygons([square], 1, 4)
        vertices.append(v)
        masks.append(m)
    poly_oracles = PolygonOracle(
        torch.tensor(np.stack(vertices), device=device),
        torch.tensor(np.stack(masks), device=device),
        torch.full((pbatch,), 0.1, device=device),
        torch.tensor([[0.0, 3.0, 0.0, 3.0]], device=device).repeat(pbatch, 1))
    poly_planner = BatchPlanner(ConstrainedSolver(solver.config, polygon_collision, device=device),
                                mesh)
    ends = [_tile(x, pbatch) for x in ([0.5, 0.5, 0.0], [2.5, 2.5, 0.0], [0.0, 3.0, 0.0, 3.0])]
    p_states = poly_planner.init_batch(generator(3), *ends, poly_oracles)
    result = poly_planner.solve(p_states, poly_oracles, generator(3), max_iterations=40,
                                min_iterations=10, check_freq=10)
    out["polygon"] = {"feasible": result.feasible.cpu().numpy(),
                      "iterations": result.iterations.cpu().numpy(),
                      "length": result.length.cpu().numpy(),
                      "path": result.path.cpu().numpy()}
    return out


def _worker(args) -> None:
    """One rank of the dry run (or the 1-rank control): every stage, then
    rank 0 writes the gathered arrays to `args.out`."""
    from .parallel import initialize_distributed, problem_mesh

    torch.set_num_threads(1)
    init = None if args.init_file is None else pathlib.Path(args.init_file).as_uri()
    initialize_distributed(None, args.ranks, args.rank, "gloo", init_method=init,
                           timeout=RANK_TIMEOUT)
    mesh = problem_mesh(device=args.device)
    workdir = pathlib.Path(args.out).parent / ("mesh" if args.ranks > 1 else "control")
    workdir.mkdir(exist_ok=True)
    out = _stages(mesh, args.sizes_of, workdir)
    if mesh.rank == 0:
        np.savez(args.out, **{f"{stage}/{name}": a for stage, arrays in out.items()
                              for name, a in arrays.items()})
    if args.ranks > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


def _compare(mesh_out, control, n_ranks: int) -> dict:
    """The mesh's arrays against the control's, stage by stage: bit-equal
    where `BITS_HOLD` says the port gives bits, else JAX's contracts (every
    decision equal, lengths within 0.2, paths within 1.0, endpoints and
    goals exact). Returns {stage: "bits" | "tolerance"}; raises on a miss."""
    stages = sorted({key.split("/")[0] for key in control.files})
    # on 2 ranks each sub-fleet (half the fleet) lies in one rank; on more, a
    # sub-fleet's field crosses ranks
    bits_hold = BITS_HOLD + (("subfleets",) if n_ranks <= 2 else ())
    verdict = {}
    for stage in stages:
        names = [k for k in control.files if k.startswith(stage + "/")]
        same = all(np.array_equal(mesh_out[k], control[k]) for k in names)
        if stage in bits_hold:
            if not same:
                bad = [k for k in names if not np.array_equal(mesh_out[k], control[k])]
                raise AssertionError(f"stage {stage}: not bit-equal to the 1-rank control: {bad}")
            verdict[stage] = "bits"
            continue

        def get(name):
            return mesh_out[f"{stage}/{name}"], control[f"{stage}/{name}"]

        if stage == "mean":  # a sum of per-rank sums against one sum
            np.testing.assert_allclose(*get("mean_loss"), rtol=1e-6)
        elif stage == "shared":
            for k in names:
                np.testing.assert_allclose(mesh_out[k], control[k], rtol=2e-4, atol=2e-5,
                                           err_msg=f"{k}: shared field against the control")
        elif stage in ("fleet", "subfleets"):
            np.testing.assert_array_equal(*get("goal"))
            np.testing.assert_allclose(*get("path_length"), rtol=2e-2)
            np.testing.assert_allclose(*get("trajectory"), atol=0.1)
        elif stage in ("pipeline", "polygon"):
            for name in ("feasible", "iterations") + (("restart_rounds_used",)
                                                      if stage == "pipeline" else ()):
                np.testing.assert_array_equal(*get(name), err_msg=f"{stage}: {name} differ")
            np.testing.assert_allclose(*get("lengths" if stage == "pipeline" else "length"),
                                       atol=0.2)
            paths = get("paths" if stage == "pipeline" else "path")
            np.testing.assert_allclose(*paths, atol=1.0)
            for end in (0, -1):
                np.testing.assert_array_equal(paths[0][:, end], paths[1][:, end])
        else:
            raise AssertionError(f"stage {stage}: not bit-equal to the 1-rank control")
        verdict[stage] = "bits" if same else "tolerance"
    return verdict


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """The production pipeline on a mesh of `n_ranks` processes over gloo
    against a 1-rank control, on `device` (default: cuda:0 for every rank;
    "cpu" for the plain path). Raises if a rank fails, outlives
    RANK_TIMEOUT, or any stage misses its contract; returns {stage: "bits" |
    "tolerance"}, how each stage matched the control."""
    device = "cuda:0" if device is None else str(device)
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory(prefix="nfopp-torch-dryrun-") as tmp:
        tmp = pathlib.Path(tmp)
        base = [sys.executable, "-m", "nfopp_tpu_torch.graft_entry", "--worker",
                "--device", device, "--sizes-of", str(n_ranks)]
        commands = [base + ["--ranks", str(n_ranks), "--rank", str(r), "--init-file",
                            str(tmp / "rendezvous"), "--out", str(tmp / "mesh.npz")]
                    for r in range(n_ranks)]
        commands.append(base + ["--ranks", "1", "--rank", "0", "--out", str(tmp / "control.npz")])
        logs = [tmp / f"process{i}.log" for i in range(len(commands))]
        procs = [subprocess.Popen(cmd, env=env, cwd=str(root), stdout=log.open("w"),
                                  stderr=subprocess.STDOUT)
                 for cmd, log in zip(commands, logs)]
        try:
            for p in procs:
                p.wait(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, p in enumerate(procs):
            if p.returncode != 0:
                tail = "\n".join(logs[i].read_text().splitlines()[-30:])
                who = f"rank {i}" if i < n_ranks else "the 1-rank control"
                raise RuntimeError(f"dryrun_multichip: {who} failed (rc {p.returncode}):\n{tail}")
        with np.load(tmp / "mesh.npz") as mesh_out, np.load(tmp / "control.npz") as control:
            verdict = _compare(mesh_out, control, n_ranks)
    print(f"dryrun_multichip OK: {n_ranks} ranks on {device} over gloo against a 1-rank "
          f"control; stages: {verdict}; checkpoint kill -> resume bit-equal on the mesh",
          flush=True)
    return verdict


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default=None, help="default: cuda:0 for every rank")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--sizes-of", type=int, default=2, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        _worker(args)
    else:
        dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
