"""Scripted replanning sessions: the services' replanning cycles driven by a
fixed script, for cycle latency and offline checks (port of
`nfopp_tpu/service/session.py`).

The JAX package runs each session as one `lax.scan` program. Here each is a
Python loop over goals and cycles with the same order of operations and the
same traces: per cycle the robot's pose is fed to `update_start`, then one
fixed-step optimization burst (`run`, or `run_grouped` for a fleet) replans.
The session's wall time (after a device synchronize) over its cycle count is
the per-cycle latency.

Scripted robot model: each cycle the robot advances to waypoint
`follow_index` of its own freshly planned path, and every `cycles_per_goal`
cycles it receives a new goal via `ConstrainedSolver.retarget` (the
reference's goal-callback path, ros/goal_planner_adapter.py:27-37, minus the
from-scratch field re-init that retarget deliberately avoids). The dynamic
sessions advance the robot `step_dist` along its plan instead
(`advance_along_path`) while the world changes every cycle.

Alignment: update_start and retarget reset step_count to 0, so every cycle's
burst enters at a chunk's start and `run` picks the static schedule (it reads
step_count: one host sync per call); steps_per_cycle must be a multiple of
reparametrize_trajectory_freq (checked).

Noise: each session takes a noise source (`ops.sampling.GeneratorNoise`, a
`torch.Generator`, or any object with the same two methods), and every burst
draws its steps' noise from it in [B, ...] blocks. `fleet_replan_session`
with subgroups=S takes S sources, one per sub-fleet (`subfleet_generators`
makes them from one seed), so sub-fleet s equals an independent session of
its robots with source s.

Mesh: over a solver made by `with_mesh` (as `BatchPlanner(solver, mesh)`
holds it) the fleet sessions take this rank's rows of the states, the goals
and per-robot oracles of the whole fleet, and return this rank's states and
the traces of the whole fleet (gathered once at the end). Each rank's
bursts draw their rows of the block drawn for the whole (sub-)fleet, and a
shared field whose robots several ranks hold averages over all of them
(`_FieldSolver.with_mesh`). Sub-fleets may lie anywhere across the ranks:
a rank runs each sub-fleet's burst on the rows of it that it holds (a
`with_rows` copy of the solver, which knows every rank's rows of the
sub-fleet), and a rank that holds none of a sub-fleet's robots joins that
burst's collectives with an empty wire (`join_grouped`), so every rank
meets the others in the same order. Where no shared field crosses ranks,
sub-fleet s is still bit for bit an independent session with source s.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..parallel.mesh import gather_batch
from ..utils.tree import tree_leaves, tree_map, tree_rows

__all__ = [
    "SessionAux",
    "DynamicSessionAux",
    "advance_along_path",
    "dynamic_replan_session",
    "fleet_dynamic_session",
    "replan_session",
    "fleet_replan_session",
    "subfleet_generators",
]


class SessionAux(NamedTuple):
    """Per-cycle traces, stacked [goals, cycles_per_goal, ...] (fleets:
    [goals, cycles_per_goal, robots, ...])."""

    path_length: torch.Tensor  # xy length of the plan after each cycle
    pose: torch.Tensor  # robot pose fed to update_start each cycle


class DynamicSessionAux(NamedTuple):
    """Per-cycle traces of a dynamic-obstacle session, stacked [cycles, ...]
    (fleets: [cycles, robots, ...])."""

    pose: torch.Tensor  # executed robot pose after each cycle [C, d]
    reached: torch.Tensor  # bool: within goal tolerance after this cycle
    path_length: torch.Tensor  # xy length of the fresh plan
    plan: torch.Tensor  # the fresh plan itself [C, N+2, d] (for offline checks)


def _check_steps(solver, steps_per_cycle: int) -> None:
    freq = solver.config.reparametrize_trajectory_freq
    if steps_per_cycle % freq != 0:
        raise ValueError(
            f"steps_per_cycle ({steps_per_cycle}) must be a multiple of "
            f"reparametrize_trajectory_freq ({freq}) — update_start resets "
            "step_count, so whole chunks keep the static schedule aligned"
        )


def _xy_length(paths: torch.Tensor) -> torch.Tensor:
    """[B, M, d] -> [B] xy polyline lengths."""
    seg = paths[:, 1:, :2] - paths[:, :-1, :2]
    return torch.sum(torch.sqrt(torch.sum(seg * seg, dim=-1)), dim=-1)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """`value` (array or tensor) as f32 on the device of `like`."""
    if not torch.is_tensor(value):
        value = torch.tensor(np.asarray(value, np.float32))
    return value.to(dtype=torch.float32, device=like.device)


def _stack(traces: list, lead: tuple) -> torch.Tensor:
    """Per-cycle tensors stacked and shaped [*lead, ...]."""
    stacked = torch.stack(traces)
    return stacked.reshape(lead + tuple(stacked.shape[1:]))


def _mesh_rows(solver, local: int) -> tuple[int, int]:
    """(first global row of this rank, global batch) of a fleet of which
    this rank holds `local` robots."""
    mesh = getattr(solver, "mesh", None)
    if mesh is None:
        return 0, local
    return mesh.rank * local, mesh.size * local


def _gather_robots(aux: tuple, solver, axis: int) -> tuple:
    """The traces of every rank's robots, the robot axis `axis` gathered."""
    mesh = getattr(solver, "mesh", None)
    if mesh is None:
        return aux
    gathered = gather_batch(tuple(x.movedim(axis, 0) for x in aux), mesh)
    return type(aux)(*(x.movedim(0, axis) for x in gathered))


def subfleet_generators(seed: int, subgroups: int, device) -> list[torch.Generator]:
    """One generator per sub-fleet of `fleet_replan_session(subgroups=S)`:
    sub-fleet s draws from a generator on `device` seeded seed * S + s."""
    return [torch.Generator(device=device).manual_seed(seed * subgroups + s)
            for s in range(subgroups)]


def advance_along_path(path: torch.Tensor, dist) -> torch.Tensor:
    """Batched robot model of the dynamic demo: move `dist` (a scalar or [B])
    along each plan polyline path [B, M, d] (d = 2 or 3) from its first
    vertex (the robot's own pose — update_start pinned it last cycle),
    clamped at the path end; the heading is the entered segment's endpoint's.
    Returns [B, d]."""
    batch, m = path.shape[:2]
    xy = path[..., :2]
    seg = torch.linalg.norm(xy[:, 1:] - xy[:, :-1], dim=-1)  # [B, M-1]
    cum = torch.cat([torch.zeros((batch, 1), dtype=seg.dtype, device=seg.device),
                     torch.cumsum(seg, dim=1)], dim=1)
    dist = torch.as_tensor(dist, dtype=path.dtype, device=path.device).expand(batch)
    dist = torch.minimum(dist, cum[:, -1])
    j = torch.searchsorted(cum, dist[:, None].contiguous(), right=True).clamp(1, m - 1)
    seg_j = torch.gather(seg, 1, j - 1)[:, 0]
    t = (dist - torch.gather(cum, 1, j - 1)[:, 0]) / torch.clamp(seg_j, min=1e-9)
    t = torch.clamp(t, 0.0, 1.0)
    rows = torch.arange(batch, device=path.device)
    j = j[:, 0]
    p = xy[rows, j - 1] + t[:, None] * (xy[rows, j] - xy[rows, j - 1])
    if path.shape[2] == 3:
        return torch.cat([p, path[rows, j, 2:]], dim=1)
    return p


def _dynamic_cycles(solver, states, oracle_builder, oracle_xs, goals, step_dist: float,
                    goal_tolerance: float, burst: Callable) -> tuple[Any, DynamicSessionAux]:
    """The closed loop of both dynamic sessions on R robots (goals [R, d]);
    `burst(states, oracle)` is the cycle's optimization burst."""
    reached = torch.zeros(goals.shape[0], dtype=torch.bool, device=goals.device)
    traces = []
    for xs in oracle_xs:
        oracle_t = oracle_builder(xs)
        paths = solver.full_trajectory(states)
        advanced = advance_along_path(paths, step_dist)
        pose = torch.where(reached[:, None], paths[:, 0], advanced)
        reached = reached | (torch.linalg.norm(pose[:, :2] - goals[:, :2], dim=1)
                             < goal_tolerance)
        states = burst(solver.update_start(states, pose), oracle_t)
        plans = solver.full_trajectory(states)
        traces.append((pose, reached, _xy_length(plans), plans))
    cycles = len(traces)
    return states, DynamicSessionAux(*(_stack(list(xs), (cycles,)) for xs in zip(*traces)))


def dynamic_replan_session(
    solver,
    state: Any,
    oracle_builder: Callable,
    oracle_xs,
    goal,
    steps_per_cycle: int,
    step_dist: float,
    noise,
    goal_tolerance: float = 0.2,
) -> tuple[Any, DynamicSessionAux]:
    """Closed-loop dynamic-obstacle session of one robot (`state`: a batch of
    one) — the scripted version of scripts/dynamic_replan_demo_torch.py's
    host loop (the reference's live-map replanning mode: 10 Hz timer +
    point-cloud merge, ros/goal_planner_adapter.py:44-63 +
    collision_checker_adapter.py:17-27).

    Per cycle c: the world changes (`oracle_builder(oracle_xs[c])`, an
    oracle with a leading axis of 1 — e.g. fresh sensor points of a moving
    disc), the robot advances `step_dist` along its own fresh plan
    (`advance_along_path`, frozen once within `goal_tolerance` of the goal),
    `update_start` re-pins the trajectory, and a `steps_per_cycle` burst of
    `run` replans with `noise`. The ONF field keeps un-learning the
    obstacle's old positions through replay-buffer aging exactly as in the
    host demo. The executed poses and per-cycle plans come back ([C, ...])
    for offline collision/clearance checks against the true moving obstacle.
    """
    _check_steps(solver, steps_per_cycle)
    goal = _f32(goal, state.start).reshape(1, -1)
    state, aux = _dynamic_cycles(
        solver, state, oracle_builder, oracle_xs, goal, step_dist, goal_tolerance,
        lambda st, o: solver.run(st, o, steps_per_cycle, noise)[0])
    return state, DynamicSessionAux(*(x[:, 0] for x in aux))


def fleet_dynamic_session(
    solver,
    states: Any,
    oracle_builder: Callable,
    oracle_xs,
    goals,
    steps_per_cycle: int,
    step_dist: float,
    group_size: int,
    noise,
    goal_tolerance: float = 0.2,
) -> tuple[Any, DynamicSessionAux]:
    """Fleet + dynamic world: R robots (batched `states`, per-robot fixed
    `goals` [R, d]) share one map that changes every cycle
    (`oracle_builder(oracle_xs[c])` -> one oracle for the whole fleet, leading
    axis 1). Per cycle every robot advances along its own fresh plan (frozen
    once within `goal_tolerance` of its goal), `update_start` re-pins each
    trajectory, and one `run_grouped` burst replans the whole fleet with one
    shared occupancy field per `group_size` robots — the fleet analog of
    `dynamic_replan_session`. Traces are per robot ([C, R, ...]).
    """
    _check_steps(solver, steps_per_cycle)
    first, _ = _mesh_rows(solver, states.start.shape[0])
    goals = _f32(goals, states.start)[first:first + states.start.shape[0]]
    states, aux = _dynamic_cycles(
        solver, states, oracle_builder, oracle_xs, goals, step_dist, goal_tolerance,
        lambda st, o: solver.run_grouped(st, o, steps_per_cycle, group_size, noise)[0])
    return states, _gather_robots(aux, solver, 1)


def _goal_cycles(solver, parts: list, oracles: list, rows: list, goals: torch.Tensor,
                 cycles_per_goal: int, follow_index: int, bursts: list) -> tuple[list, SessionAux]:
    """The goal/cycle loop of both replan sessions on S consecutive
    sub-fleets `parts` (this rank's rows `rows[s]` = (lo, hi) of its goals
    [G, R, d] each; None where it holds none of sub-fleet s): each goal
    round retargets every sub-fleet, then each cycle steps them in order,
    `bursts[s](state, oracle)` being sub-fleet s's optimization burst, or
    `bursts[s]()` that burst's collectives where this rank holds none of it.
    Returns the parts and the traces [G, cycles_per_goal, R, ...]."""
    traces = []
    for goal_row in goals:
        parts = [None if part is None else
                 solver.retarget(part, solver.full_trajectory(part)[:, follow_index],
                                 goal_row[lo:hi]) for part, (lo, hi) in zip(parts, rows)]
        for _ in range(cycles_per_goal):
            lengths, poses = [], []
            for s, part in enumerate(parts):
                # sub-fleet s+1 replans after sub-fleet s within the same cycle
                if part is None:
                    bursts[s]()
                    continue
                pose = solver.full_trajectory(part)[:, follow_index]
                parts[s] = bursts[s](solver.update_start(part, pose), oracles[s])
                lengths.append(_xy_length(solver.full_trajectory(parts[s])))
                poses.append(pose)
            traces.append((torch.cat(lengths), torch.cat(poses)))
    lead = (goals.shape[0], cycles_per_goal)
    return parts, SessionAux(*(_stack(list(xs), lead) for xs in zip(*traces)))


def replan_session(
    solver,
    state: Any,
    oracle_params: Any,
    goals,
    cycles_per_goal: int,
    steps_per_cycle: int,
    noise,
    follow_index: int = 3,
) -> tuple[Any, SessionAux]:
    """Single-robot session (`state`: a batch of one, as `NFOPPlanner` holds
    it): for each goal in `goals` [G, d], retarget then run `cycles_per_goal`
    replan cycles (pose-track + optimize burst with `noise`).

    Total cycles = G * cycles_per_goal; divide the session's wall time by
    that for the per-cycle latency. Traces are [G, cycles_per_goal, ...].
    """
    _check_steps(solver, steps_per_cycle)
    if state.start.shape[0] != 1:
        raise ValueError(f"replan_session drives one robot (a batch of one), got "
                         f"{state.start.shape[0]}; use fleet_replan_session")
    goals = _f32(goals, state.start)
    parts, aux = _goal_cycles(
        solver, [state], [oracle_params], [(0, 1)], goals[:, None], cycles_per_goal,
        follow_index, [lambda st, o: solver.run(st, o, steps_per_cycle, noise)[0]])
    return parts[0], SessionAux(*(x[:, :, 0] for x in aux))


def fleet_replan_session(
    solver,
    states: Any,
    oracle_params: Any,
    goals,
    cycles_per_goal: int,
    steps_per_cycle: int,
    group_size: int,
    noise,
    follow_index: int = 3,
    subgroups: int = 1,
) -> tuple[Any, SessionAux]:
    """Fleet session: R robots on one shared map (batched `states`,
    `oracle_params` batched per robot or with a leading axis of 1, `goals`
    [G, R, d]); each goal round retargets every robot, then runs
    `cycles_per_goal` batched cycles with one shared occupancy field per
    `group_size` robots (run_grouped — the FleetReplanningService stepping
    mode).

    subgroups=S > 1 splits the fleet into S consecutive sub-fleets of R/S
    robots and steps them one after the other inside each cycle: each burst
    is R/S robots wide, and the live state of a burst shrinks S-fold. Each
    sub-fleet keeps its own shared fields (groups never span sub-fleets), so
    `group_size` must divide R/S, and draws from its own noise source:
    `noise` is then a sequence of S sources (e.g. `subfleet_generators`), and
    sub-fleet s is bit for bit an independent (R/S)-robot session with
    source s. The schedule is the only change against subgroups=1. On a mesh
    (see the module) `goals` and per-robot oracles cover the whole fleet.
    """
    _check_steps(solver, steps_per_cycle)
    local = states.start.shape[0]
    first, robots = _mesh_rows(solver, local)
    goals = _f32(goals, states.start)[:, first:first + local]
    oracle_params = tree_rows(oracle_params, first, first + local, batch=robots)
    sources = [noise]
    if subgroups != 1:
        if robots % subgroups != 0:
            raise ValueError(f"fleet {robots} not divisible by subgroups {subgroups}")
        if (robots // subgroups) % group_size != 0:
            raise ValueError(
                f"sub-batch {robots // subgroups} not divisible by group_size {group_size} — "
                "shared-field groups must not span sequential sub-batches"
            )
        sources = list(noise)
        if len(sources) != subgroups:
            raise ValueError(f"subgroups={subgroups} needs one noise source per sub-fleet, "
                             f"got {len(sources)}")
    sub = robots // subgroups
    mesh = getattr(solver, "mesh", None)
    size = 1 if mesh is None else mesh.size
    parts, oracles, rows, bursts = [], [], [], []
    for s, source in enumerate(sources):
        lo, hi = max(s * sub, first), min((s + 1) * sub, first + local)
        part = solver
        if mesh is not None:  # every rank's rows of sub-fleet s
            part = solver.with_rows([(min(max(r * local - s * sub, 0), sub),
                                      min(max((r + 1) * local - s * sub, 0), sub))
                                     for r in range(size)])
        if lo >= hi:  # the burst's collectives, on a wire of one problem's field
            width = sum(x[0].numel() for x in tree_leaves(states.field_params))
            parts.append(None)
            oracles.append(None)
            rows.append((0, 0))
            bursts.append(lambda part=part, width=width: part.join_grouped(
                steps_per_cycle, group_size, width))
            continue
        parts.append(tree_rows(states, lo - first, hi - first))
        oracles.append(tree_rows(oracle_params, lo - first, hi - first, batch=local))
        rows.append((lo - first, hi - first))
        bursts.append(lambda st, o, part=part, source=source: part.run_grouped(
            st, o, steps_per_cycle, group_size, source)[0])
    parts, aux = _goal_cycles(solver, parts, oracles, rows, goals, cycles_per_goal, follow_index,
                              bursts)
    parts = [part for part in parts if part is not None]
    states = parts[0] if len(parts) == 1 else tree_map(lambda *xs: torch.cat(xs), *parts)
    return states, _gather_robots(aux, solver, 2)
