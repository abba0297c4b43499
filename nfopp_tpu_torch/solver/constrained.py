"""SE(2) constrained NFOPP solver on a batch of problems (port of
`nfopp_tpu/solver/constrained.py`).

    step = [field update: sample -> oracle -> BCE + grads -> Adam]
           [trajectory update: composite loss -> H^-1-preconditioned Adam
            -> dual ascent on both multiplier vectors]
           [at step counts 0, freq, 2freq, ...: arc-length reparametrization]

Every state tensor has a leading problem axis B, where the JAX package vmaps
a per-problem function; each problem still owns its field, optimizer states,
multipliers and replay buffer. Noise comes from a noise source
(`ops.sampling.GeneratorNoise` by default) in [B, ...] blocks per step, not
from per-problem keys, so a problem's random stream depends on its batch.

On CUDA the three field passes of a step go through the hand-written kernels
(`nfopp_tpu_torch.kernels`): candidate scoring, field loss and gradients, and
the trajectory's collision terms with their backward. On the CPU the same
calls run their plain PyTorch versions.

`run_grouped` is the shared-field group mode: each group of `group_size`
consecutive problems (one map) keeps one field, in lockstep replicas that
start identical (`init_state(group_size=...)`) and step on the group's mean
field gradient. The run loop and the field update are shared with
`HolonomicSolver` through `_FieldSolver`.

`with_mesh(mesh)` makes a copy whose batches are one rank's rows of a batch
sharded over a problem mesh (`parallel/mesh.py`): every random block is drawn
whole from a generator seeded alike on every rank and cut to this rank's
rows, and the run loop's host decision is agreed by all ranks. A group may
lie anywhere in the global batch, as in JAX (any group_size dividing it):
the groups whose rows more than one rank holds average their gradients with
one all_reduce per field step, every other group averages on its rank.
`with_rows(spans)` gives the ranks uneven rows (a sub-fleet's burst).
"""
from __future__ import annotations

import copy
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..kernels import collision_terms
from ..models.onf import init_onf_params, params_from_jax
from ..ops.hessian import inverse_velocity_hessian
from ..ops.losses import (
    boundary_loss,
    direction_constraint_deltas,
    distance_loss_se2,
    non_holonomic_constraint_deltas,
)
from ..ops.math import linspace, wrap_angle
from ..ops.reparametrize import (
    reparametrize_collision_multipliers,
    reparametrize_constraint_multipliers,
    reparametrize_se2,
)
from ..ops.sampling import GeneratorNoise, ShardNoise, uniform_box_points
from ..parallel.mesh import all_over_problems, sum_over_ranks
from ..utils import profiling
from ..utils.device import check_device
from ..utils.tree import tree_copy_, tree_leaves, tree_map, tree_where
from .adam import AdamState, adam_init, adam_update
from .config import SolverConfig
from .field import field_loss_and_grad, sample_field_points
from .schedule import scan_chunked, static_schedule

__all__ = ["ConstrainedState", "StepAux", "ConstrainedSolver", "state_from_jax"]

OracleFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _check_chunkable(name: str, num_steps: int, freq: int) -> None:
    """The grouped and batch-explicit run loops have no dynamic fallback: they
    need the static [reparam + freq-1 plain] chunk schedule (`constrained.py:52-61`)."""
    if freq <= 1:
        raise ValueError(f"{name} requires reparametrize_trajectory_freq > 1")
    if num_steps % freq != 0:
        raise ValueError(
            f"{name} requires num_steps ({num_steps}) to be a multiple of "
            f"reparametrize_trajectory_freq ({freq})"
        )


def _group_rows(tree: Any, batch: int, rows: torch.Tensor) -> Any:
    """One problem of each group: every leaf with a leading problem axis of
    `batch` rows keeps `rows` (the first row of each group held); shared
    leaves (axis 1) stay."""
    def pick(x):
        return x[rows] if x.ndim and x.shape[0] == batch else x

    return tree_map(pick, tree)


@functools.lru_cache(maxsize=1024)
def _segments(first: int, batch: int, group_size: int) -> tuple:
    """(group, lo, hi) for each group of `group_size` consecutive global rows
    that rows first .. first+batch-1 touch: rows [lo, hi) of the `batch`
    lie in it."""
    cuts = range(first // group_size * group_size, first + batch, group_size)
    return tuple((c // group_size, max(c - first, 0), min(c + group_size - first, batch))
                 for c in cuts)


@functools.lru_cache(maxsize=1024)
def _crossing_groups(spans: tuple, group_size: int) -> tuple:
    """The groups of which more than one rank holds rows (`spans`: every
    rank's rows [lo, hi) of the global batch), in order: one slot each on
    the wire of `_FieldSolver._group_mean_grads`."""
    holders: dict = {}
    for lo, hi in spans:
        for group, _, _ in (_segments(lo, hi - lo, group_size) if hi > lo else ()):
            holders[group] = holders.get(group, 0) + 1
    return tuple(sorted(g for g, n in holders.items() if n > 1))


def _group_mean(g: torch.Tensor, group_size: int) -> torch.Tensor:
    """Mean over each group of `group_size` consecutive batch rows, broadcast
    back to the full batch shape (every replica gets the same bits), in
    memory of its own (the Adam kernel takes contiguous leaves)."""
    grouped = g.reshape((g.shape[0] // group_size, group_size) + tuple(g.shape[1:]))
    mean = torch.mean(grouped, dim=1, keepdim=True)
    return mean.expand(grouped.shape).reshape(g.shape).contiguous()


def _check_groups(batch: int, group_size: int, bounds: torch.Tensor, oracle_params: Any,
                  first: int | None = None) -> None:
    """A shared-field group is one map: every problem of a group has the same
    bounds and oracle leaves (`parallel/batch.py:208-224`). With `first` the
    rows are a rank's, global rows first .. first+batch-1, each group checked
    as far as the rank holds it; without, the whole batch, which the groups
    divide."""
    if first is None:
        if group_size < 1 or batch % group_size != 0:
            raise ValueError(f"batch {batch} not divisible by group {group_size}")
        first = 0
    # each row's group's first row among these
    lead = torch.tensor([lo for _, lo, hi in _segments(first, batch, group_size)
                         for _ in range(hi - lo)])
    for name, tree in (("oracle_params", oracle_params), ("bounds", bounds)):
        for leaf in tree_leaves(tree):
            if leaf.ndim == 0 or leaf.shape[0] != batch:
                continue  # one world shared by the whole batch
            if not bool((leaf == leaf[lead.to(leaf.device)]).all()):
                raise ValueError(
                    f"{name} differ within a shared-field group; every problem in a "
                    "group must share one map"
                )


class ConstrainedState(NamedTuple):
    """Solver state of a batch of problems (every leaf [B, ...])."""

    trajectory: torch.Tensor  # [B, N, 3] interior waypoints (x, y, theta)
    field_params: dict  # ONF parameters
    field_opt_state: AdamState  # Adam state of the field
    traj_opt_state: AdamState  # Adam state of the trajectory
    constraint_multipliers: torch.Tensor  # [B, N+1] non-holonomic multipliers
    collision_multipliers: torch.Tensor  # [B, N] collision multipliers (>= 0)
    buffer_points: torch.Tensor  # [B, K, 3] replay buffer
    buffer_ages: torch.Tensor  # [B, K]
    prev_trajectory: torch.Tensor  # [B, N, 3] snapshot for field sampling
    start: torch.Tensor  # [B, 3]
    goal: torch.Tensor  # [B, 3]
    bounds: torch.Tensor  # [B, 4] (xmin, xmax, ymin, ymax)
    step_count: torch.Tensor  # [B] int32


class StepAux(NamedTuple):
    field_loss: torch.Tensor  # [B] (or [B, steps] from run)
    trajectory_loss: torch.Tensor


def _as_noise(noise):
    return GeneratorNoise(noise) if isinstance(noise, torch.Generator) else noise


def _program_generator(noise) -> torch.Generator:
    """The generator a captured program draws from: `noise` itself or the
    one a `GeneratorNoise` wraps."""
    generator = noise.generator if isinstance(noise, GeneratorNoise) else noise
    if not isinstance(generator, torch.Generator):
        raise ValueError(
            f"a captured run draws its noise from a torch.Generator on the card, not a "
            f"{type(noise).__name__}: pass torch.Generator(device='cuda') (seeded), or run "
            "the solver without with_aot"
        )
    return generator


class _FieldSolver:
    """What the constrained and holonomic solvers share: the field update and
    its pretraining, the step schedule and the run loop. A subclass sets
    `_pose_dim` (3 for SE(2) poses, 2 for points) and gives the trajectory
    update (`_trajectory_step`) and the reparametrization (`_reparametrize`).
    """

    _pose_dim = 3
    # set by `with_mesh`: the problem mesh whose ranks each hold rows of the batch
    mesh = None

    def __init__(self, config: SolverConfig, oracle_fn: OracleFn, device, who: str):
        self.config = config
        self.oracle_fn = oracle_fn
        self.device = check_device(device, who)
        n = config.trajectory_length
        self._inv_hessian = torch.as_tensor(
            inverse_velocity_hessian(n, config.velocity_hessian_weight), device=self.device
        )

    def _tensor(self, value) -> torch.Tensor:
        """A caller's array as a contiguous float32 tensor on the solver's
        device (a trajectory given to `init_state` is a leaf of the Adam
        kernel, which takes contiguous leaves)."""
        if torch.is_tensor(value):
            return value.to(dtype=torch.float32, device=self.device).contiguous()
        return torch.tensor(np.asarray(value), dtype=torch.float32, device=self.device)

    def _field_adam(self, grads, opt_state, params):
        b1, b2 = self.config.collision_betas
        return adam_update(grads, opt_state, params, self.config.collision_lr, b1, b2,
                           self.config.adam_eps)

    def _traj_adam(self, grads, opt_state, params):
        b1, b2 = self.config.trajectory_betas
        return adam_update(grads, opt_state, params, self.config.trajectory_lr, b1, b2,
                           self.config.adam_eps)

    # ------------------------------------------------------------ the mesh

    def with_mesh(self, mesh):
        """A copy of this solver whose batches hold one rank's rows of a
        batch sharded over `mesh` (`parallel.mesh.ProblemMesh`): the rows
        [rank*b, (rank+1)*b) of a global batch of mesh.size*b problems."""
        solver = copy.copy(self)
        solver.mesh = mesh
        solver.spans = None
        return solver

    # set by `with_rows`: every rank's rows of this copy's global batches
    spans: tuple | None = None

    def with_rows(self, spans):
        """A copy of this mesh solver whose batches are this rank's rows of a
        global batch that the ranks hold unevenly: `spans` gives every rank's
        rows [lo, hi), in rank order, from 0 to the global batch (a rank may
        hold none). A sub-fleet's burst runs on such a copy."""
        spans = tuple((int(lo), int(hi)) for lo, hi in spans)
        if self.mesh is None or len(spans) != self.mesh.size or spans[0][0] != 0 or any(
                a[1] != b[0] for a, b in zip(spans, spans[1:])) or any(
                lo > hi for lo, hi in spans):
            raise ValueError(f"spans {spans} do not split a global batch over the mesh's "
                             f"{1 if self.mesh is None else self.mesh.size} ranks")
        solver = copy.copy(self)
        solver.spans = spans
        return solver

    def _spans(self, batch: int) -> tuple:
        """Every rank's rows [lo, hi) of the global batch of which this rank
        holds `batch`: the `with_rows` spans, or the mesh's even split."""
        if self.spans is not None:
            lo, hi = self.spans[self.mesh.rank]
            if hi - lo != batch:
                raise ValueError(f"a batch of {batch} on rank {self.mesh.rank}, whose rows "
                                 f"are {lo}:{hi} of {self.spans[-1][1]}")
            return self.spans
        size = 1 if self.mesh is None else self.mesh.size
        return tuple((r * batch, (r + 1) * batch) for r in range(size))

    def _first_row(self, batch: int) -> int:
        """The global row of this rank's first of `batch` rows."""
        return self._spans(batch)[0 if self.mesh is None else self.mesh.rank][0]

    def _block_rows(self, batch: int, per: int = 1) -> tuple[int, slice]:
        """(rows of the global block, this rank's rows of it) for a block
        with one row per `per` consecutive problems, this rank holding
        `batch` problems."""
        first = self._first_row(batch)
        lo, hi = first // per, (first + batch - 1) // per + 1
        return self._spans(batch)[-1][1] // per, slice(lo, hi)

    def _rand(self, generator: torch.Generator, batch: int, shape: tuple, per: int = 1):
        """Uniform draws [rows, *shape] from `generator`, one row per `per`
        problems: this rank's rows of the block drawn for the global batch."""
        total, rows = self._block_rows(batch, per)
        u = torch.rand((total,) + tuple(shape), generator=generator, device=generator.device)
        return u[rows].to(self.device)

    def _group_of_rows(self, batch: int, group_size: int) -> torch.Tensor:
        """For each of this rank's `batch` rows, its group's index among the
        groups of `group_size` whose rows this rank holds."""
        first = self._first_row(batch)
        rows = torch.arange(first, first + batch, device=self.device)
        return torch.div(rows, group_size, rounding_mode="floor") - first // group_size

    def _group_firsts(self, batch: int, group_size: int) -> torch.Tensor:
        """This rank's first row in each group of `group_size` it holds rows
        of."""
        segments = _segments(self._first_row(batch), batch, group_size)
        return torch.tensor([lo for _, lo, _ in segments], device=self.device)

    def _init_field(self, generator: torch.Generator, batch: int, group_size: int = 1):
        """Field parameters of `batch` problems, drawn once per group of
        `group_size` over the global batch and repeated over this rank's rows
        of each group."""
        total, rows = self._block_rows(batch, group_size)
        params = init_onf_params(generator, self.config.onf, total, self.device)
        index = self._group_of_rows(batch, group_size)
        return tree_map(lambda x: x[rows][index], params)

    def _noise(self, noise, batch: int):
        """The noise source of a step of `batch` problems: on a mesh, this
        rank's rows of every block drawn for the global batch."""
        noise = _as_noise(noise)
        if self.mesh is None or self.mesh.size == 1 or isinstance(noise, ShardNoise):
            return noise
        total, rows = self._block_rows(batch)
        return ShardNoise(noise, rows, total)

    def _check_group_size(self, batch: int, group_size: int) -> None:
        """A group size divides the global batch, as in JAX; its groups may
        lie anywhere across the ranks' rows."""
        total = self._spans(batch)[-1][1]
        if group_size < 1 or total % group_size != 0:
            what = "batch" if total == batch else "global batch"
            raise ValueError(f"{what} {total} not divisible by group_size {group_size}")

    def _group_mean_grads(self, grads, batch: int, group_size: int):
        """Each group's mean gradient on every replica. A group whose rows
        this rank alone holds averages here (`_group_mean`); for the groups
        of which several ranks hold rows, every rank builds the same [slots,
        width] wire (one slot per such group, every leaf flattened), writes
        the sum of its own rows of each into its slot, and the ranks meet in
        ONE all_reduce (`sum_over_ranks`, a segment boundary of a captured
        program: `utils.aot.between_replays`), after which each slot divided
        by group_size is the group's mean, the same bits on every rank. A
        rank makes this collective whenever any group crosses ranks, even
        with none of its own rows in one."""
        slots = _crossing_groups(self._spans(batch), group_size)
        if not slots:  # every group lies inside one rank
            return tree_map(lambda g: _group_mean(g, group_size), grads)
        segments = _segments(self._first_row(batch), batch, group_size)
        # this rank's rows of groups that cross ranks (at most its first and
        # last group), and the whole groups between them
        crossing = [(slots.index(group), lo, hi) for group, lo, hi in segments if group in slots]
        whole = [(lo, hi) for group, lo, hi in segments if group not in slots]
        leaves = tree_leaves(grads)
        widths = [g[0].numel() for g in leaves]
        wire = torch.zeros((len(slots), sum(widths)), dtype=leaves[0].dtype, device=self.device)
        for slot, lo, hi in crossing:
            wire[slot] = torch.cat([torch.sum(g[lo:hi], dim=0).reshape(-1) for g in leaves])
        mean = self._sum_over_ranks(wire) / group_size
        crossed = {slot: torch.split(mean[slot], widths) for slot, _, _ in crossing}

        def average(i, g):
            shape = tuple(g.shape[1:])
            pieces = [(lo, crossed[slot][i].reshape(shape).expand((hi - lo,) + shape))
                      for slot, lo, hi in crossing]
            if whole:
                a, b = whole[0][0], whole[-1][1]
                pieces.append((a, _group_mean(g[a:b], group_size)))
            pieces.sort(key=lambda piece: piece[0])
            if len(pieces) == 1:
                return pieces[0][1].contiguous()
            return torch.cat([x for _, x in pieces])

        averaged = iter([average(i, g) for i, g in enumerate(leaves)])
        return tree_map(lambda _: next(averaged), grads)

    def _sum_over_ranks(self, wire: torch.Tensor) -> torch.Tensor:
        """The wire summed over the ranks: a host step between the segments
        of a captured program (`utils.aot.between_replays`)."""
        from ..utils.aot import between_replays

        return between_replays(wire, lambda x: sum_over_ranks(x, self.mesh))

    def join_grouped(self, num_steps: int, group_size: int, width: int) -> None:
        """This rank's part in a `run_grouped` of `num_steps` steps over a
        copy made by `with_rows` in which it holds no rows: the burst's
        collectives, one per field step while a group crosses ranks, each
        with an empty wire of `width` (a problem's field, flattened), so
        that the ranks that hold rows meet in theirs. The field steps are
        those of `_chunks`' schedule (`static_schedule`)."""
        slots = _crossing_groups(self.spans, group_size)
        if not slots:
            return
        wire = torch.zeros((len(slots), width), device=self.device)
        schedule = static_schedule(num_steps, self.config.reparametrize_trajectory_freq,
                                   self._static_field_stride())
        for _, with_field in schedule:
            if with_field:
                sum_over_ranks(wire, self.mesh)

    # ------------------------------------------------------------------ init

    def _pretrain_field(self, state, oracle_params, generator, group_size: int = 1):
        """Field pretraining on uniform random points, on the first problem of
        each group of `group_size` (whose replicas share its field, bounds and
        world), then repeated over the group. On a copy made by `with_aot` the
        iterations are replays of one captured iteration,
        `<prefix>-pretrain-b<rows>[-g<G>]` (rows: one per group on this rank),
        drawing from `generator` in the eager order. A group whose rows
        several ranks hold pretrains on each of them with no collective: each
        draws the group's row of the global block, so its replicas stay
        equal, and it captures too."""
        cfg = self.config
        batch = state.start.shape[0]
        firsts = self._group_firsts(batch, group_size)
        carry = _group_rows((state.field_params, state.field_opt_state), batch, firsts)
        bounds = state.bounds[firsts]
        oracle_params = _group_rows(oracle_params, batch, firsts)

        def iterations(carry, bounds, oracle_params, generator, count: int):
            params, opt_state = carry
            for _ in range(count):
                u = self._rand(generator, batch, (cfg.init_collision_points, self._pose_dim),
                               group_size)
                points = uniform_box_points(u, bounds, self._pose_dim == 3)
                truth = self.oracle_fn(oracle_params, points)
                _, grads = field_loss_and_grad(cfg, params, points, truth)
                params, opt_state = self._field_adam(grads, opt_state, params)
            return params, opt_state

        if self.aot_prefix is None:
            carry = iterations(carry, bounds, oracle_params, generator,
                               cfg.init_collision_iteration)
        else:
            rows = bounds.shape[0]
            if self.device.type == "cuda":
                generator = _program_generator(generator)
            else:
                carry = tree_map(torch.clone, carry)  # uncaptured, the body writes into its input
            program = self._program(
                f"pretrain-b{rows}" + (f"-g{group_size}" if group_size > 1 else ""),
                lambda c, b, o, g: tree_copy_(c, iterations(c, b, o, g, 1)),
                (carry, bounds, oracle_params, generator),
                cfg.init_collision_points, group_size, rows)
            for _ in range(cfg.init_collision_iteration):
                carry = program(carry, bounds, oracle_params, generator)
        # a new tensor per leaf: on the card the carry is the program's buffers
        index = self._group_of_rows(batch, group_size)
        params, opt_state = tree_map(lambda x: x[index], carry)
        return state._replace(field_params=params, field_opt_state=opt_state)

    # ------------------------------------------------------------------ step

    def full_trajectory(self, state) -> torch.Tensor:
        """[B, N+2, d] trajectories with the pinned endpoints."""
        return torch.cat([state.start[:, None], state.trajectory, state.goal[:, None]], dim=1)

    def step(self, state, oracle_params: Any, noise):
        """One step with the reference's dynamic schedule, decided per problem
        from step_count (reparametrization computed for all, kept where due)."""
        noise = self._noise(noise, state.start.shape[0])
        state, field_loss, traj_loss = self._field_and_trajectory(state, oracle_params, noise)
        due = state.step_count % self.config.reparametrize_trajectory_freq == 0
        state = tree_where(due, self._reparametrize(state), state)
        state = state._replace(step_count=state.step_count + 1)
        return state, StepAux(field_loss, traj_loss)

    def _field_and_trajectory(self, state, oracle_params, noise, with_field: bool | None = None,
                              group_size: int = 1):
        """Field update, then the trajectory update that reads the new field.

        with_field: None = config-driven (every step, or where step_count %
        optimize_collision_model_freq == 0); True/False = decided statically.
        group_size > 1: the field steps on each group's mean gradient.
        """
        cfg = self.config
        batch = state.start.shape[0]
        if with_field is False:
            field_loss = torch.zeros((batch,), device=self.device)
        elif with_field is True or cfg.optimize_collision_model_freq == 1:
            state, field_loss = self._field_step(state, oracle_params, noise, group_size)
        else:
            due = state.step_count % cfg.optimize_collision_model_freq == 0
            trained, loss = self._field_step(state, oracle_params, noise, group_size)
            state = tree_where(due, trained, state)
            field_loss = torch.where(due, loss, torch.zeros_like(loss))
        state, traj_loss = self._trajectory_step(state, noise)
        return state, field_loss, traj_loss

    def step_static(self, state, oracle_params: Any, noise, with_reparam: bool,
                    with_field: bool | None = None, group_size: int = 1):
        """Step with the reparametrization (and optionally the field update)
        decided by the caller, as `run`'s static schedule does; group_size > 1
        for the shared-field group mode (`run_grouped`)."""
        noise = self._noise(noise, state.start.shape[0])
        state, field_loss, traj_loss = self._field_and_trajectory(
            state, oracle_params, noise, with_field, group_size
        )
        if with_reparam:
            state = self._reparametrize(state)
        state = state._replace(step_count=state.step_count + 1)
        return state, StepAux(field_loss, traj_loss)

    def _field_grads(self, state, oracle_params: Any, noise, group_size: int = 1):
        """Sample -> oracle -> BCE loss + parameter grads (no update); with
        group_size > 1 the grads are each group's mean (the losses stay per
        problem, each on its own training points)."""
        cfg = self.config
        sample = sample_field_points(
            cfg, noise, state.prev_trajectory, state.buffer_points, state.buffer_ages,
            state.field_params, state.bounds,
        )
        truth = self.oracle_fn(oracle_params, sample.train_points)
        loss, grads = field_loss_and_grad(cfg, state.field_params, sample.train_points, truth)
        if group_size > 1:
            grads = self._group_mean_grads(grads, state.start.shape[0], group_size)
        return sample, loss, grads

    def _apply_field_update(self, state, sample, grads):
        params, opt_state = self._field_adam(grads, state.field_opt_state, state.field_params)
        return state._replace(
            field_params=params,
            field_opt_state=opt_state,
            buffer_points=sample.buffer_points,
            buffer_ages=sample.buffer_ages,
            prev_trajectory=state.trajectory,
        )

    def _field_step(self, state, oracle_params, noise, group_size: int = 1):
        sample, loss, grads = self._field_grads(state, oracle_params, noise, group_size)
        return self._apply_field_update(state, sample, grads), loss

    # ------------------------------------------------------------- run loop

    def _static_field_stride(self) -> int:
        s = self.config.optimize_collision_model_freq
        freq = self.config.reparametrize_trajectory_freq
        return s if s > 1 and freq % s == 0 else 1

    def _check_static_field_stride(self, what: str) -> None:
        """The run loops without a dynamic schedule (grouped, batch-explicit)
        train the field every step or at a static stride only."""
        if self.config.optimize_collision_model_freq != 1 and self._static_field_stride() == 1:
            raise NotImplementedError(
                f"{what} requires optimize_collision_model_freq == 1 "
                "or one that divides reparametrize_trajectory_freq"
            )

    def run(self, state, oracle_params: Any, num_steps: int, noise):
        """Run `num_steps` steps; aux is stacked [B, num_steps].

        With num_steps a multiple of reparametrize_trajectory_freq and every
        problem at the start of a chunk (step_count % freq == 0, as after
        init_state / update_* / set_boundaries / retarget) the schedule is
        static (`scan_chunked`); otherwise it is dynamic: every step decides
        from step_count (`step`). On a solver made by `with_aot` the static
        schedule replays the captured chunk program and the dynamic one the
        captured one-step program. Reading step_count costs one device sync
        per call, outside any program; on a mesh the ranks agree on the
        schedule (one small all_reduce). The call is a `run` span
        (`utils.profiling`), the read a `sync` span inside it.
        """
        freq = self.config.reparametrize_trajectory_freq
        with profiling.span("run", steps=num_steps, batch=state.start.shape[0]) as span:
            aligned = freq > 1 and all_over_problems(state.step_count % freq == 0, self.mesh)
            static = aligned and num_steps % freq == 0
            if span is not None:
                span.attrs["schedule"] = "static" if static else "dynamic"
            if static:
                return self._static_run(state, oracle_params, num_steps, noise)
            if self.aot_prefix is None:
                return self._steps(state, oracle_params, num_steps, noise)
            return self._run_program(f"step-b{state.start.shape[0]}", self._steps, 1, state,
                                     oracle_params, num_steps, noise)

    def _steps(self, state, oracle_params: Any, num_steps: int, noise):
        """`num_steps` steps of the dynamic schedule (`step`); aux stacked
        [B, num_steps]."""
        noise = self._noise(noise, state.start.shape[0])
        aux = []
        for _ in range(num_steps):
            state, a = self.step(state, oracle_params, noise)
            aux.append(a)
        return state, StepAux(*(torch.stack(xs, dim=1) for xs in zip(*aux)))

    def _static_run(self, state, oracle_params: Any, num_steps: int, noise, group_size: int = 1):
        """`num_steps` steps (a multiple of the reparametrization freq) of the
        static schedule from a chunk's start: eagerly, or as replays of the
        captured chunk program for a solver made by `with_aot`."""
        if self.aot_prefix is None:
            return self._chunks(state, oracle_params, num_steps, noise, group_size)
        name = f"chunk-b{state.start.shape[0]}" + (f"-g{group_size}" if group_size > 1 else "")
        return self._run_program(
            name, lambda s, o, n, g: self._chunks(s, o, n, g, group_size),
            self.config.reparametrize_trajectory_freq, state, oracle_params, num_steps, noise,
            group_size)

    def _chunks(self, state, oracle_params: Any, num_steps: int, noise, group_size: int):
        """`num_steps` steps of `scan_chunked`'s schedule; aux stacked [B, num_steps]."""
        stride = self._static_field_stride()

        def step_fn(s, with_reparam, with_field):
            return self.step_static(s, oracle_params, noise, with_reparam,
                                    with_field if stride > 1 else None, group_size)

        state, aux = scan_chunked(step_fn, state, num_steps,
                                  self.config.reparametrize_trajectory_freq, field_stride=stride)
        return state, StepAux(*(torch.stack(xs, dim=1) for xs in zip(*aux)))

    # ------------------------------------------------------ captured programs

    # set by `with_aot`: runs and pretraining replay captured programs
    aot_prefix: str | None = None

    def with_aot(self, prefix: str):
        """A copy of this solver whose runs and pretraining replay captured
        programs (`utils.aot.aot_or_compile`: the counterpart of the JAX
        package's compiled `run` and `init_state`):

        - the static schedule (`run` from a chunk's start, `run_grouped`, and
          the tracked loops, planners and services over them): one program
          per chunk, `<prefix>-chunk-b<B>[-g<G>]`, the eager schedule's freq
          steps through the same `step_static` (JAX's `scan_chunked`);
        - the dynamic schedule (`run` off a chunk's start, or of a step count
          off the chunk): one program per step, `<prefix>-step-b<B>`, the same
          `step` (JAX's `lax.scan` of `step`);
        - pretraining in `init_state`: one program per iteration,
          `<prefix>-pretrain-b<rows>[-g<G>]` (JAX's `fori_loop`).

        On the card the noise must come from a CUDA `torch.Generator` (or a
        `GeneratorNoise` over one); on the CPU each program is its eager
        function. `aot_events` lists each program the copy resolved: captured
        (loaded False) or taken from the process's store.

        On a mesh, a chunk whose groups cross ranks makes one all_reduce per
        field step, which goes through the host under gloo and so cannot sit
        inside a CUDA graph: its program is captured as segments that end at
        each collective (`utils.aot.between_replays`). A segment writes the
        group sums into a fixed buffer, the host runs `sum_over_ranks` on it
        between the replays, and the next segment reads the result from a
        fixed buffer: a chunk of freq field steps costs freq collectives, as
        eagerly, and freq + 1 replays. A program's key holds the mesh's rank
        and size and the ranks' rows (`with_rows`), besides the shapes."""
        solver = copy.copy(self)
        solver.aot_prefix = prefix
        solver.aot_events = []
        solver._aot_keys = set()
        return solver

    def _step_order(self) -> str:
        """The order of the field and trajectory updates in a step, part of a
        captured program's key: "default" here (the trajectory reads the
        updated field); a subclass with other orders names its own."""
        return "default"

    def _program(self, name: str, body: Callable, args: tuple, *key_parts):
        """The captured program `<aot_prefix>-<name>` of `body` on `args`,
        listed once per key in `aot_events`. The key holds the class, the
        oracle, the config, the step order, the precision, the mesh layout
        (rank, size, `with_rows` spans), the arguments' shapes and
        `key_parts`. The key's building and the store's lookup (or the
        capture) are a `program` span."""
        from ..utils.aot import aot_or_compile, shape_digest

        cfg = self.config
        layout = None if self.mesh is None else (self.mesh.rank, self.mesh.size, self.spans)
        with profiling.span("program", program=f"{self.aot_prefix}-{name}") as span:
            program = aot_or_compile(
                f"{self.aot_prefix}-{name}", body, args, type(self).__name__,
                repr(self.oracle_fn), cfg, self._step_order(), cfg.onf.compute_dtype, layout,
                *map(shape_digest, args), *key_parts,
            )
            if span is not None:
                span.attrs["loaded"] = program.loaded
        if program.key not in self._aot_keys:
            self._aot_keys.add(program.key)
            event = {"program": name, "loaded": program.loaded,
                     "seconds": round(program.seconds, 2)}
            segments = getattr(program.fn, "segments", 1)
            if segments > 1:  # captured in segments around the chunk's collectives
                event["segments"] = segments
            self.aot_events.append(event)
        return program

    def _run_program(self, name: str, steps: Callable, span: int, state, oracle_params: Any,
                     num_steps: int, noise, group_size: int = 1, key_parts: tuple = ()):
        """`num_steps` steps as replays of one captured program of `span`
        steps, `<aot_prefix>-<name>`: a chunk of the static schedule (span =
        freq) or one step of the dynamic one (span = 1). `steps(state,
        oracle_params, num_steps, noise)` runs the schedule eagerly; the
        program's body is `span` steps of it with the final state written
        into the input's own tensors, whose buffers then carry the state to
        the next replay. The key holds the group size, the span and
        `key_parts` besides `_program`'s. Each replay's aux is copied into
        [B, num_steps] buffers. Each program call is a `replay` span, the
        output state's clone a `run.outputs` span."""
        batch = state.start.shape[0]
        on_card = self.device.type == "cuda"
        if on_card:
            noise = _program_generator(noise)
        else:
            state = tree_map(torch.clone, state)  # uncaptured, the body writes into its input

        def body(s, o, g):
            new, aux = steps(s, o, span, g)
            return tree_copy_(s, new), aux

        program = self._program(name, body, (state, oracle_params, noise), group_size, span,
                                *key_parts)
        aux = StepAux(*(torch.empty((batch, num_steps), device=self.device) for _ in range(2)))
        for c in range(num_steps // span):
            with profiling.span("replay"):
                state, replay_aux = program(state, oracle_params, noise)
            for buf, a in zip(aux, replay_aux):
                buf[:, c * span:(c + 1) * span] = a
        # on the card the state is the program's buffers, which its next replay overwrites
        with profiling.span("run.outputs"):
            return (tree_map(torch.clone, state) if on_card else state), aux

    # ------------------------------------------------- live problem updates

    def set_boundaries(self, state, bounds):
        """New boundary boxes [B, 4]; resets the schedule."""
        return state._replace(bounds=self._tensor(bounds),
                              step_count=torch.zeros_like(state.step_count))


class ConstrainedSolver(_FieldSolver):
    """Hyperparameters, oracle and constants of a batched solve.

    Methods map a batched state to a new one. The oracle is a callable
    `(oracle_params, positions [B, M, 3]) -> bool [B, M]`.
    """

    def __init__(self, config: SolverConfig, oracle_fn: OracleFn, device="cuda"):
        super().__init__(config, oracle_fn, device, "ConstrainedSolver")

    # ------------------------------------------------------------------ init

    def initial_trajectory(self, start: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """Straight-line xy + wrapped-delta angle interpolation, [B, N, 3]."""
        m = self.config.trajectory_length + 2
        start, goal = self._tensor(start), self._tensor(goal)
        x = linspace(start[:, 0], goal[:, 0], m)[:, 1:-1]
        y = linspace(start[:, 1], goal[:, 1], m)[:, 1:-1]
        goal_angle = start[:, 2] + wrap_angle(goal[:, 2] - start[:, 2])
        theta = linspace(start[:, 2], goal_angle, m)[:, 1:-1]
        trajectory = torch.stack([x, y, theta], dim=-1)
        if self.config.init_angles_with_trajectory:
            trajectory = self._blend_angles_with_direction(trajectory, start, goal)
        return trajectory

    def _blend_angles_with_direction(self, trajectory, start, goal):
        """Central-difference heading blended in by a triangular ramp."""
        n = trajectory.shape[1]
        full = torch.cat([start[:, None], trajectory, goal[:, None]], dim=1)
        headings = torch.atan2(full[:, 2:, 1] - full[:, :-2, 1], full[:, 2:, 0] - full[:, :-2, 0])
        zero, one = torch.zeros(1, device=self.device), torch.ones(1, device=self.device)
        weights = torch.cat([linspace(zero, one, n // 2)[0], linspace(one, zero, (n + 1) // 2)[0]])
        delta = wrap_angle(headings - trajectory[..., 2]) * weights
        return torch.cat([trajectory[..., :2], (trajectory[..., 2] + delta)[..., None]], dim=-1)

    def init_state(
        self,
        generator: torch.Generator,
        start,
        goal,
        bounds,
        oracle_params: Any,
        trajectory: torch.Tensor | None = None,
        group_size: int = 1,
    ) -> ConstrainedState:
        """Fresh state for a batch of problems: start/goal [B, 3], bounds [B, 4].

        Field init, the replay buffer's uniform pre-fill and any pretraining
        draw from `generator`, in that order; on a copy made by `with_aot`
        the pretraining replays its captured iteration (`_pretrain_field`),
        and the state equals the eager init's bit for bit. With group_size >
        1 (the shared-field group mode, `run_grouped`) the field init and the
        pretraining points are drawn once per group of `group_size`
        consecutive problems and repeated over it, so a group's replicas
        start identical (JAX gives them one
        `field_key`, `constrained.py:157`); each problem still draws its own
        replay buffer. A group must share one map: B divisible by group_size,
        equal bounds and oracle leaves within each group. On a mesh the
        arguments are this rank's rows, every draw is cut from the global
        batch's block, and a group may lie anywhere across the ranks' rows
        (group_size dividing the global batch). An `init` span, its
        pretraining a `pretrain` span.
        """
        with profiling.span("init", batch=len(start)):
            cfg = self.config
            start, goal, bounds = self._tensor(start), self._tensor(goal), self._tensor(bounds)
            batch = start.shape[0]
            if group_size != 1:
                self._check_group_size(batch, group_size)
                _check_groups(batch, group_size, bounds, oracle_params, self._first_row(batch))
            trajectory = (self.initial_trajectory(start, goal) if trajectory is None
                          else self._tensor(trajectory))
            field_params = self._init_field(generator, batch, group_size)
            u = self._rand(generator, batch, (cfg.collision_point_count, 3))
            n = cfg.trajectory_length
            state = ConstrainedState(
                trajectory=trajectory,
                field_params=field_params,
                field_opt_state=adam_init(field_params),
                traj_opt_state=adam_init(trajectory),
                constraint_multipliers=torch.zeros((batch, n + 1), device=self.device),
                collision_multipliers=torch.zeros((batch, n), device=self.device),
                buffer_points=uniform_box_points(u, bounds, with_angle=True),
                buffer_ages=torch.zeros((batch, cfg.collision_point_count), device=self.device),
                prev_trajectory=trajectory,
                start=start,
                goal=goal,
                bounds=bounds,
                step_count=torch.zeros((batch,), dtype=torch.int32, device=self.device),
            )
            if cfg.init_collision_iteration > 0:
                with profiling.span("pretrain"):
                    state = self._pretrain_field(state, oracle_params, generator, group_size)
            return state

    # ------------------------------------------------------- trajectory loss

    def trajectory_loss(
        self,
        trajectory: torch.Tensor,
        constraint_multipliers: torch.Tensor,
        collision_multipliers: torch.Tensor,
        field_params: dict,
        start: torch.Tensor,
        goal: torch.Tensor,
        bounds: torch.Tensor,
        t: torch.Tensor,
    ) -> torch.Tensor:
        """Composite SE(2) objective per problem [B]. `t` [B, N-1, S] holds S
        uniform samples per segment, drawn outside so value and grads share
        them; the collision terms go through the `collision_terms` kernel
        on CUDA."""
        cfg = self.config
        full = torch.cat([start[:, None], trajectory, goal[:, None]], dim=1)
        samples = t.shape[-1]
        collision_positions, multipliers = self.collision_inputs(
            trajectory, collision_multipliers, t)
        collision_loss, multiplier_loss = collision_terms(
            field_params, collision_positions, multipliers, cfg.onf, cfg.collision_beta
        )
        collision_loss = collision_loss / samples
        multiplier_loss = multiplier_loss / samples

        constraint_deltas = non_holonomic_constraint_deltas(full)
        direction_deltas = torch.clamp(direction_constraint_deltas(full), min=0.0)

        return (
            distance_loss_se2(full, cfg.angle_weight)
            + collision_loss * cfg.collision_weight
            + torch.sum(constraint_multipliers * constraint_deltas, dim=1)
            + torch.sum(constraint_deltas**2, dim=1) * cfg.constraint_deltas_weight
            + boundary_loss(trajectory, bounds) * cfg.boundary_weight
            + multiplier_loss
            + cfg.direction_delta_weight * torch.sum(direction_deltas**2, dim=1)
        )

    def collision_inputs(
        self, trajectory: torch.Tensor, collision_multipliers: torch.Tensor, t: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The collision terms' points [B, (N-1) S, 3], at `t` [B, N-1, S]
        along each segment (angles along the wrapped difference), and their
        multipliers [B, (N-1) S], interpolated the other way round as the
        reference does."""
        batch = trajectory.shape[0]
        delta = trajectory[:, :-1] - trajectory[:, 1:]
        delta = torch.cat([delta[..., :2], wrap_angle(delta[..., 2:])], dim=-1)
        positions = (
            trajectory[:, 1:, None, :] + t[..., None] * delta[:, :, None, :]
        ).reshape(batch, -1, 3)
        multipliers = (
            collision_multipliers[:, 1:, None] * (1.0 - t) + collision_multipliers[:, :-1, None] * t
        ).reshape(batch, -1)
        return positions, multipliers

    def _trajectory_step(self, state: ConstrainedState, noise) -> tuple[ConstrainedState, torch.Tensor]:
        """Primal step (H^-1-preconditioned Adam) + dual ascent on both
        multiplier vectors (collision multipliers projected onto >= 0)."""
        cfg = self.config
        batch = state.start.shape[0]
        n = cfg.trajectory_length
        t = noise.uniform((batch, n - 1, cfg.collision_samples_per_segment), self.device)
        with torch.enable_grad():
            leaves = [
                x.detach().requires_grad_(True)
                for x in (state.trajectory, state.constraint_multipliers,
                          state.collision_multipliers)
            ]
            loss = self.trajectory_loss(
                *leaves, state.field_params, state.start, state.goal, state.bounds, t
            )
            traj_grad, cons_grad, coll_grad = torch.autograd.grad(loss.sum(), leaves)

        traj_grad = torch.matmul(self._inv_hessian, traj_grad)
        trajectory, opt_state = self._traj_adam(traj_grad, state.traj_opt_state, state.trajectory)
        constraint_multipliers = state.constraint_multipliers + cfg.multipliers_lr * cons_grad
        collision_multipliers = torch.clamp(
            state.collision_multipliers + cfg.collision_multipliers_lr * coll_grad, min=0.0
        )
        return (
            state._replace(
                trajectory=trajectory,
                traj_opt_state=opt_state,
                constraint_multipliers=constraint_multipliers,
                collision_multipliers=collision_multipliers,
            ),
            loss.detach(),
        )

    # -------------------------------------------------------- reparametrize

    def _reparametrize(self, state: ConstrainedState) -> ConstrainedState:
        """Arc-length reparametrization of the trajectory and both
        multiplier vectors."""
        trajectory, interp = reparametrize_se2(self.full_trajectory(state))
        return state._replace(
            trajectory=trajectory,
            collision_multipliers=reparametrize_collision_multipliers(
                state.collision_multipliers, interp
            ),
            constraint_multipliers=reparametrize_constraint_multipliers(
                state.constraint_multipliers, interp
            ),
        )

    # ------------------------------------------ shared-field group mode

    def run_grouped(self, states, oracle_params, num_steps: int, group_size: int, noise):
        """`run` with one shared field per group of `group_size` consecutive
        problems (same map: portfolio restarts, multi-query planning). Start
        from `init_state(..., group_size=group_size)` so the replicas start
        identical; every field step applies the group's mean gradient, which
        keeps them in lockstep. Draws the same noise as `run` (group_size=1
        reproduces it exactly).

        The schedule is static only: num_steps a multiple of the
        reparametrization freq, and every problem entering at a chunk's start
        (step_count % freq == 0, not checked), as JAX's `run_grouped`.
        """
        freq = self.config.reparametrize_trajectory_freq
        _check_chunkable("run_grouped", num_steps, freq)
        self._check_group_size(states.trajectory.shape[0], group_size)
        self._check_static_field_stride("shared-field mode")
        with profiling.span("run", steps=num_steps, batch=states.trajectory.shape[0],
                            schedule="static", group_size=group_size):
            return self._static_run(states, oracle_params, num_steps, noise, group_size)

    # ------------------------------------------------- live problem updates

    def update_goal(self, state: ConstrainedState, goal) -> ConstrainedState:
        """Move the goals: clamp each trajectory's tail past its waypoint
        closest to the new goal, reparametrize, reset the schedule."""
        goal = self._tensor(goal)
        dist = torch.sum((state.trajectory[..., :2] - goal[:, None, :2]) ** 2, dim=-1)
        n = state.trajectory.shape[1]
        min_index = torch.clamp(torch.argmin(dist, dim=1) + 1, max=n)
        idx = torch.arange(n, device=self.device)
        tail = (idx[None, :] >= min_index[:, None])[..., None]
        state = state._replace(
            trajectory=torch.where(tail, goal[:, None, :], state.trajectory),
            goal=goal,
            step_count=torch.zeros_like(state.step_count),
        )
        return self._reparametrize(state)

    def update_start(self, state: ConstrainedState, start) -> ConstrainedState:
        """Move the starts (robot pose tracking in anytime mode)."""
        start = self._tensor(start)
        dist = torch.sum((state.trajectory[..., :2] - start[:, None, :2]) ** 2, dim=-1)
        n = state.trajectory.shape[1]
        min_index = torch.clamp(torch.argmin(dist, dim=1) + 1, max=n)
        idx = torch.arange(n, device=self.device)
        head = (idx[None, :] < min_index[:, None])[..., None]
        state = state._replace(
            trajectory=torch.where(head, start[:, None, :], state.trajectory),
            start=start,
            step_count=torch.zeros_like(state.step_count),
        )
        return self._reparametrize(state)

    def retarget(self, state: ConstrainedState, start, goal,
                 trajectory: torch.Tensor | None = None) -> ConstrainedState:
        """New (start, goal) queries on the same maps: rebuild trajectories,
        multipliers and trajectory-optimizer state; keep each learned field,
        its optimizer state and the replay buffer."""
        start, goal = self._tensor(start), self._tensor(goal)
        trajectory = (self.initial_trajectory(start, goal) if trajectory is None
                      else self._tensor(trajectory))
        batch, n = trajectory.shape[0], self.config.trajectory_length
        return state._replace(
            trajectory=trajectory,
            traj_opt_state=adam_init(trajectory),
            constraint_multipliers=torch.zeros((batch, n + 1), device=self.device),
            collision_multipliers=torch.zeros((batch, n), device=self.device),
            prev_trajectory=trajectory,
            start=start,
            goal=goal,
            step_count=torch.zeros((batch,), dtype=torch.int32, device=self.device),
        )


def _adam_from_jax(opt_state, batched: bool, device) -> AdamState:
    """optax.adam's state (ScaleByAdamState, EmptyState) -> AdamState."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))

    def convert(a):
        t = torch.tensor(np.asarray(a), device=device)
        return t if batched else t[None]

    mu = adam.mu
    if isinstance(mu, dict):
        return AdamState(
            convert(np.asarray(adam.count, np.int32)),
            params_from_jax(adam.mu, device), params_from_jax(adam.nu, device),
        )
    return AdamState(convert(np.asarray(adam.count, np.int32)),
                     convert(np.asarray(adam.mu, np.float32)),
                     convert(np.asarray(adam.nu, np.float32)))


def state_from_jax(np_state, device="cuda") -> ConstrainedState:
    """The JAX package's ConstrainedState (numpy leaves, batched or not) ->
    the port's batched state on `device`. The PRNG key is dropped: the
    port's noise comes from a noise source."""
    device = check_device(device, "state_from_jax")
    batched = np.ndim(np_state.trajectory) == 3

    def convert(a, dtype=np.float32):
        t = torch.tensor(np.asarray(a, dtype), device=device)
        return t if batched else t[None]

    return ConstrainedState(
        trajectory=convert(np_state.trajectory),
        field_params=params_from_jax(np_state.field_params, device),
        field_opt_state=_adam_from_jax(np_state.field_opt_state, batched, device),
        traj_opt_state=_adam_from_jax(np_state.traj_opt_state, batched, device),
        constraint_multipliers=convert(np_state.constraint_multipliers),
        collision_multipliers=convert(np_state.collision_multipliers),
        buffer_points=convert(np_state.buffer_points),
        buffer_ages=convert(np_state.buffer_ages),
        prev_trajectory=convert(np_state.prev_trajectory),
        start=convert(np_state.start),
        goal=convert(np_state.goal),
        bounds=convert(np_state.bounds),
        step_count=convert(np_state.step_count, np.int32),
    )
