"""Experimental solver variants (port of `nfopp_tpu/experimental/solver.py`).

- `run_batch`: the batch-explicit solve. The field update's two heavy passes,
  candidate scoring and training forward + backward, run through the
  multi-problem kernels (`kernels.onf_multi`, `kernels.field_grad_multi`),
  which follow `ONFConfig.compute_dtype`; the trajectory update is the
  ordinary one, whose collision terms take `onf_apply`'s casts
  (`kernels.collision_terms`).
- `jacobi_step`: the trajectory update reads the entry field, a reordering
  of the default step.
- `merged_step`: the Jacobi order's three field passes as one forward and
  one hand-written backward over the concatenated point set
  (`experimental/merged_step.py`), in plain PyTorch on [B, M, .] tensors:
  it launches none of the port's kernels. In the shared-field mode
  (`run_grouped`) each group steps on its mean field gradient.
- `use_fused_field_grad`: accepted for the JAX package's interface. On CUDA
  the port's main solver already runs its field passes through the fused
  kernels (`kernels.onf_forward`, `field_grad`, `collision_terms`), so the
  flag selects the same path as leaving it off.

Every variant captures (`with_aot`): `run`, `run_grouped` and the tracked
loops replay one chunk program per 10-step chunk in the Jacobi and merged
orders as in the default one, a `run` off the chunk replays the one-step
program of its order (`<prefix>-step-b<B>`), and `run_batch` replays its own
(`<prefix>-batch-b<B>-p<P>`). A program's key holds the step order
(`_step_order`) and, for `run_batch`, P. `run_batch` and `run_grouped` keep
the static schedule only, as JAX's batch and grouped runs have no dynamic
path.

The Jacobi and merged orders shard over a problem mesh of ranks like the
default one (`with_mesh`, `BatchPlanner(solver, mesh)`), as JAX's
`BatchPlanner` jits any solver over its mesh: every draw is this rank's
rows of the global block, and a group whose rows several ranks hold
averages through the solver's `_group_mean_grads`. `run_batch` runs on one
device only, as in JAX.
"""
from __future__ import annotations

from typing import Any

import torch

from ..kernels import field_grad_multi, onf_multi
from ..solver.constrained import (
    ConstrainedSolver,
    ConstrainedState,
    StepAux,
    _check_chunkable,
)
from ..solver.field import sample_field_points
from ..solver.schedule import scan_chunked
from ..utils import profiling
from .merged_step import merged_field_and_trajectory

__all__ = ["ExperimentalConstrainedSolver"]


class ExperimentalConstrainedSolver(ConstrainedSolver):
    """ConstrainedSolver with the experimental variants switchable.

    Flags are constructor keywords, as in the JAX package: at most one of
    `jacobi_step` / `merged_step`; `use_fused_field_grad` does not compose
    with `merged_step`.
    """

    def __init__(self, config, oracle_fn, *, jacobi_step: bool = False,
                 merged_step: bool = False, use_fused_field_grad: bool = False,
                 device="cuda"):
        super().__init__(config, oracle_fn, device=device)
        if merged_step and jacobi_step:
            raise ValueError("jacobi_step and merged_step are mutually exclusive")
        if merged_step and use_fused_field_grad:
            raise ValueError(
                "merged_step and use_fused_field_grad are mutually exclusive"
            )
        if (jacobi_step or merged_step) and config.optimize_collision_model_freq != 1:
            raise NotImplementedError(
                "jacobi_step/merged_step require optimize_collision_model_freq == 1"
            )
        self.jacobi_step = jacobi_step
        self.merged_step = merged_step
        self.use_fused_field_grad = use_fused_field_grad

    def _step_order(self) -> str:
        """The step order, "merged", "jacobi" or "default"
        (`use_fused_field_grad` runs the default order's path): a captured
        program's key holds it, so two orders of one config never share a
        program."""
        return "merged" if self.merged_step else "jacobi" if self.jacobi_step else "default"

    # ------------------------------------------------ jacobi / merged orders

    def _field_and_trajectory(self, state, oracle_params, noise, with_field=None,
                              group_size: int = 1):
        """Both orders train the field every step (the constructor requires
        optimize_collision_model_freq == 1); group_size > 1 steps each group's
        field on its mean gradient (JAX's `_step_grouped`)."""
        if self.merged_step:
            return merged_field_and_trajectory(self, state, oracle_params, noise, group_size)
        if not self.jacobi_step:
            return super()._field_and_trajectory(state, oracle_params, noise, with_field,
                                                 group_size)
        prev_traj = state.trajectory
        sample, field_loss, grads = self._field_grads(state, oracle_params, noise, group_size)
        state, traj_loss = self._trajectory_step(state, noise)
        state = self._apply_field_update(state, sample, grads)
        return state._replace(prev_trajectory=prev_traj), field_loss, traj_loss

    # ------------------------------------------------- batch-explicit solve

    def _field_step_batch(
        self, states: ConstrainedState, oracle_params: Any, noise, problems_per_program: int
    ) -> tuple[ConstrainedState, torch.Tensor]:
        """Field update of the whole batch through the multi-problem kernels:
        the noise, sampling and update of `_field_step`, with candidate scoring
        [buffer | fine] (M = K + N-1) by `onf_multi` and the loss and
        gradients on the training points (M = (N-1) + K + R) by
        `field_grad_multi`."""
        cfg = self.config
        sample = sample_field_points(
            cfg, noise, states.prev_trajectory, states.buffer_points, states.buffer_ages,
            states.field_params, states.bounds,
            score_fn=lambda params, x: onf_multi(params, x, cfg.onf, problems_per_program)[..., 0],
        )
        truth = self.oracle_fn(oracle_params, sample.train_points)
        loss, grads = field_grad_multi(
            states.field_params, sample.train_points, truth, cfg.onf, problems_per_program
        )
        return self._apply_field_update(states, sample, grads), loss

    def _step_batch(
        self, states: ConstrainedState, oracle_params: Any, noise, with_reparam: bool,
        problems_per_program: int, with_field: bool = True,
    ) -> tuple[ConstrainedState, StepAux]:
        self._check_static_field_stride("batch-explicit path")
        if with_field:
            states, field_loss = self._field_step_batch(
                states, oracle_params, noise, problems_per_program
            )
        else:
            field_loss = torch.zeros((states.trajectory.shape[0],), device=self.device)
        states, traj_loss = self._trajectory_step(states, noise)
        if with_reparam:
            states = self._reparametrize(states)
        states = states._replace(step_count=states.step_count + 1)
        return states, StepAux(field_loss, traj_loss)

    def _batch_chunks(self, states, oracle_params: Any, num_steps: int, noise,
                      problems_per_program: int) -> tuple[ConstrainedState, StepAux]:
        """`num_steps` steps of `scan_chunked`'s schedule over `_step_batch`;
        aux stacked [B, num_steps]."""
        noise = self._noise(noise, states.start.shape[0])
        states, aux = scan_chunked(
            lambda s, r, f: self._step_batch(s, oracle_params, noise, r, problems_per_program,
                                             with_field=f),
            states, num_steps, self.config.reparametrize_trajectory_freq,
            field_stride=self._static_field_stride(),
        )
        return states, StepAux(*(torch.stack(xs, dim=1) for xs in zip(*aux)))

    def run_batch(
        self, states: ConstrainedState, oracle_params: Any, num_steps: int, noise,
        problems_per_program: int = 8,
    ) -> tuple[ConstrainedState, StepAux]:
        """Batch-explicit `run`: the multi-problem kernels for the field
        passes. The static chunk schedule of `run` (reparametrization at step
        counts 0, freq, 2freq, ...; field stride where
        optimize_collision_model_freq divides freq); requires num_steps %
        reparametrize_trajectory_freq == 0 and B % problems_per_program == 0,
        and, like the JAX version, every problem at a chunk's start on entry
        (step_count % freq == 0, as after init_state / update_*), which is not
        checked. Noise as in `run`; aux is stacked [B, num_steps]. On a copy
        made by `with_aot` the chunks are replays of one captured program,
        `<prefix>-batch-b<B>-p<P>`, with kernels 4, 5, 3a and 3b inside it."""
        freq = self.config.reparametrize_trajectory_freq
        _check_chunkable("run_batch", num_steps, freq)
        if self.layout.mesh.size > 1:
            raise NotImplementedError(
                "run_batch runs on one device: JAX runs it only on one (bench.py:275) and its "
                "BatchPlanner has no route to it; on a mesh of ranks use run or run_grouped"
            )
        with profiling.span("run", steps=num_steps, batch=states.start.shape[0],
                            schedule="static", problems_per_program=problems_per_program):
            if self.aot_prefix is None:
                return self._batch_chunks(states, oracle_params, num_steps, noise,
                                          problems_per_program)
            return self._run_program(
                f"batch-b{states.start.shape[0]}-p{problems_per_program}",
                lambda s, o, n, g: self._batch_chunks(s, o, n, g, problems_per_program),
                freq, states, oracle_params, num_steps, noise, key_parts=(problems_per_program,),
            )
