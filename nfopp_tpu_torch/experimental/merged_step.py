"""Merged field+trajectory sub-step (port of
`nfopp_tpu/experimental/merged_step.py`), on a batch of problems.

The Jacobi order (`ExperimentalConstrainedSolver(jacobi_step=True)`) lets the
trajectory update read the ENTRY field parameters, so all three field passes
of one solver step read the same parameters:

  1. candidate scoring for the replay-buffer resample        forward, K+N-1 points
  2. BCE field training                                       fwd + bwd(params), N-1+K+R
  3. the trajectory's collision terms                         fwd + bwd(positions), (N-1)S

The merged step runs them as ONE forward over the concatenated point set and
ONE hand-written backward chain. The MLP is pointwise, so one cotangent chain
gives both the parameter gradients (summed over the training rows) and the
position gradients (of the collision rows). Instead of gathering the
resampled buffer's activations, every candidate row's BCE cotangent is
multiplied by a 0/1 "selected" mask (the BCE is a per-row sum).

Every product is a `torch.matmul` on [B, M, .] tensors; the JAX function
reaches no Pallas kernel, and this port launches none of the port's kernels.
Under compute_dtype='bfloat16' both operands of every product are rounded to
bf16 and multiplied in f32 (`_mm`), as `models/onf.py::onf_apply` does: a
product of two bf16 values is exact in f32, so this is JAX's bf16 x bf16
product with f32 accumulation (`preferred_element_type`).

Noise is drawn as the Jacobi order draws it: `field_sample_pre` (a uniform
block, then a normal block), then the trajectory's t [B, N-1, S], each from
the noise source the solver's step gives it (on a mesh, this rank's rows of
the block drawn for the global batch).

The replay buffer is resampled with the weights sigmoid(z) * exp(-decay *
age), WITHOUT the `buffer_weight_floor` term of the default and Jacobi
orders (`solver/field.py::field_sample_post`), exactly as JAX's merged step
(`merged_step.py:274`) does. Once the field saturates (every candidate's
weight below the floor), Jacobi resamples near-uniformly while merged keeps
the buffer peaked: the two orders then differ, here as in the JAX package
(ROADMAP.md section 3; `tests/test_torch_merged_step.py` pins it).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.onf import ONFConfig
from ..ops.losses import (
    boundary_loss,
    direction_constraint_deltas,
    distance_loss_se2,
    non_holonomic_constraint_deltas,
    softplus_beta,
)
from ..ops.sampling import gumbel_topk_log_indices
from ..solver.field import buffer_log_weights, field_sample_pre

__all__ = [
    "ONFActs",
    "onf_forward_acts",
    "onf_backward",
    "merged_partial_step",
    "merged_field_and_trajectory",
]


class ONFActs(NamedTuple):
    """Saved activations of one ONF forward pass (inputs to every product)."""

    xy: torch.Tensor  # [B, M, 2] normalized positions
    enc: torch.Tensor  # [B, M, F] Fourier features
    trig_e: torch.Tensor  # [B, M, F] d enc / d pre_e
    ang: torch.Tensor | None  # [B, M, 2H] angle features
    trig_a: torch.Tensor | None  # [B, M, 2H] d ang / d a
    h1: torch.Tensor  # [B, M, hid]
    h2: torch.Tensor  # [B, M, hid]
    logits: torch.Tensor  # [B, M, 1]


def _low(config: ONFConfig) -> bool:
    if config.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}")
    return config.compute_dtype == "bfloat16"


def _round(x: torch.Tensor, low: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if low else x


def _mm(a: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """[B, M, K] @ [B, K, N] with both operands in the compute dtype and an
    f32 result."""
    return torch.matmul(_round(a, low), _round(w, low))


def _mmT(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    """a^T @ b contracting over rows: [B, M, K]^T @ [B, M, N] -> [B, K, N]."""
    return torch.matmul(_round(a, low).transpose(1, 2), _round(b, low))


def _angle_freqs(config: ONFConfig, device) -> torch.Tensor:
    f = torch.arange(1, config.angle_harmonics + 1, dtype=torch.float32, device=device)
    return torch.cat([f, f])


def onf_forward_acts(params: dict, x: torch.Tensor, config: ONFConfig) -> ONFActs:
    """The ONF forward (`models/onf.py::onf_apply`) on points [B, M, 3],
    also returning the activations the backward pass needs."""
    low = _low(config)
    fourier = config.fourier_features
    hid = config.hidden

    xy = (x[..., :2] - config.mean) / config.sigma
    pre_e = _mm(xy, params["encoding"]["w"], low)
    if config.bias:  # bias=False: no trainable bias (models/onf.py::onf_apply)
        pre_e = pre_e + params["encoding"]["b"][:, None, :]
    if config.use_cos:
        h = fourier // 2
        enc = torch.cat([torch.sin(pre_e[..., :h]), torch.cos(pre_e[..., h:])], dim=-1)
        trig_e = torch.cat([torch.cos(pre_e[..., :h]), -torch.sin(pre_e[..., h:])], dim=-1)
    else:
        enc = torch.sin(pre_e)
        trig_e = torch.cos(pre_e)

    w1 = params["mlp1"]["w"]
    w3 = params["out"]["w"]
    if config.angle_encoding:
        hh = config.angle_harmonics
        # the phases stay in f32: only products take the compute dtype
        a = (x[..., 2:3] + params["angle_biases"][:, None, :]) * _angle_freqs(config, x.device)
        ang = torch.cat([torch.sin(a[..., :hh]), torch.cos(a[..., hh:])], dim=-1)
        trig_a = torch.cat([torch.cos(a[..., :hh]), -torch.sin(a[..., hh:])], dim=-1)
        pre1 = _mm(enc, w1[:, :fourier], low) + _mm(ang, w1[:, fourier:], low)
    else:
        ang = trig_a = None
        pre1 = _mm(enc, w1, low)
    h1 = torch.relu(pre1 + params["mlp1"]["b"][:, None, :])
    h2 = torch.relu(_mm(h1, params["mlp2"]["w"], low) + params["mlp2"]["b"][:, None, :])
    logits = (_mm(h2, w3[:, :hid], low) + _mm(enc, w3[:, hid : hid + fourier], low)
              + params["out"]["b"][:, None, :])
    if ang is not None:
        logits = logits + _mm(ang, w3[:, hid + fourier :], low)
    return ONFActs(xy, enc, trig_e, ang, trig_a, h1, h2, logits)


def onf_backward(
    params: dict,
    acts: ONFActs,
    g: torch.Tensor,
    param_rows: int,
    config: ONFConfig,
) -> tuple[dict, torch.Tensor]:
    """One backward chain with a row-split cotangent.

    `g` [B, M, 1] is the logit cotangent of ALL rows. Parameter gradients sum
    over rows [:param_rows] only (the field-training slice); position
    gradients are returned for rows [param_rows:] only (the trajectory's
    collision slice). Rows are independent through the MLP, so the shared
    hidden-cotangent chain is exact for both.

    Returns `(field_grads, pos_grads [B, M - param_rows, 3])`; field_grads
    has the parameters' layout. With angle encoding off, the theta column of
    pos_grads is zero (the field never reads theta).
    """
    low = _low(config)
    fourier = config.fourier_features
    hid = config.hidden
    p = param_rows
    w1 = params["mlp1"]["w"]
    w2 = params["mlp2"]["w"]
    w3 = params["out"]["w"]

    def t(w):
        return w.transpose(1, 2)

    gh2 = _mm(g, t(w3[:, :hid]), low)
    gpre2 = gh2 * (acts.h2 > 0)
    gh1 = _mm(gpre2, t(w2), low)
    gpre1 = gh1 * (acts.h1 > 0)
    genc = _mm(gpre1, t(w1[:, :fourier]), low) + _mm(g, t(w3[:, hid : hid + fourier]), low)
    gpre_e = genc * acts.trig_e

    grads = {
        "encoding": {
            "w": _mmT(acts.xy[:, :p], gpre_e[:, :p], low),
            # the autodiff of the gated forward: an unused bias has zero grad
            "b": (torch.sum(gpre_e[:, :p], dim=1) if config.bias
                  else torch.zeros_like(params["encoding"]["b"])),
        },
    }
    if config.angle_encoding:
        gang = (_mm(gpre1, t(w1[:, fourier:]), low)
                + _mm(g, t(w3[:, hid + fourier :]), low))
        ga_freq = (gang * acts.trig_a) * _angle_freqs(config, g.device)
        grads["mlp1"] = {
            "w": torch.cat([_mmT(acts.enc[:, :p], gpre1[:, :p], low),
                            _mmT(acts.ang[:, :p], gpre1[:, :p], low)], dim=1),
            "b": torch.sum(gpre1[:, :p], dim=1),
        }
        out_w = [acts.h2, acts.enc, acts.ang]
        gtheta = torch.sum(ga_freq[:, p:], dim=2)
    else:
        grads["mlp1"] = {
            "w": _mmT(acts.enc[:, :p], gpre1[:, :p], low),
            "b": torch.sum(gpre1[:, :p], dim=1),
        }
        out_w = [acts.h2, acts.enc]
        gtheta = torch.zeros(g.shape[:2], device=g.device)[:, p:]
    grads["mlp2"] = {
        "w": _mmT(acts.h1[:, :p], gpre2[:, :p], low),
        "b": torch.sum(gpre2[:, :p], dim=1),
    }
    grads["out"] = {
        "w": torch.cat([_mmT(a[:, :p], g[:, :p], low) for a in out_w], dim=1),
        "b": torch.sum(g[:, :p], dim=1),
    }
    if config.angle_encoding:
        grads["angle_biases"] = torch.sum(ga_freq[:, :p], dim=1)

    gxy = _mm(gpre_e[:, p:], t(params["encoding"]["w"]), low) / config.sigma
    pos_grads = torch.cat([gxy, gtheta[..., None]], dim=-1)
    return grads, pos_grads


def merged_partial_step(solver, state, oracle_params: Any, noise):
    """The merged step minus the field's Adam update.

    Returns `(state, field_grads, field_loss [B], trajectory_loss [B])`:
    `state` carries the trajectory, multiplier and buffer updates and the
    ENTRY field parameters. The caller applies the field optimizer, directly
    (`merged_field_and_trajectory`) or after averaging each group's
    gradients (the shared-field mode).
    """
    cfg = solver.config
    n = cfg.trajectory_length
    s = cfg.collision_samples_per_segment
    traj = state.trajectory
    batch = traj.shape[0]
    device = traj.device

    # all random draws, in the Jacobi order's sequence
    pre = field_sample_pre(cfg, noise, state.prev_trajectory, state.bounds)
    t = noise.uniform((batch, n - 1, s), device)

    # point assembly: [coarse | candidates | random | collision samples]
    candidates = torch.cat([state.buffer_points, pre.fine], dim=1)
    cand_ages = torch.cat([state.buffer_ages, torch.zeros_like(pre.fine[..., 0])], dim=1)
    colpos, m_interp = solver.collision_inputs(traj, state.collision_multipliers, t)

    n_coarse = n - 1
    n_cand = candidates.shape[1]
    n_rand = pre.random_points.shape[1]
    p = n_coarse + n_cand + n_rand  # rows of the parameter gradients (training superset)

    pts = torch.cat([pre.coarse, candidates, pre.random_points, colpos], dim=1)
    acts = onf_forward_acts(state.field_params, pts, cfg.onf)
    logits = acts.logits[..., 0]

    # replay-buffer resample from the candidate rows, with no weight floor
    # (JAX's merged step, merged_step.py:274)
    cand_logits = logits[:, n_coarse : n_coarse + n_cand]
    log_w = buffer_log_weights(cfg, cand_logits, cand_ages, floor=False)
    idx = gumbel_topk_log_indices(log_w, pre.gumbel, cfg.collision_point_count)
    new_buffer = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, candidates.shape[-1]))
    new_ages = torch.gather(cand_ages, 1, idx) + 1.0

    # BCE cotangent over the training superset, masked to the training set
    # [coarse, resampled buffer, random]
    truth = solver.oracle_fn(oracle_params, pts[:, :p]).to(torch.float32)
    selected = torch.zeros((batch, n_cand), device=device).scatter(1, idx, 1.0)
    ones = torch.ones((batch, 1), device=device)
    mask = torch.cat([ones.expand(-1, n_coarse), selected, ones.expand(-1, n_rand)], dim=1)
    n_train = cfg.field_batch_size
    lt = logits[:, :p]
    g_bce = mask * (torch.sigmoid(lt) - truth) / n_train
    per_row = torch.clamp(lt, min=0.0) - lt * truth + torch.log1p(torch.exp(-torch.abs(lt)))
    field_loss = torch.sum(per_row * mask, dim=1) / n_train

    # collision cotangent (softplus_beta' = sigmoid(beta x); tanh' = 1 - tanh^2)
    lc = logits[:, p:]
    tanh_lc = torch.tanh(lc)
    g_col = (cfg.collision_weight * torch.sigmoid(cfg.collision_beta * lc)
             + m_interp * (1.0 - tanh_lc ** 2)) / s

    g = torch.cat([g_bce, g_col], dim=1)[..., None]
    field_grads, pos_g = onf_backward(state.field_params, acts, g, p, cfg.onf)

    # the field-free trajectory terms by autograd
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)
                  for x in (traj, state.constraint_multipliers)]
        trajectory, cons_mult = leaves
        full = torch.cat([state.start[:, None], trajectory, state.goal[:, None]], dim=1)
        cd = non_holonomic_constraint_deltas(full)
        dd = torch.clamp(direction_constraint_deltas(full), min=0.0)
        rest = (
            distance_loss_se2(full, cfg.angle_weight)
            + torch.sum(cons_mult * cd, dim=1)
            + torch.sum(cd ** 2, dim=1) * cfg.constraint_deltas_weight
            + boundary_loss(trajectory, state.bounds) * cfg.boundary_weight
            + cfg.direction_delta_weight * torch.sum(dd ** 2, dim=1)
        )
        g_traj, g_cons = torch.autograd.grad(rest.sum(), leaves)

    # the collision positions' and multipliers' cotangents back through the
    # segment lerp colpos = (1-t) traj[1:] + t traj[:-1] (the wrap has unit grad)
    pos_g = pos_g.reshape(batch, n - 1, s, 3)
    g_traj = g_traj.clone()
    g_traj[:, 1:] += torch.sum((1.0 - t)[..., None] * pos_g, dim=2)
    g_traj[:, :-1] += torch.sum(t[..., None] * pos_g, dim=2)
    gm = (tanh_lc / s).reshape(batch, n - 1, s)
    g_coll = torch.zeros((batch, n), device=device)
    g_coll[:, 1:] += torch.sum((1.0 - t) * gm, dim=2)
    g_coll[:, :-1] += torch.sum(t * gm, dim=2)
    traj_loss = rest.detach() + (
        cfg.collision_weight * torch.sum(softplus_beta(lc, cfg.collision_beta), dim=1)
        + torch.sum(m_interp * tanh_lc, dim=1)
    ) / s

    # primal step (H^-1-preconditioned Adam) + dual ascent, in the reference's order
    traj_grad = torch.matmul(solver._inv_hessian, g_traj)
    new_traj, traj_opt_state = solver._traj_adam(traj_grad, state.traj_opt_state, traj)
    cons = state.constraint_multipliers + cfg.multipliers_lr * g_cons
    coll = torch.clamp(state.collision_multipliers + cfg.collision_multipliers_lr * g_coll,
                       min=0.0)

    state = state._replace(
        trajectory=new_traj,
        traj_opt_state=traj_opt_state,
        constraint_multipliers=cons,
        collision_multipliers=coll,
        buffer_points=new_buffer,
        buffer_ages=new_ages,
        prev_trajectory=traj,
    )
    return state, field_grads, field_loss, traj_loss


def merged_field_and_trajectory(solver, state, oracle_params: Any, noise,
                                group_size: int = 1):
    """Field update + trajectory update + dual ascent through one ONF pass
    (see the module docstring): the Jacobi order's draws, update order and
    returned `(state, field_loss, trajectory_loss)`. With group_size > 1 each
    group of that many consecutive problems steps its field on the group's
    mean gradient (the shared-field mode, JAX's grouped merged branch,
    `nfopp_tpu/experimental/solver.py:135-151`), through the solver's
    `_group_mean_grads`, so that on a mesh a group whose rows several ranks
    hold averages over all of them."""
    state, field_grads, field_loss, traj_loss = merged_partial_step(
        solver, state, oracle_params, noise
    )
    if group_size > 1:
        field_grads = solver._group_mean_grads(field_grads, state.start.shape[0], group_size)
    params, opt_state = solver._field_adam(field_grads, state.field_opt_state,
                                           state.field_params)
    return state._replace(field_params=params, field_opt_state=opt_state), field_loss, traj_loss
