"""GPMP2-style baseline planner: batched damped Gauss-Newton on the card
(port of `nfopp_tpu/baselines/gpmp2.py`).

The reference compares NFOPP against GPMP2 via gtsam/gpmp2 Python bindings
(scripts/run_gpmp2.py: planar point robot, constant-velocity GP prior with
Qc = I, planar SDF obstacle factors with cost_sigma = 0.1 and epsilon = 1,
A*-initialized 100-step trajectory, Dogleg optimization). This module
states the same factor-graph least-squares problem directly:

  state      X[i] = (x, y, vx, vy), i = 0..N-1; endpoints softly pinned
  GP prior   r_i = S^{-1/2} (Phi X_i - X_{i+1}),  Phi = const-velocity
             transition over dt, S = the standard white-noise-on-acceleration
             covariance [[dt^3/3, dt^2/2], [dt^2/2, dt]] (x) Qc
  obstacle   r_i = hinge(eps - sdf(p_i)) / cost_sigma   (+ interpolated points)

and minimizes 1/2 ||r(X)||^2 with damped Gauss-Newton: a dense forward-mode
Jacobian, the normal equations with `damping * diag(J^T J) + 1e-8 I`, an LU
solve, a step taken only where it lowers the cost, a fixed number of
iterations. JAX's version solves one problem and is vmapped; here every
function is batch-explicit (SDF leaves, starts, goals and inits with a
leading problem axis [B]), and the Jacobian is taken per problem
(`torch.func.vmap(torch.func.jacfwd(...))`, [B, M, 4N]), never of the
batched function. The 30 iterations run without a host sync: a step is
accepted with `torch.where`, and the solve is `linalg.solve_ex`.

The SDF comes from a host-side euclidean distance transform of the occupancy
grid (scipy.ndimage), sampled on the device with bilinear interpolation —
matching gpmp2's signedDistanceField2D + PlanarSDF pairing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.math import linspace
from ..utils.device import check_device

__all__ = ["SDF", "build_sdf", "stack_sdfs", "sdf_lookup", "GPMP2Config", "gpmp2_plan",
           "gpmp2_cost"]


class SDF(NamedTuple):
    values: torch.Tensor  # [B, H, W] signed distance (positive = free)
    origin: torch.Tensor  # [B, 2] world (x, y) of the grid corner
    resolution: torch.Tensor  # [B]


def build_sdf(blocked: np.ndarray, resolution: float, origin=(0.0, 0.0),
              device="cuda") -> SDF:
    """Signed distance field of one occupancy grid (gpmp2
    signedDistanceField2D semantics: outside-distance − inside-distance),
    computed on the host and moved to `device`, leaves with a leading axis
    of 1."""
    import scipy.ndimage as ndi

    device = check_device(device, "build_sdf")
    blocked = np.asarray(blocked, bool)
    outside = ndi.distance_transform_edt(~blocked) * resolution
    inside = ndi.distance_transform_edt(blocked) * resolution
    signed = (outside - inside).astype(np.float32)
    return SDF(
        values=torch.tensor(signed, device=device)[None],
        origin=torch.tensor(np.asarray(origin, np.float32), device=device)[None],
        resolution=torch.tensor([resolution], dtype=torch.float32, device=device),
    )


def stack_sdfs(sdfs: list[SDF]) -> SDF:
    """One batched SDF from SDFs of the same grid shape."""
    return SDF(*(torch.cat(leaves) for leaves in zip(*sdfs)))


def sdf_lookup(sdf: SDF, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear SDF sample at [B, M, 2] world points -> [B, M].

    The clip to the grid is `minimum(maximum(...))`, as `jnp.clip` is: at a
    bound (a point on a row-0 or column-0 cell centre) both take half the
    derivative, where `torch.clamp` would pass all of it."""
    b, h, w = sdf.values.shape
    res = sdf.resolution[:, None]
    u = (xy[..., 0] - sdf.origin[:, None, 0]) / res - 0.5  # col coordinate
    v = (xy[..., 1] - sdf.origin[:, None, 1]) / res - 0.5  # row coordinate
    zero = torch.zeros_like(u)
    u = torch.minimum(torch.maximum(u, zero), torch.full_like(u, w - 1.001))
    v = torch.minimum(torch.maximum(v, zero), torch.full_like(v, h - 1.001))
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    cell = v0.to(torch.int64) * w + u0.to(torch.int64)
    flat = sdf.values.reshape(b, h * w)

    def at(offset: int) -> torch.Tensor:
        return torch.gather(flat, 1, cell + offset)

    top = at(0) * (1 - du) + at(1) * du
    bottom = at(w) * (1 - du) + at(w + 1) * du
    return top * (1 - dv) + bottom * dv


class GPMP2Config(NamedTuple):
    num_steps: int = 100  # trajectory states N
    total_time: float = 10.0  # seconds (ref run_gpmp2.py:93)
    qc: float = 1.0  # GP power-spectral density (Qc = qc * I)
    cost_sigma: float = 0.1  # obstacle factor sigma (ref :108)
    epsilon: float = 1.0  # obstacle clearance threshold (ref :109)
    fix_sigma: float = 1e-4  # endpoint prior sigma (ref :112-113)
    interpolation: int = 3  # GP-interpolated obstacle checks per segment
    iterations: int = 30  # damped Gauss-Newton iterations
    damping: float = 1e-3


def _gp_whitener(dt: float, qc: float) -> np.ndarray:
    """Inverse square root of the const-velocity transition covariance (per
    axis): S = qc * [[dt^3/3, dt^2/2], [dt^2/2, dt]]."""
    s = qc * np.array([[dt**3 / 3.0, dt**2 / 2.0], [dt**2 / 2.0, dt]])
    return np.linalg.cholesky(np.linalg.inv(s)).T.astype(np.float32)


def _residuals(flat_x, start, goal, sdf: SDF, config: GPMP2Config, whitener):
    """[B, 4N] states -> [B, M] residuals, M = 4(N-1) + N + (N-1) *
    interpolation + 8 (801 at N=100): GP prior, obstacle hinge, endpoints."""
    n = config.num_steps
    dt = config.total_time / (n - 1)
    batch = flat_x.shape[0]
    states = flat_x.reshape(batch, n, 4)

    # GP prior residuals, whitened per axis: [B, N-1, 2, 2] -> flat
    pos, vel = states[..., :2], states[..., 2:]
    pred_pos = pos[:, :-1] + vel[:, :-1] * dt
    pred_vel = vel[:, :-1]
    # [B, N-1, 2(pos/vel), 2(xy)]
    err = torch.stack([pred_pos - pos[:, 1:], pred_vel - vel[:, 1:]], dim=2)
    gp_res = torch.einsum("ab,knbd->knad", whitener, err).reshape(batch, -1)

    # obstacle residuals at states + GP-interpolated points
    one = torch.ones((1,), device=flat_x.device)
    taus = linspace(torch.zeros_like(one), one, config.interpolation + 2)[0, 1:-1]
    interp = pos[:, :-1, None, :] + (
        vel[:, :-1, None, :] * dt * taus[None, None, :, None]
    )  # const-velocity interpolation
    query = torch.cat([pos, interp.reshape(batch, -1, 2)], dim=1)
    dist = sdf_lookup(sdf, query)
    hinge = torch.maximum(config.epsilon - dist, torch.zeros_like(dist))
    obstacle_res = hinge / config.cost_sigma

    # endpoint priors (conf + vel), ref pose_fix/vel_fix sigma 1e-4
    fix = torch.cat([states[:, 0] - start, states[:, -1] - goal], dim=1) / config.fix_sigma

    return torch.cat([gp_res, obstacle_res, fix], dim=1)


def gpmp2_cost(flat_x, start, goal, sdf: SDF, config: GPMP2Config, whitener) -> torch.Tensor:
    """[B] costs 1/2 ||r||^2."""
    r = _residuals(flat_x, start, goal, sdf, config, whitener)
    return 0.5 * torch.sum(r * r, dim=1)


def _jacobian(flat_x, start, goal, sdf: SDF, config: GPMP2Config, whitener) -> torch.Tensor:
    """[B, M, 4N]: each problem's forward-mode Jacobian (JAX's per-problem
    `jacfwd` under `vmap`)."""

    def one(x, s, g, values, origin, resolution):
        single = SDF(values[None], origin[None], resolution[None])
        return _residuals(x[None], s[None], g[None], single, config, whitener)[0]

    return torch.func.vmap(torch.func.jacfwd(one))(flat_x, start, goal, *sdf)


class _Problem(NamedTuple):
    """The fixed inputs of a batch of GPMP2 problems."""

    start: torch.Tensor  # [B, 4] start state (position, zero velocity)
    goal: torch.Tensor  # [B, 4]
    sdf: SDF
    whitener: torch.Tensor  # [2, 2]


def _setup(sdf: SDF, start_xy, goal_xy, config: GPMP2Config, init_xy=None):
    """(initial flat states [B, 4N], problem): positions from `init_xy` or
    the straight line, velocities their central differences / dt."""
    device = sdf.values.device
    start_xy = torch.as_tensor(start_xy, dtype=torch.float32, device=device)
    goal_xy = torch.as_tensor(goal_xy, dtype=torch.float32, device=device)
    n = config.num_steps
    dt = config.total_time / (n - 1)
    if init_xy is None:
        t = linspace(torch.zeros((1,), device=device), torch.ones((1,), device=device), n)
        t = t[0, None, :, None]
        init_xy = start_xy[:, None] * (1 - t) + goal_xy[:, None] * t
    init_xy = torch.as_tensor(init_xy, dtype=torch.float32, device=device)
    vel = torch.gradient(init_xy, dim=1, edge_order=1)[0] / dt
    flat = torch.cat([init_xy, vel], dim=2).reshape(init_xy.shape[0], -1)

    start = torch.cat([start_xy, (init_xy[:, 1] - init_xy[:, 0]) / dt * 0.0], dim=1)
    goal = torch.cat([goal_xy, torch.zeros_like(goal_xy)], dim=1)
    whitener = torch.tensor(_gp_whitener(dt, config.qc), device=device)
    return flat, _Problem(start, goal, sdf, whitener)


def _normal_equations(flat, problem: _Problem, config: GPMP2Config):
    """(r [B, M], J^T J [B, 4N, 4N], J^T r [B, 4N]) at `flat`."""
    args = (problem.start, problem.goal, problem.sdf, config, problem.whitener)
    r = _residuals(flat, *args)
    jac = _jacobian(flat, *args)  # [B, M, 4N]
    jac_t = jac.transpose(1, 2)
    return r, jac_t @ jac, (jac_t @ r[..., None])[..., 0]


def _step(jtj: torch.Tensor, jtr: torch.Tensor, config: GPMP2Config) -> torch.Tensor:
    """[B, 4N] Gauss-Newton step of the damped normal equations (LU)."""
    damped = jtj + config.damping * torch.diag_embed(torch.diagonal(jtj, dim1=1, dim2=2))
    eye = torch.eye(jtj.shape[-1], device=jtj.device)
    return torch.linalg.solve_ex(damped + 1e-8 * eye, jtr)[0]


def _gn_step(flat, problem: _Problem, config: GPMP2Config) -> torch.Tensor:
    """One damped Gauss-Newton iteration; a problem keeps its step only if
    its cost decreases (poor-man's dogleg trust region)."""
    r, jtj, jtr = _normal_equations(flat, problem, config)
    new_flat = flat - _step(jtj, jtr, config)
    new_r = _residuals(new_flat, problem.start, problem.goal, problem.sdf, config,
                       problem.whitener)
    better = torch.sum(new_r ** 2, dim=1) < torch.sum(r * r, dim=1)
    return torch.where(better[:, None], new_flat, flat)


def gpmp2_plan(
    sdf: SDF,
    start_xy,
    goal_xy,
    config: GPMP2Config = GPMP2Config(),
    init_xy=None,
) -> torch.Tensor:
    """Solve a batch of GPMP2 problems on the SDF's device -> [B, N, 4] states.

    start_xy, goal_xy [B, 2]; init_xy [B, N, 2] optionally seeds the
    positions (e.g. a wavefront path), default the straight line.
    Velocities init to the central differences of the positions over dt.
    """
    flat, problem = _setup(sdf, start_xy, goal_xy, config, init_xy)
    for _ in range(config.iterations):
        flat = _gn_step(flat, problem, config)
    return flat.reshape(flat.shape[0], config.num_steps, 4)
