"""What the SE(2) drivers share: the scene the benchmark makes from a
configuration file, the program's solver built from it, a state of the
program read as the reference's dict, and the gaps the check compares."""
from __future__ import annotations

import math

import numpy as np
import torch


def scene(config: dict, batch: int, device) -> dict:
    """The configuration's scene as tensors on `device`: obstacle points
    [B, P, 2] with mask [B, P] (the walls' points, padded far away), the
    footprint box and the world box [B, 4], and the problems' start, goal and
    bounds [B, 3|4], the same for every problem."""
    sc = config["scene"]
    walls = [np.stack([np.linspace(a[0], b[0], n), np.linspace(a[1], b[1], n)], axis=1)
             for a, b, n in sc["walls"]]
    pts = np.concatenate(walls).astype(np.float32)
    cap = sc["obstacle_capacity"]
    padded = np.full((cap, 2), 1e9, np.float32)
    padded[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True

    def rows(a, dtype=torch.float32):
        t = torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return t[None].repeat((batch,) + (1,) * t.ndim).contiguous()

    return {"points": rows(padded), "mask": rows(mask, torch.bool), "box": rows(sc["footprint"]),
            "world_box": rows(sc["world_box"]), "start": rows(sc["start"]),
            "goal": rows(sc["goal"]), "bounds": rows(sc["bounds"])}


def reference_world(world: dict) -> dict:
    return {"points": world["points"], "mask": world["mask"], "box": world["box"],
            "bounds": world["world_box"]}


def program_solver(config: dict, device, prefix: str):
    """The program's constrained solver at the configuration, as a copy that
    replays captured programs (`with_aot`)."""
    from nfopp_tpu_torch.models import ONFConfig
    from nfopp_tpu_torch.solver import ConstrainedSolver, SolverConfig
    from nfopp_tpu_torch.worlds import rectangle_collision

    s = dict(config["solver"])
    onf = s.pop("onf")
    s.pop("iterations")
    onf_config = ONFConfig(mean=onf["mean"], sigma=onf["sigma"], use_cos=onf["use_cos"],
                           use_normal_init=onf["use_normal_init"], bias=onf["bias"],
                           angle_encoding=onf["angle_encoding"],
                           angle_harmonics=onf["angle_harmonics"], hidden=onf["hidden"],
                           compute_dtype=config["precision"])
    if onf_config.fourier_features != onf["fourier_features"]:
        raise ValueError(f"the program's field has {onf_config.fourier_features} Fourier "
                         f"features, the configuration {onf['fourier_features']}")
    for key in ("collision_betas", "trajectory_betas"):
        s[key] = tuple(s[key])
    solver = ConstrainedSolver(SolverConfig(onf=onf_config, **s), rectangle_collision,
                               device=device)
    return solver.with_aot(prefix)


def program_oracle(world: dict):
    from nfopp_tpu_torch.worlds import RectangleOracle

    return RectangleOracle(world["points"], world["mask"], world["box"], world["world_box"])


def as_reference(state) -> dict:
    """A program state (`ConstrainedState`) as the reference's dict; the
    tensors are shared, not copied."""
    return {"trajectory": state.trajectory, "params": dict(state.field_params),
            "fopt": {"count": state.field_opt_state.count, "mu": state.field_opt_state.mu,
                     "nu": state.field_opt_state.nu},
            "topt": {"count": state.traj_opt_state.count, "mu": state.traj_opt_state.mu,
                     "nu": state.traj_opt_state.nu},
            "cmult": state.constraint_multipliers, "kmult": state.collision_multipliers,
            "buf": state.buffer_points, "ages": state.buffer_ages,
            "prev": state.prev_trajectory, "start": state.start, "goal": state.goal,
            "bounds": state.bounds, "count": state.step_count}


def leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]


def largest_gap(a: dict, b: dict) -> float:
    """The largest |a - b| over every leaf of two reference states (inf
    where either holds a NaN)."""
    gap = 0.0
    for x, y in zip(leaves(a), leaves(b)):
        d = (x.double() - y.double()).abs()
        gap = max(gap, float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0)
    return gap


def path_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """[B] largest gap between two batches of paths [B, M, 3]: metres in
    x and y, radians of the wrapped heading difference (inf for NaN)."""
    d = (got.double() - want.double())
    d = torch.cat([d[..., :2].abs(), (torch.remainder(d[..., 2:] + math.pi, 2 * math.pi)
                                      - math.pi).abs()], dim=-1)
    return torch.nan_to_num(d, nan=math.inf).reshape(d.shape[0], -1).amax(dim=1)


def share_over(gaps: torch.Tensor, threshold: float) -> float:
    """The share (%) of the gaps over `threshold`; inf is over."""
    return 100.0 * float((gaps.double() > threshold).double().mean())


def quantile(values: torch.Tensor, q: float) -> float:
    """The q-quantile of the values by nearest rank (inf stays inf)."""
    v = torch.sort(values.double().cpu()).values
    return float(v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))])
