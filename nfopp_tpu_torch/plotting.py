"""Matplotlib visualization (the reference's plotting_utils.py capability):
field heatmap on a grid, trajectory, obstacle scatter, heading quivers.
A copy of `nfopp_tpu/plotting.py`: matplotlib is imported only when a
function draws, and the field heatmap takes any [M, 3] numpy -> [M] logits
function (over the port's `onf_apply` in scripts/run_planner_torch.py)."""
from __future__ import annotations

import numpy as np

__all__ = [
    "prepare_figure",
    "plot_field_heatmap",
    "plot_trajectory",
    "plot_obstacles",
    "plot_collision_positions",
    "plot_planner_data",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def prepare_figure(bounds, ax=None):
    plt = _plt()
    if ax is None:
        ax = plt.gca()
    ax.set_xlim(bounds[0], bounds[1])
    ax.set_ylim(bounds[2], bounds[3])
    ax.set_aspect("equal")
    return ax


def plot_field_heatmap(field_logits_fn, bounds, resolution=100, theta=0.0, ax=None):
    """Evaluate the occupancy field on a grid and draw sigmoid(logits)
    (ref plot_model_heatmap, plotting_utils.py:20-30)."""
    plt = _plt()
    if ax is None:
        ax = plt.gca()
    xs = np.linspace(bounds[0], bounds[1], resolution)
    ys = np.linspace(bounds[2], bounds[3], resolution)
    gx, gy = np.meshgrid(xs, ys)
    queries = np.stack(
        [gx.reshape(-1), gy.reshape(-1), np.full(gx.size, theta)], axis=1
    ).astype(np.float32)
    logits = np.asarray(field_logits_fn(queries)).reshape(resolution, resolution)
    probabilities = 1.0 / (1.0 + np.exp(-logits))
    im = ax.imshow(
        probabilities, origin="lower", extent=(bounds[0], bounds[1], bounds[2], bounds[3]),
        cmap="magma", alpha=0.8, vmin=0, vmax=1,
    )
    return im


def plot_trajectory(path, ax=None, quiver_angles=True, color="cyan"):
    plt = _plt()
    if ax is None:
        ax = plt.gca()
    path = np.asarray(path)
    ax.plot(path[:, 0], path[:, 1], "-o", color=color, markersize=2, linewidth=1)
    if quiver_angles and path.shape[1] >= 3:
        ax.quiver(
            path[::5, 0], path[::5, 1],
            np.cos(path[::5, 2]), np.sin(path[::5, 2]),
            color="white", scale=30, width=0.003,
        )
    return ax


def plot_obstacles(points, ax=None):
    plt = _plt()
    if ax is None:
        ax = plt.gca()
    points = np.asarray(points)
    if len(points):
        ax.scatter(points[:, 0], points[:, 1], c="red", s=8, marker="s")
    return ax


def plot_collision_positions(positions, truth, ax=None):
    """Sampled field-training points colored by oracle truth
    (ref plot_collision_positions, plotting_utils.py:40-48)."""
    plt = _plt()
    if ax is None:
        ax = plt.gca()
    positions = np.asarray(positions)
    truth = np.asarray(truth, bool)
    if len(positions):
        ax.scatter(positions[~truth, 0], positions[~truth, 1], c="lime", s=3)
        ax.scatter(positions[truth, 0], positions[truth, 1], c="orange", s=3)
    return ax


def plot_planner_data(path, field_logits_fn, bounds, obstacle_points, ax=None):
    """Composite debug view (ref plot_planner_data, plotting_utils.py:6-17)."""
    ax = prepare_figure(bounds, ax)
    if field_logits_fn is not None:
        plot_field_heatmap(field_logits_fn, bounds, ax=ax)
    plot_obstacles(obstacle_points, ax=ax)
    plot_trajectory(path, ax=ax)
    return ax
