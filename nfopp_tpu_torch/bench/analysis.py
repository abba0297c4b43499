"""Experiment analysis: merge result logs, aggregate stats, render plots.

The library-side replacement for the reference's notebook tooling
(`notebooks/benchmark/*_experiment.ipynb` cells 5-7): bench-mr's
`MultipleMPB.merge` + `plot_planner_stats` + `visualize_trajectories`,
operating on the ResultsLog JSON schema this framework shares with the
reference (see results.py). Pure functions over loaded documents; the thin
CLI lives in scripts/analyze_results_torch.py. A copy of
`nfopp_tpu/bench/analysis.py` (numpy over the results schema, matplotlib
imported only by the plots).
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Iterable

import numpy as np

from .results import decode_grid_rle

__all__ = [
    "load_results",
    "merge_results",
    "collect_metric_samples",
    "aggregate_stats",
    "format_stats_table",
    "plot_planner_stats",
    "plot_trajectories",
    "plot_sweep",
    "PLANNER_COLORS",
]

# Metrics plotted/aggregated by default — the reference's plot_planner_stats
# selection (corridor_experiment.ipynb cell 7) plus clearing distance.
DEFAULT_METRICS = [
    "planning_time",
    "path_length",
    "max_curvature",
    "normalized_curvature",
    "smoothness",
    "aol",
    "mean_clearing_distance",
    "cusps",
]

# Okabe-Ito palette: fixed categorical order (assigned by planner identity,
# never cycled), colorblind-safe by construction.
PLANNER_COLORS = [
    "#0072B2",  # blue
    "#E69F00",  # orange
    "#009E73",  # green
    "#CC79A7",  # purple-pink
    "#56B4E9",  # sky
    "#D55E00",  # vermillion
    "#F0E442",  # yellow
    "#000000",  # black
]


def load_results(files: Iterable[str | pathlib.Path]) -> dict:
    """Load + concatenate one or more ResultsLog JSON documents."""
    runs: list[dict] = []
    for f in files:
        doc = json.loads(pathlib.Path(f).read_text())
        runs.extend(doc.get("runs", []))
    return {"runs": runs}


def merge_results(files: Iterable[str | pathlib.Path],
                  out: str | pathlib.Path) -> pathlib.Path:
    """bench-mr `MultipleMPB.merge` equivalent: one merged document."""
    doc = load_results(files)
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2))
    return out


def collect_metric_samples(document: dict) -> dict[str, dict[str, list[float]]]:
    """{planner: {metric: [per-run values]}} over every run/plan in the doc.

    `path_found` / `path_collides` booleans are included as 0/1 series so
    feasibility rates fall out of the same aggregation.
    """
    samples: dict[str, dict[str, list[float]]] = {}
    for run in document.get("runs", []):
        for planner, plan in run.get("plans", {}).items():
            stats = plan.get("stats", {})
            per = samples.setdefault(planner, {})
            for key, value in stats.items():
                if isinstance(value, bool):
                    value = float(value)
                if value is None or not isinstance(value, (int, float)):
                    continue
                if isinstance(value, float) and math.isnan(value):
                    continue
                per.setdefault(key, []).append(float(value))
    return samples


def aggregate_stats(document: dict,
                    metrics: list[str] | None = None) -> dict[str, dict[str, dict]]:
    """{planner: {metric: {count, mean, std, median, min, max}}}."""
    samples = collect_metric_samples(document)
    keys = metrics if metrics is not None else None
    out: dict[str, dict[str, dict]] = {}
    for planner, per in samples.items():
        rows = {}
        for metric, values in per.items():
            if keys is not None and metric not in keys and metric not in (
                "path_found", "path_collides"
            ):
                continue
            arr = np.asarray(values, float)
            rows[metric] = {
                "count": int(arr.size),
                "mean": float(arr.mean()),
                "std": float(arr.std()),
                "median": float(np.median(arr)),
                "min": float(arr.min()),
                "max": float(arr.max()),
            }
        out[planner] = rows
    return out


def format_stats_table(aggregated: dict[str, dict[str, dict]],
                       metrics: list[str] | None = None) -> str:
    """Human-readable per-planner table (mean ± std [median])."""
    metrics = metrics or DEFAULT_METRICS
    lines = []
    for planner, rows in aggregated.items():
        found = rows.get("path_found", {}).get("mean")
        collides = rows.get("path_collides", {}).get("mean")
        n = next(iter(rows.values()))["count"] if rows else 0
        header = f"planner: {planner}   runs: {n}"
        if found is not None:
            header += f"   found: {100 * found:.0f}%"
        if collides is not None:
            header += f"   collision-free: {100 * (1 - collides):.0f}%"
        lines.append(header)
        lines.append(f"  {'metric':<26} {'mean':>10} {'std':>10} {'median':>10} {'min':>10} {'max':>10}")
        for metric in metrics:
            if metric not in rows:
                continue
            r = rows[metric]
            lines.append(
                f"  {metric:<26} {r['mean']:>10.3f} {r['std']:>10.3f} "
                f"{r['median']:>10.3f} {r['min']:>10.3f} {r['max']:>10.3f}"
            )
        lines.append("")
    return "\n".join(lines)


def _planner_color(planner: str, order: list[str]) -> str:
    return PLANNER_COLORS[order.index(planner) % len(PLANNER_COLORS)]


def plot_planner_stats(document: dict, out: str | pathlib.Path,
                       metrics: list[str] | None = None) -> pathlib.Path:
    """Per-metric box plots, one panel per metric, planners side by side —
    the `plot_planner_stats` notebook figure. Static PNG/PDF via matplotlib.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = metrics or DEFAULT_METRICS
    samples = collect_metric_samples(document)
    planners = sorted(samples)  # fixed, deterministic color assignment
    present = [m for m in metrics
               if any(m in samples[p] and samples[p][m] for p in planners)]
    if not present:
        raise ValueError("no plottable metrics found in document")

    cols = min(4, len(present))
    rows = (len(present) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 3.0 * rows),
                             squeeze=False)
    for ax in axes.ravel()[len(present):]:
        ax.set_visible(False)
    for i, metric in enumerate(present):
        ax = axes[i // cols][i % cols]
        data, colors, labels = [], [], []
        for p in planners:
            vals = samples[p].get(metric)
            if not vals:
                continue
            data.append(vals)
            colors.append(_planner_color(p, planners))
            labels.append(p)
        bp = ax.boxplot(data, patch_artist=True, widths=0.6,
                        medianprops={"color": "#333333"})
        for patch, color in zip(bp["boxes"], colors):
            patch.set_facecolor(color)
            patch.set_alpha(0.75)
            patch.set_edgecolor("none")
        ax.set_title(metric, fontsize=10)
        ax.set_xticks(range(1, len(labels) + 1))
        ax.set_xticklabels(labels, rotation=20, fontsize=7)
        ax.grid(axis="y", color="#dddddd", linewidth=0.6)
        ax.set_axisbelow(True)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
    if len(planners) > 1:
        handles = [plt.Line2D([], [], marker="s", linestyle="", markersize=8,
                              color=_planner_color(p, planners)) for p in planners]
        fig.legend(handles, planners, loc="lower center",
                   ncol=min(4, len(planners)), frameon=False, fontsize=8)
        fig.subplots_adjust(bottom=0.18)
    fig.tight_layout()
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_trajectories(document: dict, out: str | pathlib.Path,
                      max_runs: int | None = None,
                      planner: str | None = None) -> pathlib.Path:
    """Gallery of per-run trajectories over their occupancy grids — the
    `visualize_trajectories` notebook figure. Requires runs logged with
    grid_environment_info (results.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = document.get("runs", [])
    if max_runs is not None:
        runs = runs[:max_runs]
    if not runs:
        raise ValueError("document has no runs")
    cols = min(5, len(runs))
    nrows = (len(runs) + cols - 1) // cols
    fig, axes = plt.subplots(nrows, cols, figsize=(3.0 * cols, 3.0 * nrows),
                             squeeze=False)
    for ax in axes.ravel()[len(runs):]:
        ax.set_visible(False)
    for i, run in enumerate(runs):
        ax = axes[i // cols][i % cols]
        env = run.get("environment", {})
        if env.get("type") == "grid" and "occupancy" in env:
            blocked = decode_grid_rle(env["occupancy"])
            res = env.get("resolution", 1.0)
            ox, oy = env.get("origin", (0.0, 0.0))
            h, w = blocked.shape
            ax.imshow(blocked, origin="lower", cmap="gray_r",
                      extent=(ox, ox + w * res, oy, oy + h * res),
                      interpolation="nearest", alpha=0.9)
        plans = run.get("plans", {})
        names = [planner] if planner else list(plans)
        for name in names:
            plan = plans.get(name)
            if plan is None:
                continue
            path = np.asarray(plan.get("path", []))
            if path.size == 0:
                continue
            collides = plan.get("stats", {}).get("path_collides", False)
            color = "#D55E00" if collides else "#0072B2"
            ax.plot(path[:, 0], path[:, 1], color=color, linewidth=1.6)
            ax.plot(path[0, 0], path[0, 1], "o", color="#009E73", markersize=5)
            ax.plot(path[-1, 0], path[-1, 1], "s", color="#000000", markersize=5)
        idx = run.get("seed_index", i)
        ax.set_title(f"run {idx}", fontsize=9)
        ax.set_aspect("equal")
        ax.tick_params(labelsize=6)
    fig.tight_layout()
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_sweep(rows: list[dict], out: str | pathlib.Path,
               title: str | None = None) -> pathlib.Path:
    """Hyperparameter-sweep panel: sigma x collision_weight heatmaps of
    feasibility and mean feasible path length (the run_bench_mr_configured.py
    usage mode, scripts/run_sweep.py output schema).

    Two single-hue sequential heatmaps (magnitude encoding), every cell
    direct-labeled with ink switched on cell luminance.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sigmas = sorted({r["sigma"] for r in rows})
    weights = sorted({r["collision_weight"] for r in rows})
    feas = np.full((len(sigmas), len(weights)), np.nan)
    length = np.full((len(sigmas), len(weights)), np.nan)
    total = max((r.get("total", 0) for r in rows), default=0)
    for r in rows:
        i = sigmas.index(r["sigma"])
        j = weights.index(r["collision_weight"])
        feas[i, j] = r["feasible"] / max(r.get("total", 1), 1)
        length[i, j] = r.get("mean_feasible_length", np.nan)

    fig, axes = plt.subplots(1, 2, figsize=(8.2, 3.6))
    panels = [
        (axes[0], feas, f"feasible fraction (of {total} seeds)", "Blues",
         "{:.2f}", 0.0, 1.0),
        (axes[1], length, "mean feasible path length", "Oranges",
         "{:.2f}", None, None),
    ]
    for ax, grid, label, cmap, fmt, vmin, vmax in panels:
        im = ax.imshow(grid, cmap=cmap, vmin=vmin, vmax=vmax, aspect="auto")
        ax.set_xticks(range(len(weights)))
        ax.set_xticklabels([f"{w:g}" for w in weights], fontsize=8)
        ax.set_yticks(range(len(sigmas)))
        ax.set_yticklabels([f"{s:g}" for s in sigmas], fontsize=8)
        ax.set_xlabel("collision_weight", fontsize=9)
        ax.set_ylabel("sigma", fontsize=9)
        ax.set_title(label, fontsize=10)
        norm = im.norm
        for i in range(len(sigmas)):
            for j in range(len(weights)):
                v = grid[i, j]
                if np.isnan(v):
                    continue
                # switch ink on cell luminance so labels stay readable
                r_, g_, b_, _ = im.cmap(norm(v))
                lum = 0.299 * r_ + 0.587 * g_ + 0.114 * b_
                ax.text(j, i, fmt.format(v), ha="center", va="center",
                        fontsize=9,
                        color="#1a1a1a" if lum > 0.6 else "#ffffff")
        for spine in ax.spines.values():
            spine.set_visible(False)
    if title:
        fig.suptitle(title, fontsize=11)
    fig.tight_layout()
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out
