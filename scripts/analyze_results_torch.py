#!/usr/bin/env python3
"""Analyze benchmark result JSONs (the counterpart of
scripts/analyze_results.py): the reference's notebook analysis flow (merge
pooled runs, per-planner stat plots, trajectory galleries;
corridor_experiment.ipynb cells 5-7) as a CLI over
nfopp_tpu_torch.bench.analysis. Host-only: numpy over the results schema;
the plots need matplotlib and are drawn only when asked for (the script
refuses a plot flag where matplotlib does not import).

    # aggregate table over one or more result files
    python3 scripts/analyze_results_torch.py results_a.json results_b.json

    # merge into one document (bench-mr MultipleMPB.merge)
    python3 scripts/analyze_results_torch.py a.json b.json --merge merged.json

    # per-metric box plots per planner (plot_planner_stats)
    python3 scripts/analyze_results_torch.py merged.json --plot stats.png

    # trajectory gallery over the occupancy grids (visualize_trajectories)
    python3 scripts/analyze_results_torch.py merged.json --trajectories traj.png
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def table(files, metrics: list[str] | None = None, merge: str | None = None) -> tuple[dict, str]:
    """(the loaded document, the per-planner table) of the result files,
    merged into `merge` first when given."""
    from nfopp_tpu_torch.bench import analysis

    doc = analysis.load_results(files)
    if merge:
        out = analysis.merge_results(files, merge)
        print(f"merged {len(files)} file(s), {len(doc['runs'])} runs -> {out}")
    return doc, analysis.format_stats_table(analysis.aggregate_stats(doc, metrics), metrics)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="+", help="results JSON files")
    parser.add_argument("--merge", help="write merged document here")
    parser.add_argument("--plot", help="write per-metric stat panels (png/pdf)")
    parser.add_argument("--trajectories", help="write trajectory gallery (png/pdf)")
    parser.add_argument("--planner", help="restrict trajectory gallery to one planner")
    parser.add_argument("--max-runs", type=int, help="limit gallery size")
    parser.add_argument("--metrics", help="comma-separated metric list override")
    parser.add_argument("--sweep-panel", help="treat FILES[0] as a "
                        "run_sweep.py row list and write sigma x "
                        "collision_weight heatmaps here (png/pdf)")
    args = parser.parse_args()
    if ((args.plot or args.trajectories or args.sweep_panel)
            and importlib.util.find_spec("matplotlib") is None):
        parser.error("--plot, --trajectories and --sweep-panel draw with matplotlib, "
                     "which this Python does not have")

    from nfopp_tpu_torch.bench import analysis

    if args.sweep_panel:
        rows = json.loads(pathlib.Path(args.files[0]).read_text())
        out = analysis.plot_sweep(
            rows, args.sweep_panel,
            title=pathlib.Path(args.files[0]).stem,
        )
        print(f"sweep panel -> {out}")
        return 0

    metrics = args.metrics.split(",") if args.metrics else None
    doc, text = table(args.files, metrics, args.merge)
    print(text)

    if args.plot:
        out = analysis.plot_planner_stats(doc, args.plot, metrics)
        print(f"stat panels -> {out}")
    if args.trajectories:
        out = analysis.plot_trajectories(
            doc, args.trajectories, max_runs=args.max_runs, planner=args.planner
        )
        print(f"trajectory gallery -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
