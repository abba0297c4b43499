#!/usr/bin/env python3
"""Generate a MovingAI-format 256x256 city map and its scenario file (the
counterpart of scripts/make_city_map.py).

The reference's MovingAI experiments run Berlin_0_256.map from bench-mr's
scenario bundle, which is not vendored, so this generates a city-style map
instead: blocked building blocks cut by a connected street grid with
randomized spacing and widths, diagonal avenues and open plazas.
Deterministic for a given seed: the grid is the JAX script's `city_grid`,
draw for draw.

The .scen entries carry true geodesic optimal lengths (octile metric) from
the port's wavefront distance field (`astar/wavefront.py::distance_field`,
equal to JAX's bit for bit) on the raw grid. Endpoints keep 2 cells of
clearance (`worlds/scenarios.py::dilate`). Candidate pairs are drawn one at
a time from the JAX script's generator in its order (`make_city_map.py:
78-104`); their fields are computed --batch at a time, and the first
--scens pairs that are reachable and at least 60 cells apart are kept, so
the lines are the JAX script's.

    python3 scripts/make_city_map_torch.py --out assets/movingai --seed 0
    python3 scripts/make_city_map_torch.py --out /tmp/city --device cpu

Prints one JSON object. --device (where the distance fields run) is cuda
unless asked for the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SIZE = 256


def city_grid(seed: int) -> np.ndarray:
    """[SIZE, SIZE] bool: True = blocked (building), False = street
    (`make_city_map.py::city_grid`, draw for draw)."""
    rng = np.random.RandomState(seed)
    blocked = np.ones((SIZE, SIZE), bool)

    def carve_rows(positions, widths):
        for p, w in zip(positions, widths):
            blocked[max(0, p): min(SIZE, p + w), :] = False

    def carve_cols(positions, widths):
        for p, w in zip(positions, widths):
            blocked[:, max(0, p): min(SIZE, p + w)] = False

    # street grid: randomized spacing 14-24, width 3-6
    rows, p = [], rng.randint(4, 12)
    while p < SIZE - 4:
        rows.append(p)
        p += rng.randint(14, 25)
    cols, p = [], rng.randint(4, 12)
    while p < SIZE - 4:
        cols.append(p)
        p += rng.randint(14, 25)
    carve_rows(rows, rng.randint(3, 7, len(rows)))
    carve_cols(cols, rng.randint(3, 7, len(cols)))

    # two diagonal avenues (width ~5)
    ii = np.arange(SIZE)
    for sign, offset in ((1, rng.randint(-30, 30)), (-1, rng.randint(226, 286))):
        jj = sign * ii + offset
        for d in range(-2, 3):
            j = np.clip(jj + d, 0, SIZE - 1)
            keep = (jj + d >= 0) & (jj + d < SIZE)
            blocked[ii[keep], j[keep]] = False

    # open plazas: a few free rectangles
    for _ in range(6):
        ci, cj = rng.randint(20, SIZE - 20, 2)
        hi, hj = rng.randint(8, 18, 2)
        blocked[ci - hi: ci + hi, cj - hj: cj + hj] = False
    return blocked


def make_scen_entries(blocked: np.ndarray, map_name: str, count: int, seed: int, device,
                      batch: int = 8) -> list[str]:
    """Scenario lines with true octile-geodesic optimal lengths."""
    import torch

    from nfopp_tpu_torch.astar.wavefront import distance_field
    from nfopp_tpu_torch.worlds.scenarios import dilate

    rng = np.random.RandomState(seed + 1)
    free_i, free_j = np.where(~dilate(blocked, 2))
    grid = torch.as_tensor(blocked, device=device)
    lines = []
    while len(lines) < count:
        pairs = [rng.randint(len(free_i), size=2) for _ in range(batch)]
        goals = torch.tensor([[free_i[b], free_j[b]] for _, b in pairs], device=device)
        fields = distance_field(grid[None].expand(batch, -1, -1), goals).cpu().numpy()
        for (a, b), dist in zip(pairs, fields):
            si, sj = int(free_i[a]), int(free_j[a])
            gi, gj = int(free_i[b]), int(free_j[b])
            optimal = float(dist[si, sj])
            # unreachable is the wavefront's finite sentinel (~7.5e37), not inf
            if optimal > 1e30 or optimal < 60.0 or len(lines) == count:
                continue
            # MovingAI columns: bucket map width height start_x start_y goal_x goal_y optimal
            lines.append(f"{len(lines)}\t{map_name}\t{SIZE}\t{SIZE}\t{sj}\t{si}\t{gj}\t{gi}\t"
                         f"{optimal:.8f}")
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="assets/movingai")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scens", type=int, default=20)
    parser.add_argument("--name", default="city_0_256")
    parser.add_argument("--batch", type=int, default=8, help="distance fields per call")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()

    from nfopp_tpu_torch.utils.device import check_device

    device = check_device(args.device, "make_city_map_torch")
    blocked = city_grid(args.seed)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    map_path = out / f"{args.name}.map"
    rows = ["".join("@" if c else "." for c in row) for row in blocked]
    map_path.write_text(f"type octile\nheight {SIZE}\nwidth {SIZE}\nmap\n" + "\n".join(rows) + "\n")
    scen_path = out / f"{args.name}.map.scen"
    entries = make_scen_entries(blocked, f"{args.name}.map", args.scens, args.seed, device,
                                args.batch)
    scen_path.write_text("version 1\n" + "\n".join(entries) + "\n")
    print(json.dumps({"map": str(map_path), "free_percent": float((~blocked).mean() * 100),
                      "scen": str(scen_path), "scenarios": len(entries), "device": str(device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
