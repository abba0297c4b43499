"""Frozen work counts of the planner's field functions: multiply-adds per
point, bytes each function must move, and the least time a card could take.

They count the algorithm's work from the field's widths, not what a kernel
does, so they stay right whatever implements the function later. A
multiply-add is two operations; transcendentals are not counted.

    forward      the field's logits at M points
    field_grad   forward + the parameter gradient of the mean BCE
    collision    forward + the input gradient (the trajectory's collision
                 terms and their backward)
"""
from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).with_name("peaks.json")).read_text())


def widths(onf: dict) -> tuple[int, int, int]:
    """(Fourier features, angle features, hidden) of a field."""
    return onf["fourier_features"], 2 * onf["angle_harmonics"], onf["hidden"]


def param_count(onf: dict) -> int:
    f, a, hid = widths(onf)
    feat = f + a
    return 2 * f + f + feat * hid + hid + hid * hid + hid + (hid + feat) + 1 + a


def field_macs(onf: dict) -> dict:
    """Multiply-adds per point of each function."""
    f, a, hid = widths(onf)
    feat = f + a
    forward = 2 * f + feat * hid + hid * hid + (hid + feat)
    input_back = hid + hid * hid + feat * hid + feat + 2 * f + a
    param_back = (hid + feat) + hid + 2 * hid * hid + 2 * feat * hid + feat + 3 * f + a
    return {"forward": forward, "collision": forward + input_back,
            "field_grad": forward + param_back}


def moved_bytes(function: str, batch: int, n_params: int, m: int, dim: int = 3) -> int:
    """Bytes a function must read and write once on B problems of M points
    (f32 parameters, points, labels or multipliers, outputs)."""
    params = 4 * batch * n_params
    points = 4 * batch * m * dim
    return {
        "forward": params + points + 4 * batch * m,
        "field_grad": 2 * params + points + 4 * batch * m + 4 * batch,
        "collision": params + 2 * points + 8 * batch * m + 8 * batch,
    }[function]


def flops(function: str, onf: dict, batch: int, m: int) -> float:
    return 2.0 * field_macs(onf)[function] * batch * m


def card_peaks(card_name: str) -> dict:
    """The published peaks of the card whose name `card_name` is."""
    for key, peaks in PEAKS.items():
        if key != "H100 SXM" and key.split()[1] in card_name:
            return peaks
    return PEAKS["H100 SXM"]


def bound_s(function: str, onf: dict, batch: int, m: int, peaks: dict,
            precision: str = "f32") -> float:
    """The least seconds the function could take: the larger of its
    operations over the peak of `precision` and its bytes over the memory
    rate."""
    ops = flops(function, onf, batch, m) / peaks[precision]
    moved = moved_bytes(function, batch, param_count(onf), m) / peaks["bytes_per_s"]
    return max(ops, moved)


def step_points(solver: dict) -> dict:
    """Points per problem of each field function in one step: the replay
    buffer's candidates scored (K + N-1), the field's training batch (N-1 +
    K + R) and the collision poses ((N-1) S)."""
    n, k = solver["trajectory_length"], solver["collision_point_count"]
    r, s = solver["random_field_points"], solver["collision_samples_per_segment"]
    return {"forward": k + n - 1, "field_grad": (n - 1) + k + r, "collision": (n - 1) * s}


def step_flops(solver: dict, batch: int) -> float:
    """Operations of one step of B problems: the three field functions at
    the step's points, and the trajectory's preconditioning product
    (H^-1 [N, N] times the gradient [N, 3])."""
    onf = solver["onf"]
    total = sum(flops(fn, onf, batch, m) for fn, m in step_points(solver).items())
    n = solver["trajectory_length"]
    return total + 2.0 * n * n * 3 * batch
