"""frozen_lane_share: the share (%) of the lane-steps the tracked loop
computed in the window's rounds (base solves and restart rounds) that it
computed for problems already stopped (`solver/tracking.py::LANE_STEPS`;
None where the program has no such counter)."""


def read(ctx):
    lanes = ctx.counters.get("lane_steps")
    if not lanes or not lanes[0]:
        return None
    computed, active = lanes
    return 100.0 * (computed - active) / computed
