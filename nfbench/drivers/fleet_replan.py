"""A fleet of robots on one map served by the program's replanning service
(`FleetReplanningService`), one node in a closed loop: a cycle starts when
the previous one's paths are back.

Robot r starts at the scene's start (even r) or goal (odd r) and heads for
the other end; between cycles each robot moves to waypoint
`follow_waypoint` of its postprocessed path, and every `goal_swap_every`
cycles every robot is sent back to where it came from. Each cycle runs one
chunk of `steps_per_chunk` steps (`planning_timeout` 0), so the work per
cycle is fixed and its latency measures speed. The traffic file sets:

    robots, group_size  the fleet and the robots that share one field
    steps_per_chunk, planning_timeout, follow_waypoint, goal_swap_every
    warmup_cycles       cycles of the set-up (they capture the programs)
    followed_cycles, postprocess_checked, sample_cycles_below
                        how many cycles the check follows with the reference,
                        and how many it redoes the postprocessing of, drawn
                        from the seed among the window's first ones
    path_off_m          the gap past which a followed path counts as off
    trace               the traced slice: cycles [from, to)
"""
from __future__ import annotations

import sys
import math
import time

import numpy as np
import torch

from nfbench.drivers import se2_port as se2
from nfbench.harness import core


class Recorder:
    """The service's postprocessor: the program's `PathPostprocessor` inside
    the benchmark's span, keeping what goes in and what comes out."""

    def __init__(self, inner, spans):
        self.inner = inner
        self.spans = spans
        self.cycle: list = []

    def process(self, path):
        with self.spans.span("postprocess"):
            out = self.inner.process(path)
        self.cycle.append((path, out))
        return out


class Driver:
    def __init__(self, cell, seed: int, device, spans, overrides: dict):
        self.cell = cell
        self.config = cell.config
        self.traffic = {**cell.traffic, **overrides}
        self.seed = seed
        self.device = device
        self.spans = spans
        self.latencies: list = []
        self.failed = 0
        self.cycles = 0
        self.kept: dict = {}  # sampled cycle -> [(raw path, postprocessed)]
        self.followed: dict = {}  # cycle -> (states before, generator state, poses)

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from nfopp_tpu_torch.service import FleetReplanningService, PathPostprocessor
        from nfopp_tpu_torch.utils import enable_compile_cache
        from nfopp_tpu_torch.utils.tree import tree_map

        if self.device.type == "cuda":
            enable_compile_cache(self.device)
        t = self.traffic
        n = t["robots"]
        self.world = se2.scene(self.config, 1, self.device)
        sc = self.config["scene"]
        self.ends = np.asarray([sc["start"], sc["goal"]], np.float32)
        self.recorder = Recorder(PathPostprocessor(), self.spans)
        self.service = FleetReplanningService(
            se2.program_solver(self.config, self.device, "nfbench"), n,
            np.asarray(sc["bounds"], np.float32), se2.program_oracle(self.world),
            planning_timeout=t["planning_timeout"], steps_per_chunk=t["steps_per_chunk"],
            group_size=t["group_size"], postprocessor=self.recorder,
            seed=core.batch_seed(self.seed, 0), mesh=None)
        self.poses = self.ends[np.arange(n) % 2].copy()
        self.goals = self.ends[1 - np.arange(n) % 2].copy()
        for r in range(n):
            self.service.update_robot_pose(r, self.poses[r])
            if not self.service.set_goal(r, self.goals[r]):
                raise RuntimeError(f"robot {r} refused its goal")
        self.initial = self.service._states
        for _ in range(t["warmup_cycles"]):
            self.cycle()
        # the window keeps the followed cycles' states alive: hold as many
        # here, so that the allocator's pool grows in set-up, not in the window
        held = [tree_map(torch.clone, self.service._states) for _ in range(t["followed_cycles"])]
        del held
        rng = np.random.default_rng(core.batch_seed(self.seed, 1))
        self.sampled = {int(c) for c in rng.choice(t["sample_cycles_below"],
                                                   t["followed_cycles"], replace=False)}
        self.post_sampled = {int(c) for c in rng.choice(
            t["sample_cycles_below"], t["postprocess_checked"], replace=False)}

    def cycle(self) -> float:
        """One replan cycle, then every robot moves along its new path;
        returns the seconds of the cycle, from the call into the service
        until its postprocessed paths are back."""
        self.recorder.cycle = []
        t0 = time.perf_counter()
        paths = self.service.replan_cycle()
        seconds = time.perf_counter() - t0
        k = self.traffic["follow_waypoint"]
        for r, p in paths.items():
            if len(p) > 2:
                self.poses[r] = p[min(k, len(p) - 1)]
                self.service.update_robot_pose(r, self.poses[r])
        return seconds

    # ------------------------------------------------------------- window

    def window(self, seconds: float, tracer) -> None:
        t = self.traffic
        swap = t["goal_swap_every"]
        start_at, stop_at = t["trace"]
        self.t0 = t0 = time.perf_counter()
        deadline, c = t0 + seconds, 0
        while time.perf_counter() < deadline:
            if c and c % swap == 0:
                with self.spans.span("retarget"):
                    self.goals = np.where((self.goals == self.ends[1]).all(axis=1)[:, None],
                                          self.ends[0], self.ends[1])
                    for r in range(t["robots"]):
                        self.service.set_goal(r, self.goals[r])
            if c == start_at:
                tracer.start()
            if c == stop_at:
                tracer.stop()
            if c in self.sampled:
                self.followed[c] = (self.service._states, self.service._generator.get_state(),
                                    self.poses.copy())
            try:
                with self.spans.span("cycle"):
                    self.latencies.append(self.cycle())
            except Exception as exc:  # a failed cycle counts as missing
                print(f"cycle {c} failed: {exc!r}", flush=True, file=sys.stderr)
                self.failed += 1
            if c in self.sampled or c in self.post_sampled:
                self.kept[c] = self.recorder.cycle
            c += 1
        self.cycles = c
        tracer.stop()
        ms = np.asarray(self.latencies) * 1e3
        post, _ = self.spans.total("postprocess", since=t0)
        if ms.size:
            print(f"{len(ms)} cycles: ms p10 {np.percentile(ms, 10):.1f} p50 "
                  f"{np.median(ms):.1f} p90 {np.percentile(ms, 90):.1f} max {ms.max():.1f}; "
                  f"postprocess {1e3 * post / len(ms):.1f} ms per cycle", file=sys.stderr)

    # ------------------------------------------------------------ metrics

    def attempted_failed(self) -> tuple[int, int]:
        return len(self.latencies) + self.failed, self.failed

    def end_to_end(self) -> dict:
        if not self.latencies:
            raise RuntimeError(f"no cycle of the window completed ({self.failed} failed)")
        return {"cycle_ms_p90": float(np.percentile(np.asarray(self.latencies) * 1e3, 90))}

    def counters(self) -> dict:
        return {"cycles": self.cycles, "window_t0": self.t0}

    # -------------------------------------------------------------- check

    def judge(self, candidate: str = "program") -> list:
        """The numbers compared and their limits: the service's first states
        against the reference's init and retargets, bit for bit; the gap of
        each robot's raw path in every followed cycle, the largest gap
        between the service's path and the reference's cycle run from the
        service's states before it with the same noise (`candidate`
        "control": the reference in TF32 in the program's place), read two
        ways: the quietest group, the smallest over the followed cycles and
        the groups of `group_size` robots of the median gap of a group's
        robots, and the share of the robot-cycles whose gap passes
        `path_off_m`; and the postprocessing of sampled cycles redone, bit
        for bit. The quietest group and not a tail or a quantile over
        robots: the shared field carries f32 rounding from any robot of a
        group to all of its robots within a cycle, so a group-cycle is
        quiet or not as a whole, and how many are varies by seed (PERF.md);
        TF32 moves every robot of every group. The share refuses what the
        quietest group passes: a fault confined to some robots, which moves
        their paths farther than f32 rounding ever moved one."""
        ref = core.reference_module(self.config["reference"])
        post = core.reference_module("postprocess")
        t, limits = self.traffic, self.cell.limits
        n, group = t["robots"], t["group_size"]
        planner = ref.Planner(self.config["solver"], self.device)
        control = ref.Planner(self.config["solver"], self.device, "tf32")
        world = {k: v.expand((n,) + tuple(v.shape[1:]))
                 for k, v in se2.reference_world(self.world).items()}
        ends = torch.as_tensor(self.ends, device=self.device)
        starts = ends[torch.arange(n, device=self.device) % 2]
        goals = ends[1 - torch.arange(n, device=self.device) % 2]
        bounds = torch.as_tensor(self.config["scene"]["bounds"], device=self.device).expand(n, 4)
        g = torch.Generator(device=self.device).manual_seed(core.batch_seed(self.seed, 0))
        want = planner.retarget(planner.init_state(g, starts, starts, bounds, world, group),
                                starts, goals)
        init_gap = se2.largest_gap(se2.as_reference(self.initial), want)
        gaps, quiet = [], []
        self.detail = {}
        for c, (states, g_state, poses) in sorted(self.followed.items()):
            if len(self.kept.get(c, ())) != n:
                continue  # not reached, or failed (counted in `failed`)
            runs = {}
            for name, who in (("reference", planner), ("control", control)):
                if name == "reference" or candidate == "control":
                    g = torch.Generator(device=self.device)
                    g.set_state(g_state)
                    s = who.update_start(se2.as_reference(states),
                                         torch.as_tensor(poses, device=self.device))
                    runs[name] = ref.Planner.full_path(
                        who.run(s, g, world, t["steps_per_chunk"], group))
            got = runs["control"] if candidate == "control" else torch.as_tensor(
                np.stack([raw for raw, _ in self.kept[c]]), device=self.device)
            gaps.append(se2.path_gaps(got, runs["reference"]))
            quiet.append(gaps[-1].reshape(n // group, group).median(dim=1).values.min())
            self.detail[c] = [gaps[-1]]
        gaps = torch.cat(gaps) if gaps else torch.full((1,), math.inf)  # nothing followed
        quietest = float(min(quiet)) if quiet else math.inf
        post_gap = 0.0
        for c in sorted(self.post_sampled):
            for raw, out in self.kept.get(c, ()):
                redo = post.postprocess(raw)
                post_gap = max(post_gap, float(np.abs(redo - out).max()) if redo.shape == out.shape
                               else float("inf"))
        return [("init_gap", init_gap, limits["init_gap"]),
                ("quietest_group_gap", quietest, limits["quietest_group_gap"]),
                ("paths_off_pct", se2.share_over(gaps, t["path_off_m"]), limits["paths_off_pct"]),
                ("postprocess_gap", post_gap, limits["postprocess_gap"])]
