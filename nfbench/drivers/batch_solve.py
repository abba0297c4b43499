"""Fresh batches of problems solved back to back (a throughput planning
service, a benchmark sweep on one map).

Each batch of `problems` draws its fields, buffers and noise from a CUDA
generator seeded from the run's seed and the batch's index; it is
initialized (`init_state`), solved by `run` calls of `calls` steps (1000 in
all), and its final paths' feasibility is evaluated, which waits for the
card. Batches start while the window lasts; the window ends when the last
one completes. The traffic file sets:

    problems        problems per batch
    calls           steps of each `run` call of a batch, in order
    warmup_calls    the set-up batch's calls (they capture the programs)
    followed_calls  the calls whose steps the check follows with the reference
    followed_batches, sample_from_first
                    how many batches the check follows, drawn from the seed
                    among the window's first `sample_from_first`
    path_off_m      the gap past which a followed path counts as off
    counted_batches the batches whose final paths `attempted`, `failed` and
                    `feasible_frac` count: the window's first, drawn from
                    the seed alone, so that every run of a seed counts the
                    same problems however many batches its window holds (a
                    run that completes fewer counts those it completed)
    trace           the traced slice: from [batch, call] to [batch, call]
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from nfbench.drivers import se2_port as se2
from nfbench.harness import core


class Driver:
    def __init__(self, cell, seed: int, device, spans, overrides: dict):
        self.cell = cell
        self.config = cell.config
        self.traffic = {**cell.traffic, **overrides}
        self.seed = seed
        self.device = device
        self.spans = spans
        self.batches: list = []  # (full paths [B, M, 3], program's collides [B])
        self.followed: dict = {}  # batch -> {"init": state, "calls": {i: (before, g, after)}}

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from nfopp_tpu_torch.solver import evaluate_path
        from nfopp_tpu_torch.utils import enable_compile_cache
        from nfopp_tpu_torch.utils.tree import tree_map
        from nfopp_tpu_torch.worlds import rectangle_collision

        if self.device.type == "cuda":
            enable_compile_cache(self.device)
        t = self.traffic
        self.world = se2.scene(self.config, t["problems"], self.device)
        self.oracle = se2.program_oracle(self.world)
        self.solver = se2.program_solver(self.config, self.device, "nfbench")
        samples = self.config["scene"]["feasibility_samples_per_segment"]
        self.evaluate = lambda paths: evaluate_path(rectangle_collision, self.oracle, paths,
                                                    samples)[0]
        g = self.generator(core.batch_seed(self.seed, 2 ** 30))
        s = self.solver.init_state(g, self.world["start"], self.world["goal"],
                                   self.world["bounds"], self.oracle)
        for n in t["warmup_calls"]:
            s, _ = self.solver.run(s, self.oracle, n, g)
        self.evaluate(self.solver.full_trajectory(s)).cpu()
        # the window keeps the followed batches' states alive: hold as many
        # here, so that the allocator's pool grows in set-up, not in the window
        held = [tree_map(torch.clone, s)
                for _ in range(t["followed_batches"] * (1 + 2 * len(t["followed_calls"])))]
        del held
        rng = np.random.default_rng(core.batch_seed(self.seed, 2 ** 30 + 1))
        self.sampled = {int(i) for i in rng.choice(t["sample_from_first"],
                                                   t["followed_batches"], replace=False)}

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- window

    def window(self, seconds: float, tracer) -> None:
        t = self.traffic
        calls, followed = t["calls"], set(t["followed_calls"])
        start_at, stop_at = tuple(t["trace"][0]), tuple(t["trace"][1])
        self.slice_steps = 0
        self.batch_s, self.batch_s_end = [], None
        self.sync()
        t0 = time.perf_counter()
        deadline, k = t0 + seconds, 0
        while time.perf_counter() < deadline:
            g = self.generator(core.batch_seed(self.seed, k))
            with self.spans.span("init"):
                s = self.solver.init_state(g, self.world["start"], self.world["goal"],
                                           self.world["bounds"], self.oracle)
            record = {"init": s, "calls": {}} if k in self.sampled else None
            for i, n in enumerate(calls):
                if (k, i) == start_at:
                    tracer.start()
                if (k, i) == stop_at:
                    tracer.stop()
                if tracer.active:
                    self.slice_steps += n
                before = (s, g.get_state()) if record is not None and i in followed else None
                with self.spans.span("chunk"):
                    s, _ = self.solver.run(s, self.oracle, n, g)
                if before is not None:
                    record["calls"][i] = (*before, s)
            with self.spans.span("evaluate"):
                full = self.solver.full_trajectory(s)
                collides = self.evaluate(full).cpu()
            self.done_at = time.perf_counter()
            self.batch_s.append(self.done_at - (self.batch_s_end or t0))
            self.batch_s_end = self.done_at
            self.batches.append((full, collides))
            if record is not None:
                self.followed[k] = record
            k += 1
        tracer.stop()
        self.elapsed = self.done_at - t0
        print("seconds per batch", [round(x, 4) for x in self.batch_s], file=sys.stderr)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ metrics

    def _reference_collides(self) -> torch.Tensor:
        if not hasattr(self, "_ref_collides"):
            ref = core.reference_module(self.config["reference"])
            world = se2.reference_world(self.world)
            samples = self.config["scene"]["feasibility_samples_per_segment"]
            self._ref_collides = torch.cat([ref.collides(world, full, samples).cpu()
                                            for full, _ in self.batches])
        return self._ref_collides

    def counted_collides(self) -> torch.Tensor:
        """The reference's collisions of the counted batches' final paths."""
        t = self.traffic
        return self._reference_collides()[:t["counted_batches"] * t["problems"]]

    def attempted_failed(self) -> tuple[int, int]:
        collides = self.counted_collides()
        return int(collides.numel()), int(collides.sum())

    def end_to_end(self) -> dict:
        attempted, failed = self.attempted_failed()
        solved = len(self.batches) * self.traffic["problems"]  # every batch of the window
        return {"solves_per_s": solved / self.elapsed,
                "feasible_frac": 100.0 * (attempted - failed) / attempted}

    def counters(self) -> dict:
        return {"problems": self.traffic["problems"], "slice_steps": self.slice_steps}

    # -------------------------------------------------------------- check

    def judge(self, candidate: str = "program") -> list:
        """The numbers compared and their limits: each followed batch's init
        against the reference's, bit for bit; the 90th percentile over the
        followed problems of the largest gap between the program's path
        after a followed call and the reference's, run from the program's
        state before it with the same noise; the share of those problems
        whose gap passes `path_off_m`, a distance that f32 rounding never
        gave one (PERF.md), so that a fault confined to a few problems, which
        the percentile passes, is refused; and the program's feasibility of
        every final path of the window against the reference's.
        `candidate` "control" puts the reference in TF32 in the program's
        place for the followed calls."""
        ref = core.reference_module(self.config["reference"])
        limits = self.cell.limits
        planner = ref.Planner(self.config["solver"], self.device)
        control = ref.Planner(self.config["solver"], self.device, "tf32")
        world = se2.reference_world(self.world)
        init_gap, gaps, self.detail = 0.0, [], {}
        for k, record in sorted(self.followed.items()):
            g = self.generator(core.batch_seed(self.seed, k))
            want = planner.init_state(g, self.world["start"], self.world["goal"],
                                      self.world["bounds"], world)
            init_gap = max(init_gap, se2.largest_gap(se2.as_reference(record["init"]), want))
            for i, (before, g_state, after) in sorted(record["calls"].items()):
                n = self.traffic["calls"][i]
                runs = {}
                for name, who in (("reference", planner), ("control", control)):
                    if name == "reference" or candidate == "control":
                        g = torch.Generator(device=self.device)
                        g.set_state(g_state)
                        runs[name] = ref.Planner.full_path(
                            who.run(se2.as_reference(before), g, world, n))
                got = runs["control"] if candidate == "control" else \
                    ref.Planner.full_path(se2.as_reference(after))
                gaps.append(se2.path_gaps(got, runs["reference"]))
                self.detail.setdefault(i, []).append(gaps[-1])
        gaps = torch.cat(gaps) if gaps else torch.full((1,), math.inf)  # nothing followed
        collides = torch.cat([c for _, c in self.batches])
        mismatch = int((collides != self._reference_collides()).sum())
        return [("init_gap", init_gap, limits["init_gap"]),
                ("path_gap_p90", se2.quantile(gaps, 0.9), limits["path_gap_p90"]),
                ("paths_off_pct", se2.share_over(gaps, self.traffic["path_off_m"]),
                 limits["paths_off_pct"]),
                ("feasible_mismatch", mismatch, limits["feasible_mismatch"])]
