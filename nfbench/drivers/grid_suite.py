"""Whole benchmark suites solved back to back on the same grid worlds (a
sweep that solves one Bench-MR suite under many seeds, an author
reproducing the paper's comparison).

Set-up builds the suite users run (`scripts/run_benchmark_torch.py --suite
corridor --seeds 256`: world i from seed i, its endpoints from seed
`endpoint_seed_offset` + i) with the benchmark's own generator
(`corridor_worlds.py`), hands the worlds to the program as its
`GridScenario`s, solves one warm-up suite, which captures the base
programs, and captures the restart round's programs for 1 to
`precaptured_failures` failed problems, as a sweep's earlier suites would
have; `--seed` seeds the solves. Round k of the window is one call of the program's suite runner,
`run_grid_suite(..., aot=True, seed=batch_seed(seed, k))`: the wavefront
init, `init_state` with pretraining, the tracked solve, the shortcut pass,
a restart round of `restart_failed` lanes per problem still infeasible, and
the PathStatistics evaluation. A round starts while the window lasts; the
window ends when the last one completes. The configuration's "suite" block
sets the runner's options, which the traffic's "suite" block may override
(the CPU tests' small size). The traffic file sets:

    worlds            problems per suite
    followed_rounds, sample_from_first
                      how many rounds the check follows, drawn from the
                      seed among the window's first `sample_from_first`
    counted_rounds    the rounds whose final paths `attempted`, `failed`
                      and `feasible_frac` count: the window's first, so
                      that every run of a seed counts the same problems
    followed_steps    the steps (and pretraining iterations) of each
                      followed stretch
    path_off_m        the gap past which a followed path counts as off
    probe_poses       poses per problem at which the pretrained fields
                      are compared
    precaptured_failures
                      the restart rounds whose programs set-up captures

The check follows a round by wrapping, in that round only, the names the
runner and the tracked loop look up (`BatchPlanner`,
`batched_wavefront_trajectories`, `_shortcut_pass`, `shortcut_pairs`,
`TrackingCarry`, `evaluate_path`) and the planner's solver's `run` and
`_program` (the captured pretraining iteration), and keeps what they saw.
No reference reproduces this optimizer for long: f32 rounding alone moves
the program's paths and fields away from a reference in f32 within some
tens of steps, and within a few from a fresh start (PERF.md), so the
reference follows stretches of `followed_steps` from the program's own
state: the first chunk past `min_iterations` of the base solve and of the
restart round each run as a `run` of that many steps and a `run` of the
rest, and the pretraining's first and last iterations are read at its
captured iteration's calls. A traced run profiles one slice, from the entry of a
round's shortcut pass to the end of its restart round's second chunk, in
the first round from the window's second on whose base solve leaves a
problem for the restart round; the trace is reduced after the window.
"""
from __future__ import annotations

import math
import sys
import time
import types
from contextlib import contextmanager

import numpy as np
import torch

from nfbench.drivers import corridor_worlds
from nfbench.drivers import se2_port as se2
from nfbench.harness import core


def _clone(tree):
    """A copy of a tree of tensors (a program's outputs are its buffers,
    which the next replay overwrites)."""
    from nfopp_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().clone(), tree)


def _counter(module: str, name: str):
    """A counter dict of the program, or None where it has none."""
    import importlib

    return getattr(importlib.import_module(module), name, None)


class Driver:
    def __init__(self, cell, seed: int, device, spans, overrides: dict):
        self.cell = cell
        self.config = cell.config
        self.traffic = {**cell.traffic, **overrides}
        self.suite = {**cell.config["suite"], **self.traffic.get("suite", {})}
        self.seed = seed
        self.device = device
        self.spans = spans
        self.rounds: list = []  # (paths [B, M, 3] np, program's feasible [B] np)
        self.followed: dict = {}  # round -> what the check needs
        self.slice_records: list = []
        self.slice_steps = self.slice_lanes = None

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from nfopp_tpu_torch.bench import runner
        from nfopp_tpu_torch.utils import enable_compile_cache
        from nfopp_tpu_torch.worlds import GridScenario

        if self.device.type == "cuda":
            enable_compile_cache(self.device)
        sc, count = self.config["scene"], self.traffic["worlds"]
        t0 = time.perf_counter()
        # the suite users run: world i from seed i, its endpoints from its own seed
        walls = list(range(count))
        poses = [sc["endpoint_seed_offset"] + i for i in walls]
        self.worlds = corridor_worlds.build(walls, poses, sc["grid_cells"], sc["branches"],
                                            sc["radius_cells"], sc["min_geodesic"],
                                            sc["resolution"], sc["endpoint_clearance_cells"])
        self.build_s = time.perf_counter() - t0
        print(f"worlds built in {self.build_s:.3f} s", file=sys.stderr)
        self.scenarios = [GridScenario(grid, sc["resolution"], (0.0, 0.0), start, goal)
                          for grid, start, goal in self.worlds]
        self.parameters = program_parameters(self.config["solver"])
        self.runner = runner
        t1 = time.perf_counter()
        self.round(core.batch_seed(self.seed, 2 ** 30))
        self.sync()
        t2 = time.perf_counter()
        self.capture_restarts()
        print(f"warm-up round {t2 - t1:.3f} s, restart programs captured in "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
        rng = np.random.default_rng(core.batch_seed(self.seed, 2 ** 30 + 1))
        self.sampled = {int(i) for i in rng.choice(self.traffic["sample_from_first"],
                                                   self.traffic["followed_rounds"],
                                                   replace=False)}

    def capture_restarts(self) -> None:
        """The restart round's programs for 1 to `precaptured_failures`
        failed problems, captured as a sweep's earlier suites would have:
        an init and one chunk of that many lanes through the runner's own
        planner, solver and oracles."""
        from nfopp_tpu_torch.parallel import BatchPlanner
        from nfopp_tpu_torch.solver import ConstrainedSolver, config_from_parameters
        from nfopp_tpu_torch.utils.tree import tree_map
        from nfopp_tpu_torch.worlds import grid_collision

        s, sc = self.suite, self.config["scene"]
        if not s["aot"] or not s["restart_failed"]:
            return
        solver = ConstrainedSolver(config_from_parameters(self.parameters), grid_collision,
                                   device=self.device)
        planner = BatchPlanner(solver, aot_prefix="suite")
        oracles = self.runner._stack_oracles([w.oracle(sc["footprint_radius"], self.device)
                                              for w in self.scenarios])

        def rows(values):
            return torch.tensor(np.stack([np.asarray(v, np.float32) for v in values]),
                                device=self.device)

        starts, goals, bounds = (rows([getattr(w, k) for w in self.scenarios])
                                 for k in ("start", "goal", "bounds"))
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        for failed in range(1, self.traffic["precaptured_failures"] + 1):
            idx = torch.arange(failed, device=self.device).repeat_interleave(s["restart_failed"])
            lanes = tree_map(lambda x: x[idx], oracles)
            states = planner.init_batch(g, starts[idx], goals[idx], bounds[idx], lanes)
            planner.run(states, lanes, self.config["solver"]["reparametrize_trajectory_freq"], g)
        self.sync()

    def round(self, seed: int):
        s, sc = self.suite, self.config["scene"]
        return self.runner.run_grid_suite(
            self.scenarios, self.parameters, footprint_radius=sc["footprint_radius"],
            max_iterations=s["max_iterations"], min_iterations=s["min_iterations"],
            check_freq=s["check_freq"], stop_on_plateau=s["stop_on_plateau"],
            shortcut_trials=s["shortcut_trials"], restart_failed=s["restart_failed"],
            restart_rounds=s["restart_rounds"],
            require_native_evaluator=s["require_native_evaluator"], aot=s["aot"],
            device=self.device, seed=seed)

    # ------------------------------------------------------------- window

    def window(self, seconds: float, tracer) -> None:
        lanes, captures = (_counter("nfopp_tpu_torch.solver.tracking", "LANE_STEPS"),
                           _counter("nfopp_tpu_torch.utils.aot", "CAPTURES"))
        lanes0 = None if lanes is None else dict(lanes)
        captures0 = None if captures is None else dict(captures)
        self.slice = _Slice(tracer, self.spans) if tracer.enabled else None
        self.round_s, self.round_programs = [], []
        self.sync()
        t0 = time.perf_counter()
        deadline, k, last = t0 + seconds, 0, t0
        while time.perf_counter() < deadline:
            record = {} if k in self.sampled else None
            traced = self.slice is not None and k >= 1 and not self.slice.taken
            if record is None and not traced:
                result = self.round(core.batch_seed(self.seed, k))
            else:
                with Probe(self, record, self.slice if traced else None):
                    result = self.round(core.batch_seed(self.seed, k))
            self.done_at = time.perf_counter()
            self.round_s.append(self.done_at - last)
            last = self.done_at
            self.rounds.append((result.paths, result.feasible))
            events = result.log.settings["suite"].get("aot_events", [])
            self.round_programs.append([e["program"] for e in events
                                        if e["program"] != f"chunk-b{len(result.paths)}"
                                        and e["program"].startswith("chunk-b")]
                                       + [e["program"] for e in events if not e["loaded"]])
            if record is not None:
                record["result"] = (result.paths, result.feasible)
                self.followed[k] = record
            k += 1
        self.elapsed = self.done_at - t0
        if self.slice is not None:
            self.slice_records = self.slice.records
            if self.slice.taken:
                self.slice_steps, self.slice_lanes = self.slice.steps, self.slice.lanes
            self.slice.finish()
        self.lane_steps = None if lanes is None else (
            lanes["computed"] - lanes0["computed"], lanes["active"] - lanes0["active"])
        self.captures = None if captures is None else captures["programs"] - captures0["programs"]
        print("seconds per round", [round(x, 4) for x in self.round_s], file=sys.stderr)
        print("restart chunk and captures per round", self.round_programs, file=sys.stderr)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ metrics

    def reference_world(self, index=None) -> dict:
        ref = core.reference_module(self.config["reference"])
        if not hasattr(self, "_world"):
            sc = self.config["scene"]
            self._world = ref.grid_world([grid for grid, _, _ in self.worlds], sc["resolution"],
                                         sc["footprint_radius"], self.device)
        return self._world if index is None else ref.rows(self._world, index)

    def _reference_collides(self) -> np.ndarray:
        """The reference's collisions of every round's final paths."""
        if not hasattr(self, "_ref_collides"):
            ref = core.reference_module(self.config["reference"])
            samples = self.config["scene"]["feasibility_samples_per_segment"]
            world = self.reference_world()
            self._ref_collides = np.concatenate([
                ref.collides_and_length(world, torch.as_tensor(paths, device=self.device),
                                        samples)[0].cpu().numpy()
                for paths, _ in self.rounds]) if self.rounds else np.zeros(0, bool)
        return self._ref_collides

    def attempted_failed(self) -> tuple[int, int]:
        counted = self._reference_collides()[:self.traffic["counted_rounds"]
                                             * self.traffic["worlds"]]
        return int(counted.size), int(counted.sum())

    def end_to_end(self) -> dict:
        attempted, failed = self.attempted_failed()
        return {"solves_per_s": len(self.rounds) * self.traffic["worlds"] / self.elapsed,
                "feasible_frac": 100.0 * (attempted - failed) / attempted}

    def counters(self) -> dict:
        """The window's rounds and the program's counters; of the traced
        slice, the program's span records, the optimization steps run in it
        (the restart round's first two chunks) and the restart round's
        lanes."""
        return {"rounds": len(self.rounds), "lane_steps": self.lane_steps,
                "captures": self.captures, "slice_records": self.slice_records,
                "slice_steps": self.slice_steps, "restart_lanes": self.slice_lanes}

    # -------------------------------------------------------------- check

    def judge(self, candidate: str = "program") -> list:
        """The numbers compared and their limits, for the followed round: the
        largest gap between the program's wavefront paths and the
        reference's; the 90th percentile over the problems of the largest
        gap in occupancy probability, at seeded probe poses, between the
        program's field after each followed stretch of pretraining (its
        first and last `followed_steps` iterations) and the reference's run
        from the program's state before it with the same generator state;
        the path gaps after the followed stretches of the solves (the first
        `followed_steps` of the first chunk past `min_iterations`, of the
        base solve and of the restart round), each rerun likewise: the base
        solve's as a 90th percentile and as the share past `path_off_m`, the
        restart round's lanes as numbers of their own, a median (a fault
        that moves most lanes a little) and a 90th percentile (one that
        moves a share of them far), so that a fault confined to the few
        restart lanes is not outvoted by the base paths; the problems whose
        decision at any check, or whose final selection, differs from the
        reference's recomputation from the program's paths and carry; those
        whose shortcut result, or kept restart lane, differs from the
        reference's on the program's inputs; and every final path of the
        window whose feasibility the program and the reference read
        differently. `candidate` "control" puts the reference in TF32 in the
        program's place for the followed stretches."""
        ref = core.reference_module(self.config["reference"])
        limits, s = self.cell.limits, self.suite
        samples = self.config["scene"]["feasibility_samples_per_segment"]
        planner = ref.GridPlanner(self.config["solver"], self.device)
        control = ref.GridPlanner(self.config["solver"], self.device, "tf32")
        world = self.reference_world()
        numbers = {"wavefront_gap": 0.0, "pretrain_gap_p90": 0.0, "decision_mismatch": 0,
                   "shortcut_mismatch": 0, "restart_mismatch": 0}
        pretrain, restarted = [], False
        detail: dict = {"base": [], "restart": [], "pretrain_first": [], "pretrain_last": []}
        if not self.followed:
            numbers.update(wavefront_gap=math.inf, pretrain_gap_p90=math.inf)
        for k, record in sorted(self.followed.items()):
            numbers["wavefront_gap"] = max(numbers["wavefront_gap"],
                                           self.wavefront_gap(ref, record))
            pretrain.append(self.pretrain_gaps(ref, record, planner, control, candidate, k))
            if len(pretrain[-1]) > 1:
                first, last = pretrain[-1].chunk(2)
                detail["pretrain_first"].append(first)
                detail["pretrain_last"].append(last)
            solves = record.get("solves", [])
            for n, solve in enumerate(solves):
                lanes = None if n == 0 else record["lanes"]
                w = world if lanes is None else ref.rows(world, torch.as_tensor(
                    lanes, device=self.device))
                if "followed" in solve:
                    before, g_state, after = solve["followed"]
                    runs = {}
                    for name, who in (("reference", planner), ("control", control)):
                        if name == "reference" or candidate == "control":
                            g = torch.Generator(device=self.device)
                            g.set_state(g_state)
                            runs[name] = ref.se2.Planner.full_path(who.run(
                                se2.as_reference(before), g, w, self.traffic["followed_steps"]))
                    got = runs["control"] if candidate == "control" else after
                    detail["base" if n == 0 else "restart"].append(
                        se2.path_gaps(got, runs["reference"]).cpu())
                numbers["decision_mismatch"] += self.decision_mismatch(ref, solve, w, samples)
            for short in record.get("shortcuts", []):
                lanes = short["lanes"]
                w = world if lanes is None else ref.rows(world, torch.as_tensor(
                    lanes, device=self.device))
                want = ref.shortcut_pass(w, *short["in"], short["pairs"], samples)
                got = short["out"]
                off = np.abs(got[0].astype(np.float64) - want[0]).reshape(len(got[0]), -1)
                numbers["shortcut_mismatch"] += int(((got[2] != want[2])
                                                     | ~(off.max(axis=1) <= 1e-5)).sum())
            numbers["restart_mismatch"] += self.restart_mismatch(ref, record)
            # a problem still infeasible after the base shortcut wants a restart round
            restarted |= bool(s["restart_failed"]) and (
                "before_restart" not in record or not record["before_restart"][1].all())
        base = torch.cat(detail["base"]) if detail["base"] else torch.full((1,), math.inf)
        restart = (torch.cat(detail["restart"]) if detail["restart"]
                   else torch.full((1,), math.inf if restarted else 0.0))
        pretrain = torch.cat(pretrain) if pretrain else torch.full((1,), math.inf)
        collides = np.concatenate([~feasible for _, feasible in self.rounds])
        mismatch = int((collides != self._reference_collides()).sum())
        self.detail = {key: parts for key, parts in detail.items() if parts}
        return [("wavefront_gap", numbers["wavefront_gap"], limits["wavefront_gap"]),
                ("pretrain_gap_p90", se2.quantile(pretrain, 0.9), limits["pretrain_gap_p90"]),
                ("path_gap_p90", se2.quantile(base, 0.9), limits["path_gap_p90"]),
                ("paths_off_pct", se2.share_over(base, self.traffic["path_off_m"]),
                 limits["paths_off_pct"]),
                ("restart_gap_p50", se2.quantile(restart, 0.5), limits["restart_gap_p50"]),
                ("restart_gap_p90", se2.quantile(restart, 0.9), limits["restart_gap_p90"]),
                ("decision_mismatch", numbers["decision_mismatch"], limits["decision_mismatch"]),
                ("shortcut_mismatch", numbers["shortcut_mismatch"], limits["shortcut_mismatch"]),
                ("restart_mismatch", numbers["restart_mismatch"], limits["restart_mismatch"]),
                ("feasible_mismatch", mismatch, limits["feasible_mismatch"])]

    def wavefront_gap(self, ref, record) -> float:
        """The largest gap (m in x, y; rad in heading) between the program's
        wavefront paths and the reference's on the dilated grids."""
        if "wave" not in record:
            return math.inf
        if "wavefront_gap" in record:  # the same for every candidate
            return record["wavefront_gap"]
        got = record["wave"].double().cpu().numpy()
        occupancy = self.reference_world()["occupancy"].cpu().numpy()
        sc = self.config["scene"]
        want = np.stack([ref.wavefront(occupancy[b], start, goal, sc["resolution"], got.shape[1])
                         for b, (_, start, goal) in enumerate(self.worlds)])
        d = got - want
        d[..., 2] = (d[..., 2] + math.pi) % (2 * math.pi) - math.pi
        record["wavefront_gap"] = float(np.nan_to_num(np.abs(d), nan=math.inf).max())
        return record["wavefront_gap"]

    def pretrain_gaps(self, ref, record, planner, control, candidate, k) -> torch.Tensor:
        """[2 B] the largest gap per problem between the field's occupancy
        probability after each followed stretch of pretraining and the
        reference's, run from the program's field and optimizer state before
        it with the same generator state, at `probe_poses` seeded poses."""
        stretches = record.get("pretrain", [])
        if len(stretches) != 2 or "init" not in record or stretches[-1][2] is None:
            return torch.full((1,), math.inf)
        _, (_, _, bounds), _ = record["init"]
        probes = torch.Generator(device=self.device).manual_seed(
            core.batch_seed(self.seed, 2 ** 30 + 2 + k))
        u = torch.rand((bounds.shape[0], self.traffic["probe_poses"], 3), generator=probes,
                       device=self.device)
        poses = ref.se2.uniform_box(u, bounds)
        gaps = []
        for before, g_state, after in stretches:
            params, opt = before
            opt = {"count": opt.count, "mu": dict(opt.mu), "nu": dict(opt.nu)}
            runs = {}
            for name, who in (("reference", planner), ("control", control)):
                if name == "reference" or candidate == "control":
                    g = torch.Generator(device=self.device)
                    g.set_state(g_state)
                    runs[name] = who.pretrain_steps(dict(params), opt, bounds,
                                                    self.reference_world(), g,
                                                    self.traffic["followed_steps"])[0]
            got = runs["control"] if candidate == "control" else dict(after[0])
            d = planner.probability(got, poses) - planner.probability(runs["reference"], poses)
            gaps.append(torch.nan_to_num(d.abs().double(), nan=math.inf).amax(dim=1).cpu())
        return torch.cat(gaps)

    def decision_mismatch(self, ref, solve, world, samples: int) -> int:
        """Lanes whose collision, length, improvement, stop or carry at any
        check, whose frozen path moved, or whose final selection differs
        from the reference's recomputation from the program's paths and
        carry."""
        s = self.suite
        end_chunk = -(-s["max_iterations"] // s["check_freq"])
        carries, evals = solve["carries"], solve["evals"]
        bad = torch.zeros(len(carries[0]["done"]), dtype=torch.bool, device=self.device)
        previous = carries[0]["best_path"]
        for c, (path, collides, length) in enumerate(evals[:-1]):
            before, after = carries[c], carries[c + 1]
            want = ref.check(before, path, world, end_chunk, s["check_freq"],
                             s["min_iterations"], samples, s["stop_on_plateau"])
            bad |= (collides != want["collides"]) | ~((length - want["length"]).abs() <= 1e-4)
            bad |= (after["done"] != want["done"]) | (after["iterations"] != want["iterations"])
            bad |= (after["chunk"] != want["chunk"])
            bad |= ~((after["best_length"] == want["best_length"])
                     | ((after["best_length"] - want["best_length"]).abs() <= 1e-4))
            moved = (path != previous).reshape(len(path), -1).any(dim=1)
            bad |= ~want["active"] & moved
            previous = path
        if len(evals) != len(carries) or "result" not in solve:
            return int(bad.numel())  # a loop that did not run as the tracked loop runs
        final_path = evals[-1][0]
        path, length, feasible = ref.final_selection(
            carries[-1]["best_path"], carries[-1]["best_length"], final_path, world, samples,
            s["stop_on_plateau"])
        got = solve["result"]
        bad |= (got.path != path).reshape(len(path), -1).any(dim=1)
        bad |= ~((got.length - length).abs() <= 1e-4) & ~(got.length == length)
        bad |= got.feasible != feasible
        return int(bad.sum())

    def restart_mismatch(self, ref, record) -> int:
        """Failed problems whose final path and flag differ from the
        reference's choice over the program's restart lanes: the shortest
        feasible lane, or the path before the restart where none is (all of
        them where the restart round did not run)."""
        if "before_restart" not in record:  # no shortcut pass ran: nothing to follow
            return len(record["result"][1])
        paths, feasible = record["before_restart"]
        final_paths, final_feasible = record["result"]
        failed = np.where(~feasible)[0]
        if not len(failed):
            return 0
        if "lanes_out" not in record:
            return len(failed)
        r = self.suite["restart_failed"]
        lane_paths, lane_len, lane_feas = record["lanes_out"]
        total = len(failed) * r
        lane_paths = lane_paths[:total].reshape(len(failed), r, *paths.shape[1:])
        choice = ref.restart_choice(lane_feas[:total].reshape(len(failed), r),
                                    lane_len[:total].reshape(len(failed), r))
        bad = 0
        for j, b in enumerate(failed):
            want = paths[b] if choice[j] < 0 else lane_paths[j, choice[j]]
            bad += int(not np.array_equal(final_paths[b], want)
                       or bool(final_feasible[b]) != bool(choice[j] >= 0))
        return bad


def program_parameters(solver: dict):
    """The program's parameter tree (the reference's AttributeDict schema)
    for the configuration's solver, checked to resolve to every value the
    file states."""
    from nfopp_tpu_torch.solver import config_from_parameters
    from nfopp_tpu_torch.utils.config import AttributeDict

    onf = solver["onf"]
    schema = ("trajectory_length", "onf", "collision_lr", "collision_betas", "trajectory_lr",
              "trajectory_betas")
    parameters = AttributeDict(
        trajectory_length=solver["trajectory_length"],
        collision_model=AttributeDict(mean=onf["mean"], sigma=onf["sigma"],
                                      use_cos=onf["use_cos"], bias=onf["bias"],
                                      use_normal_init=onf["use_normal_init"],
                                      angle_encoding=onf["angle_encoding"], name="ONF"),
        collision_optimizer=AttributeDict(lr=solver["collision_lr"],
                                          betas=tuple(solver["collision_betas"])),
        trajectory_optimizer=AttributeDict(lr=solver["trajectory_lr"],
                                           betas=tuple(solver["trajectory_betas"])),
        planner=AttributeDict(name="ConstrainedNFOPPlanner",
                              **{k: v for k, v in solver.items() if k not in schema}))
    resolved = config_from_parameters(parameters)
    for key, value in solver.items():
        got = resolved.onf if key == "onf" else getattr(resolved, key)
        if key == "onf":
            differs = [k for k in value if k != "parameters"
                       and getattr(got, k) != value[k]]
        else:
            differs = [key] if (list(got) if isinstance(got, tuple) else got) != value else []
        if differs:
            raise ValueError(f"the program resolves {differs} of the configuration otherwise")
    return parameters


# ------------------------------------------------------------- the probe

class _Slice:
    """The traced slice of a run: started at a round's shortcut pass,
    dropped if that round leaves no problem for the restart round, ended
    after the restart round's second chunk; its trace is reduced after the
    window (`finish`)."""

    def __init__(self, tracer, spans):
        self.tracer, self.spans = tracer, spans
        self.taken = False
        self.records: list = []
        self.steps, self.lanes = 0, None  # optimization steps and restart lanes in the slice
        self._kept = None

    def start(self) -> None:
        from nfopp_tpu_torch.utils import profiling

        if hasattr(profiling, "clear_spans"):
            profiling.clear_spans()
        self.steps, self.lanes = 0, None
        self.tracer.start()

    def _close(self):
        torch.cuda.synchronize(self.tracer.device)
        self.tracer._range.__exit__(None, None, None)
        self.tracer._prof.__exit__(None, None, None)
        self.spans.tracing = False
        prof, self.tracer._prof = self.tracer._prof, None
        return prof

    def drop(self) -> None:
        if self.tracer.active:
            self._close()

    def end(self) -> None:
        """End the slice: the profile is kept for `finish`, and the
        program's span records of the slice are read now."""
        from nfbench.harness import program_spans

        self._kept = self._close()
        self.records = program_spans.program_records()
        self.taken = True

    def finish(self) -> None:
        """Reduce the kept profile as `Tracer.stop` does."""
        if self._kept is None:
            return
        kept = self._kept

        class Closed:
            def __exit__(self, *exc):
                return None

            def export_chrome_trace(self, path):
                kept.export_chrome_trace(path)

        self.tracer._prof, self.tracer._range = Closed(), Closed()
        self.tracer.stop()
        self._kept = None
        from nfbench.harness import program_spans

        ctx = types.SimpleNamespace(trace=self.tracer.trace, spans=self.spans)
        print("slice idle gaps by program span",
              program_spans.idle_gaps(ctx, 6, self.records), file=sys.stderr)


class Probe:
    """What `run_grid_suite` calls in one round, wrapped (restored on exit):
    with a `record`, what the check needs is kept in it; with a `slice`, the
    traced slice is started and ended at its points, with benchmark spans
    around the wrapped calls."""

    def __init__(self, driver, record: dict | None, slice_: _Slice | None):
        from nfopp_tpu_torch.solver import tracking

        self.driver, self.record, self.slice = driver, record, slice_
        self.runner, self.tracking = driver.runner, tracking
        self.solve = None  # the solve under way: its record
        self.solves = 0
        self.inits = 0
        self.run_calls = 0
        self.restart_lanes = None

    @contextmanager
    def _span(self, name: str):
        if self.slice is not None and self.slice.tracer.active:
            with self.driver.spans.span(name):
                yield
        else:
            yield

    def __enter__(self):
        runner, tracking, probe = self.runner, self.tracking, self
        originals = {"BatchPlanner": runner.BatchPlanner,
                     "batched_wavefront_trajectories": runner.batched_wavefront_trajectories,
                     "_shortcut_pass": runner._shortcut_pass,
                     "shortcut_pairs": runner.shortcut_pairs}
        loop = {"TrackingCarry": tracking.TrackingCarry, "evaluate_path": tracking.evaluate_path}
        self.saved = (originals, loop)

        class Planner(originals["BatchPlanner"]):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                solver, method = self.solver, type(self.solver).run
                program = solver._program

                def run(state, oracle, steps, noise):
                    return probe.on_run(method, solver, state, oracle, steps, noise)

                def captured(name, body, args, *key_parts):
                    return probe.on_program(name, program(name, body, args, *key_parts))

                solver.run = run
                if probe.record is not None:
                    solver._program = captured

            def init_batch(self, generator, starts, goals, bounds, oracles, trajectories=None):
                return probe.on_init(super().init_batch, generator, starts, goals, bounds,
                                     oracles, trajectories)

            def solve(self, *args, **kwargs):
                return probe.on_solve(super().solve, *args, **kwargs)

        def wavefront(*args):
            out = originals["batched_wavefront_trajectories"](*args)
            if probe.record is not None:
                probe.record["wave"] = out.detach().clone()
            return out

        def pairs(*args):
            out = originals["shortcut_pairs"](*args)
            probe.pairs = out.detach().clone()
            return out

        def shortcut(solver, oracles, paths, lengths, feasible, *args, **kwargs):
            return probe.on_shortcut(originals["_shortcut_pass"], solver, oracles, paths,
                                     lengths, feasible, *args, **kwargs)

        def carry(*args, **kwargs):
            made = loop["TrackingCarry"](*args, **kwargs)
            if probe.solve is not None:
                probe.solve["carries"].append(
                    {"best_length": made.best_length.clone(), "done": made.done.clone(),
                     "iterations": made.iterations.clone(), "chunk": made.chunk.clone(),
                     "best_path": made.best_path.clone()})
            return made

        def evaluate(oracle_fn, oracle_params, path, *args):
            collides, length = loop["evaluate_path"](oracle_fn, oracle_params, path, *args)
            if probe.solve is not None:
                probe.solve["evals"].append((path.clone(), collides.clone(), length.clone()))
            return collides, length

        for name, fn in (("BatchPlanner", Planner), ("batched_wavefront_trajectories", wavefront),
                         ("_shortcut_pass", shortcut), ("shortcut_pairs", pairs)):
            setattr(runner, name, fn)
        if self.record is not None:
            tracking.TrackingCarry = carry
            tracking.evaluate_path = evaluate
        return self

    def __exit__(self, *exc):
        originals, loop = self.saved
        for name, fn in originals.items():
            setattr(self.runner, name, fn)
        for name, fn in loop.items():
            setattr(self.tracking, name, fn)
        if self.slice is not None and not self.slice.taken:
            self.slice.drop()

    # the wrapped calls, in the order a round makes them

    def on_init(self, init, generator, starts, goals, bounds, oracles, trajectories):
        self.inits += 1
        g_state = generator.get_state()
        with self._span("restart.init" if self.inits > 1 else "init"):
            states = init(generator, starts, goals, bounds, oracles, trajectories)
        if self.inits > 1 and self.slice is not None and self.slice.tracer.active:
            self.slice.lanes = int(starts.shape[0])
        if self.record is not None and self.inits == 1:
            self.record["init"] = (g_state, (starts, goals, bounds), _clone(states))
        elif self.record is not None and "before_restart" in self.record:
            # the lanes, problem-major: `restart_failed` per problem still infeasible
            failed = np.where(~self.record["before_restart"][1])[0]
            self.record["lanes"] = np.repeat(failed, self.driver.suite["restart_failed"])
        return states

    def on_solve(self, solve, *args, **kwargs):
        self.solves += 1
        self.run_calls = 0
        if self.record is not None:
            self.solve = {"carries": [], "evals": []}
            self.record.setdefault("solves", []).append(self.solve)
        result = solve(*args, **kwargs)
        if self.solve is not None:
            self.solve["result"] = _clone(result)
            self.solve = None
        return result

    def on_program(self, name: str, program):
        """The pretraining's captured iteration, its first and last
        `followed_steps` calls of the base init followed."""
        if not name.startswith("pretrain") or self.inits != 1:
            return program
        total = self.driver.config["solver"]["init_collision_iteration"]
        n = self.driver.traffic["followed_steps"]
        stretches = self.record.setdefault("pretrain", [])
        calls = iter(range(total))

        def call(carry, bounds, oracle, generator):
            i = next(calls, total)
            if i in (0, total - n):
                stretches.append([_clone(carry), generator.get_state(), None])
            out = program(carry, bounds, oracle, generator)
            if i in (n - 1, total - 1) and stretches and stretches[-1][2] is None:
                stretches[-1][2] = _clone(out)
            return out

        return call

    def on_run(self, method, solver, state, oracle, steps, noise):
        s = self.driver.suite
        followed = s["min_iterations"] // s["check_freq"]
        n = self.driver.traffic["followed_steps"]
        with self._span("chunk"):
            if self.solve is not None and self.run_calls == followed and steps > n:
                # the followed stretch, then the rest of the chunk
                before = (_clone(state), noise.get_state())
                head = method(solver, state, oracle, n, noise)
                self.solve["followed"] = (*before,
                                          solver.full_trajectory(head[0]).detach().clone())
                tail = method(solver, head[0], oracle, steps - n, noise)
                out = (tail[0], type(tail[1])(*(torch.cat(pair, dim=1)
                                                 for pair in zip(head[1], tail[1]))))
            else:
                out = method(solver, state, oracle, steps, noise)
        self.run_calls += 1
        if self.slice is not None and self.slice.tracer.active:
            self.slice.steps += steps
        if (self.slice is not None and self.slice.tracer.active and self.solves == 2
                and self.run_calls == 2):
            self.slice.end()
        return out

    def on_shortcut(self, shortcut, solver, oracles, paths, lengths, feasible, *args, **kwargs):
        restart = self.solves > 1
        traced = (self.slice is not None and not restart and not self.slice.taken
                  and not feasible.all())
        if traced:
            self.slice.start()
        with self._span("shortcut"):
            out = shortcut(solver, oracles, paths, lengths, feasible, *args, **kwargs)
        if traced and out[2].all():
            self.slice.drop()  # no problem is left for the restart round
        if self.record is not None:
            kept = tuple(x.copy() for x in out)  # the runner writes into its arrays later
            lanes = self.record["lanes"] if restart else None
            if restart:
                self.record["lanes_out"] = kept[:3]
            else:
                self.record["before_restart"] = (kept[0], kept[2])
            self.record.setdefault("shortcuts", []).append(
                {"lanes": lanes, "pairs": self.pairs,
                 "in": (paths.copy(), lengths.copy(), feasible.copy()), "out": kept})
        return out
