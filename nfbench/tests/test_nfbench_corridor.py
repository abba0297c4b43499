"""The corridor cell's check on its restart round, and the reader of the
round's idle share.

A fault confined to the restart round (a few lanes for each problem the base
solve left infeasible) must be refused by the restart round's own numbers,
since pooled with the base solve's paths it would be outvoted. Each of the
four faults the cell's traffic lists is planted on `ConstrainedSolver.run`
only while the suite runner solves a restart round, at the small size on
the CPU and, marked `card`, at the cell's own size."""
import json
import subprocess
import sys

import pytest
import torch

from nfbench import faults
from nfbench.harness import core
from nfbench.tests import test_nfbench_program_spans as spans
from nfbench.tests.test_nfbench_runs import small_run
from nfopp_tpu_torch.utils.profiling import SpanRecord

CELL = "corridor-suite-256"
RESTART_NUMBERS = {"restart_gap_p50", "restart_gap_p90"}


def plant_in_restart(fault: str, patch=setattr) -> None:
    """`faults.FAULTS[fault]` on `ConstrainedSolver.run` while the suite
    runner's planner solves anything but its first batch of a round (the
    restart rounds); the sound `run` elsewhere."""
    from nfopp_tpu_torch.bench import runner
    from nfopp_tpu_torch.solver import ConstrainedSolver

    sound, broken, inside = ConstrainedSolver.run, {}, [False]
    faults.FAULTS[fault](lambda owner, name, value: broken.update({name: value}),
                         ConstrainedSolver, "run")

    def run(self, *args, **kwargs):
        return (broken["run"] if inside[0] else sound)(self, *args, **kwargs)

    class Planner(runner.BatchPlanner):
        def solve(self, *args, **kwargs):
            self.solves = getattr(self, "solves", 0) + 1
            inside[0] = self.solves > 1
            try:
                return super().solve(*args, **kwargs)
            finally:
                inside[0] = False

    patch(ConstrainedSolver, "run", run)
    patch(runner, "BatchPlanner", Planner)


def refused_by(checks: list) -> set:
    return {name for name, value, limit in checks if value > limit}


@pytest.mark.parametrize("fault", core.Cell.load(CELL).small["faults"])
def test_a_fault_in_the_restart_round_alone_is_refused(monkeypatch, fault):
    """The base solve stays sound, so only the restart round's numbers can
    refuse the run, and they do."""
    cell = core.Cell.load(CELL)
    plant_in_restart(cell.small["faults"][fault][0], monkeypatch.setattr)
    result, checks = small_run(CELL)
    assert result["correct"] is False, checks
    assert refused_by(checks) & RESTART_NUMBERS, checks
    assert not refused_by(checks) & {"path_gap_p90", "paths_off_pct"}, checks


@pytest.mark.card
@pytest.mark.parametrize("fault", core.Cell.load(CELL).small["faults"])
def test_a_fault_in_the_restart_round_alone_is_refused_at_the_cell_size(card, fault):
    """As above at the cell's own size on three seeds, each fault in a
    process of its own (a captured program outlives a later patch)."""
    cell = core.Cell.load(CELL)
    seeds = [107, 2 ** 31 + 9, 2 ** 40 + 13]
    code = ("import json, sys, torch\n"
            "from nfbench import readings\n"
            "from nfbench.harness import core\n"
            "from nfbench.tests.test_nfbench_corridor import plant_in_restart\n"
            f"plant_in_restart({cell.small['faults'][fault][0]!r})\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "core.cache_dirs()\n"
            f"for seed, _, numbers in readings.readings(core.Cell.load({CELL!r}), {seeds!r},\n"
            f"        {cell.small['card_seconds']!r}, torch.device('cuda', 0),\n"
            "        candidates=('program',)):\n"
            "    print(json.dumps({'seed': seed, **{k: v for k, v in numbers.items()\n"
            "                                       if k != 'detail'}}), flush=True)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    print(fault, lines)
    assert [line["seed"] for line in lines] == seeds
    for numbers in lines:
        assert {n for n in RESTART_NUMBERS if numbers[n] > cell.limits[n]}, (fault, numbers)


# ----------------------------------------------- device_idle.restart's reader

def restart_ctx(restart: tuple | None, traced: bool = True):
    """The hand-written slice of `test_nfbench_program_spans` with a
    `suite.restart` record (start, end or None while open) in trace us."""
    c = spans.ctx(traced=traced)
    records = spans.records()
    if restart is not None:
        lo, hi = restart

        def ns(us):
            return int(round(spans.host_s(us) * 1e9))

        records.append(SpanRecord(len(records), "suite.restart", None, ns(lo),
                                  None if hi is None else ns(hi), {}))
    c.counters["slice_records"] = records
    return c


def reader():
    return core.metric_reader("device_idle.restart").read


def test_restart_idle_runs_an_open_span_to_the_slice_s_end():
    """[400, 1000) us holds kernels for 60 + 390 us: 150 us idle of the
    slice's 1000."""
    assert reader()(restart_ctx((400.0, None))) == pytest.approx(15.0, abs=1e-3)


def test_restart_idle_of_a_closed_span():
    """[300, 500) us holds kernels for 50 + 60 us: 90 us idle."""
    assert reader()(restart_ctx((300.0, 500.0))) == pytest.approx(9.0, abs=1e-3)


@pytest.mark.parametrize("restart,traced", [(None, True), ((400.0, None), False)])
def test_restart_idle_reads_nothing_without_its_span_or_a_trace(restart, traced):
    assert reader()(restart_ctx(restart, traced)) is None


def test_restart_idle_reads_nothing_where_the_clocks_do_not_align():
    c = restart_ctx((400.0, None))
    c.spans.records = [(name, t0 + 1.0, t1 + 1.0) for name, t0, t1 in c.spans.records]
    assert reader()(c) is None
