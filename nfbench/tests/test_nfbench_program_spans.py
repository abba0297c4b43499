"""The program's spans in a traced slice (`nfbench/harness/program_spans.py`)
and the readers over them, on a slice and program records written by hand:
the clocks' alignment through the benchmark's spans, each reader's value,
the idle split adding up to `device_idle.solve`, and nothing read without a
trace or without program spans."""
import types

import pytest

from nfbench.harness import core, program_spans
from nfopp_tpu_torch.utils.profiling import SpanRecord

OFFSET_US = 7.25e9  # trace us minus host us
# the slice [0, 1000) us: batch 0's last call, its evaluation, batch 1's
# init and first call; kernels busy 700 of its 1000 us
KERNELS = [("k", 50.0, 200.0), ("k", 330.0, 50.0), ("k", 420.0, 60.0), ("k", 560.0, 390.0)]
BENCH = [("chunk", 10.0, 285.0), ("evaluate", 320.0, 82.0), ("init", 410.0, 92.0),
         ("chunk", 510.0, 478.0)]
# the program's spans on the trace's clock: (name, parent index, start, end)
PROGRAM = [("run", None, 20.0, 290.0), ("sync", 0, 20.0, 45.0), ("program", 0, 45.0, 48.0),
           ("replay", 0, 48.0, 52.0), ("run.outputs", 0, 280.0, 290.0),
           ("evaluate", None, 330.0, 340.0), ("init", None, 415.0, 470.0),
           ("run", None, 520.0, 985.0), ("sync", 7, 520.0, 540.0), ("program", 7, 540.0, 545.0),
           ("replay", 7, 545.0, 555.0), ("run.outputs", 7, 970.0, 980.0)]
STEPS = 20


def host_s(trace_us: float, offset_us: float = OFFSET_US) -> float:
    return (trace_us - offset_us) / 1e6


def host_records(jitter_us: float = 0.0, offset_us: float = OFFSET_US) -> list:
    """The benchmark's host records: an earlier batch with the same names
    (which the alignment must not take), then the slice's, each read
    `jitter_us` before its profiler range opens and after it closes."""
    earlier = [(name, host_s(ts - 5000.0, offset_us), host_s(ts + dur - 5000.0, offset_us))
               for name, ts, dur in BENCH]
    return earlier + [(name, host_s(ts, offset_us) - jitter_us / 1e6,
                       host_s(ts + dur, offset_us) + jitter_us / 1e6) for name, ts, dur in BENCH]


def records(offset_us: float = OFFSET_US, jitter_us: float = 0.0) -> list:
    """The program's records, read as the benchmark's are."""
    def ns(trace_us: float, late_us: float) -> int:
        return int(round((host_s(trace_us, offset_us) + late_us / 1e6) * 1e9))

    return [SpanRecord(i, name, parent, ns(lo, -jitter_us), ns(hi, jitter_us), {})
            for i, (name, parent, lo, hi) in enumerate(PROGRAM)]


def ctx(jitter_us: float = 0.0, traced: bool = True, offset_us: float = OFFSET_US):
    spans = core.Spans()
    spans.records = host_records(jitter_us, offset_us)
    trace = core.Trace(list(KERNELS), list(BENCH), 0.0, 1000.0) if traced else None
    return types.SimpleNamespace(trace=trace, spans=spans, cell=core.Cell.load("car-batch-256"),
                                 device=None, counters={"problems": 256, "slice_steps": STEPS},
                                 card="NVIDIA H100 80GB HBM3")


@pytest.fixture
def program(monkeypatch):
    """The hand-written records as what the program recorded."""
    monkeypatch.setattr(program_spans, "program_records", lambda: records())


@pytest.mark.parametrize("jitter_us", [0.0, 12.0, 80.0])
def test_the_clocks_align_through_the_benchmark_s_spans(jitter_us):
    """Opening and closing a range costs `jitter_us` on both sides: the
    offsets at a range's opening and at its closing differ by it."""
    c = ctx(jitter_us)
    offsets = program_spans.offsets_us(c.trace.spans, c.spans.records, records())
    assert offsets == (pytest.approx(OFFSET_US + jitter_us, abs=1e-3),
                       pytest.approx(OFFSET_US - jitter_us, abs=1e-3))
    placed = program_spans.slice_spans(c, records(jitter_us=jitter_us))
    assert [p[1] for p in placed] == [name for name, *_ in PROGRAM]
    for p, (_, _, lo, hi) in zip(placed, PROGRAM):
        assert p[3] == pytest.approx(lo, abs=1e-3) and p[4] == pytest.approx(hi, abs=1e-3)


@pytest.mark.parametrize("offset_us", [0.0, -3.3e6, 1.7e12])
def test_a_known_offset_of_the_clocks_is_found(offset_us):
    c = ctx(offset_us=offset_us)
    found = program_spans.offsets_us(c.trace.spans, c.spans.records, records(offset_us))
    assert found == (pytest.approx(offset_us, abs=1e-3), pytest.approx(offset_us, abs=1e-3))
    split = program_spans.idle_split(c, records(offset_us))
    assert split["run_loop"] == pytest.approx(14.5, abs=1e-3)
    # the program's records 2.5 ms later on the host: no run of the
    # benchmark's spans with the slice's names holds them
    assert program_spans.slice_spans(c, records(offset_us - 2500.0)) is None


@pytest.mark.parametrize("spread_us", [40.0, 60.0])
def test_an_alignment_past_50_us_is_refused(spread_us):
    """The slice's host records read alternately `spread_us` early and late
    (the first early, the last late, so they still hold the program's
    records): a median residual of `spread_us` about the offsets."""
    c = ctx()
    late = [0.0] * len(BENCH) + [(-1) ** (i + 1) * spread_us / 1e6 for i in range(len(BENCH))]
    c.spans.records = [(name, t0 + d, t1 + d) for (name, t0, t1), d in zip(c.spans.records, late)]
    found = program_spans.offsets_us(c.trace.spans, c.spans.records, records())
    assert (found is None) == (spread_us > program_spans.MAX_RESIDUAL_US)
    assert (program_spans.idle_split(c, records()) is None) == (found is None)
    assert program_spans.offsets_us([], ctx().spans.records, records()) is None


def test_the_readers(program):
    c = ctx()
    read = {name: core.metric_reader(name).read(c) for name in (
        "host_syncs_per_step", "replays_per_step", "device_idle.run_loop",
        "device_idle.off_program", "device_idle.solve")}
    assert read["host_syncs_per_step"] == pytest.approx(2 / STEPS)
    assert read["replays_per_step"] == pytest.approx(2 / STEPS)
    # idle under run: 20-50, 250-290, 520-560, 950-985 us
    assert read["device_idle.run_loop"] == pytest.approx(14.5)
    # idle with no program span open: 0-20, 290-330, 380-415, 480-520, 985-1000
    assert read["device_idle.off_program"] == pytest.approx(15.0)
    assert read["device_idle.solve"] == pytest.approx(30.0)


def test_the_idle_split_adds_up_to_device_idle_solve():
    c = ctx()
    split = program_spans.idle_split(c, records())
    assert split == {"run_loop": pytest.approx(14.5), "off_program": pytest.approx(15.0),
                     "init": pytest.approx(0.5)}
    solve = core.metric_reader("device_idle.solve").read(c)
    assert sum(split.values()) == pytest.approx(solve, abs=1e-9)


def test_each_gap_is_named_by_the_innermost_program_span():
    gaps = program_spans.idle_gaps(ctx(), records=records())
    # 0-50: 25 us in sync against 20 outside; 250-330: 40 outside, 30 in
    # run, 10 in run.outputs; 480-560: 40 outside, 20 in sync
    assert gaps[0][0] == "outside" and gaps[0][1] == pytest.approx(80e-6)
    assert gaps[0][2] == pytest.approx(250.0)
    assert [g[0] for g in gaps] == ["outside", "outside", "sync", "run", "outside"]
    assert sum(g[1] for g in gaps) == pytest.approx(300e-6)


def test_nothing_is_read_without_a_trace_or_program_spans(program, monkeypatch):
    names = ("host_syncs_per_step", "replays_per_step", "device_idle.run_loop",
             "device_idle.off_program")
    for name in names:
        assert core.metric_reader(name).read(ctx(traced=False)) is None
    # a program that records no spans (or has no recorder) reads nothing
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    for name in names:
        assert core.metric_reader(name).read(ctx()) is None
