"""The reduction of a traced slice and the per-layer readers, on a slice
written by hand."""
import types

import pytest

from nfbench.harness import core

KERNELS = [("void field_grad_f32_kernel<4>(Args)", 100.0, 50.0),
           ("void collision_bwd_f32_kernel(Args)", 150.0, 20.0),
           ("elementwise", 160.0, 20.0),  # overlaps the one before
           ("void field_grad_f32_kernel<4>(Args)", 300.0, 50.0)]
SPANS = [("init", 0.0, 120.0), ("chunk", 120.0, 300.0), ("evaluate", 420.0, 80.0)]


def trace():
    return core.Trace(list(KERNELS), list(SPANS), 0.0, 500.0)


def test_busy_idle_and_gaps():
    t = trace()
    assert t.intervals() == [[100.0, 180.0], [300.0, 350.0]]
    assert t.busy_s == pytest.approx(130e-6) and t.window_s == pytest.approx(500e-6)
    # each gap is named by the innermost span for most of it: 350-500 is
    # 70 us in chunk and 80 us in evaluate
    assert t.idle_gaps() == [["evaluate", pytest.approx(150e-6)],
                             ["chunk", pytest.approx(120e-6)],
                             ["init", pytest.approx(100e-6)]]
    assert t.kernel_time(["field_grad_f32_kernel"]) == (pytest.approx(100e-6), 2)
    assert t.top_kernels()[0] == ["void field_grad_f32_kernel<4>", pytest.approx(100e-6)]
    assert core.short_name("void (anonymous namespace)::k<float>(float*, int)") == \
        "void (anonymous namespace)::k<float>"


def ctx(**counters):
    cell = core.Cell.load("car-batch-256")
    return types.SimpleNamespace(trace=trace(), spans=core.Spans(), cell=cell, device=None,
                                 counters={"problems": 256, **counters},
                                 card="NVIDIA H100 80GB HBM3")


def test_a_gap_is_named_by_the_innermost_span():
    t = core.Trace([("k", 0.0, 10.0), ("k", 110.0, 10.0)],
                   [("cycle", 0.0, 200.0)] + [("postprocess", 20.0 + 10 * i, 8.0) for i in range(8)],
                   0.0, 120.0)
    assert t.idle_gaps() == [["postprocess", pytest.approx(100e-6)]]


def test_readers():
    c = ctx(slice_steps=2)
    idle = core.metric_reader("device_idle.solve").read(c)
    assert idle == pytest.approx(100 * (1 - 130 / 500))
    assert core.metric_reader("kernels_per_step").read(c) == 2.0
    # 0.1565 ms of bound over 0.05 ms per launch: the reader does not clip
    assert core.metric_reader("roofline.field_grad").read(c) == pytest.approx(313.0, rel=1e-3)
    mfu = core.metric_reader("step_mfu").read(c)
    assert mfu == pytest.approx(100 * 17151815680.0 * 2 / (500e-6 * 67e12))


def test_readers_find_nothing_to_read():
    c = ctx(slice_steps=0)
    c.trace = None
    for name in ("device_idle.solve", "kernels_per_step", "roofline.field_grad",
                 "roofline.collision_bwd", "step_mfu"):
        assert core.metric_reader(name).read(c) is None
