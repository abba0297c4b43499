"""The port's host utilities (nfopp_tpu_torch.utils: Position2,
UniversalFactory, Timer, profiling) against the JAX package's
(tests/test_utils.py), on the CPU: the same poses bit for bit, the same
factory answers, and the timers over CPU tensors."""
import json

import numpy as np
import pytest
import torch

from nfopp_tpu.utils import Position2 as JaxPosition2
from nfopp_tpu.utils import Timer as JaxTimer
from nfopp_tpu.utils import UniversalFactory as JaxFactory
from nfopp_tpu_torch.utils import Position2, Timer, UniversalFactory, profiling, timer
from torch_threads import one_thread  # noqa: F401


def poses(rng, n=5):
    return rng.randn(n), rng.randn(n), rng.uniform(-np.pi, np.pi, n)


class TestPosition2:
    def test_algebra_equals_jax(self):
        rng = np.random.RandomState(1)
        a, b = poses(rng), poses(rng)
        p, q = Position2(*a), Position2(*b)
        jp, jq = JaxPosition2(*a), JaxPosition2(*b)
        for got, want in ((p * q, jp * jq), (p.inv(), jp.inv()), (p * p.inv(), jp * jp.inv()),
                          (Position2.global_from_local(p, q),
                           JaxPosition2.global_from_local(jp, jq))):
            np.testing.assert_array_equal(got.as_vec(), want.as_vec())
        points = rng.randn(7, 2)
        np.testing.assert_array_equal(Position2(1.0, 2.0, 0.7).apply(points),
                                      JaxPosition2(1.0, 2.0, 0.7).apply(points))
        np.testing.assert_array_equal(p.as_quaternion(), jp.as_quaternion())
        np.testing.assert_array_equal(p.translation, jp.translation)
        assert len(p) == len(jp) == 5 and len(Position2.identity()) == 1

    def test_constructors_equal_jax(self):
        vec = np.array([[1.0, 2.0, 0.3], [4.0, 5.0, -1.2]])
        np.testing.assert_array_equal(Position2.from_vec(vec).as_vec(),
                                      JaxPosition2.from_vec(vec).as_vec())
        np.testing.assert_array_equal(Position2.from_vec(vec[0]).as_vec(), vec[0])
        items = Position2.from_vec(vec).as_array()
        assert [repr(x) for x in items] == [repr(x) for x in JaxPosition2.from_vec(vec).as_array()]
        np.testing.assert_array_equal(Position2.from_array(items).as_vec(), vec)
        q = Position2(0.0, 0.0, 1.234).as_quaternion()
        assert Position2.from_quaternion(0.0, 0.0, *q).rotation == pytest.approx(1.234, abs=1e-9)
        assert (Position2.from_quaternion(1.0, 2.0, *q).as_vec()
                == JaxPosition2.from_quaternion(1.0, 2.0, *q).as_vec()).all()

    def test_compose_inverse_identity(self):
        rng = np.random.RandomState(1)
        p = Position2(*poses(rng))
        ident = p * p.inv()
        np.testing.assert_allclose(ident.as_vec(), 0, atol=1e-9)


class TestFactory:
    def classes(self):
        class Inner:
            def __init__(self, value):
                self.value = value

        class Outer:
            def __init__(self, inner, runtime, size=3):
                self.inner, self.runtime, self.size = inner, runtime, size

        return [Inner, Outer]

    @pytest.mark.parametrize("parameters, extra", [
        ({"name": "Outer", "inner": {"name": "Inner", "value": 5}, "junk": 9}, {"runtime": "R"}),
        ({"type": "Outer", "inner": {"type": "Inner", "value": 1}, "size": 7,
          "runtime": "config"}, {"runtime": "wins", "unknown": 0}),
        ({"name": "Inner", "value": [1, 2]}, {}),
    ])
    def test_builds_what_jax_s_builds(self, parameters, extra):
        got = UniversalFactory(self.classes()).make_from_parameters(parameters, **extra)
        want = JaxFactory(self.classes()).make_from_parameters(parameters, **extra)

        def fields(obj):
            return {k: fields(v) if hasattr(v, "__dict__") else v for k, v in vars(obj).items()}

        assert type(got).__name__ == type(want).__name__
        assert fields(got) == fields(want)

    def test_errors_and_registration_equal_jax(self):
        for factory in (UniversalFactory([]), JaxFactory([])):
            with pytest.raises(KeyError):
                factory.make_from_parameters({"name": "Nope"})
            with pytest.raises(ValueError):
                factory.make_from_parameters({"value": 1})
            factory.register(self.classes()[0])
            assert factory.names() == ["Inner"]


class TestTimer:
    def test_collects_what_jax_s_collects(self):
        ours, theirs = Timer(), JaxTimer()
        for t in (ours, theirs):
            for label in ("a", "b", "a"):
                t.tick(label)
                assert t.tock(label) >= 0
        assert {k: v[2] for k, v in ours.stats().items()} == {
            k: v[2] for k, v in theirs.stats().items()} == {"a": 2, "b": 1}
        ours.reset()
        assert ours.stats() == {}

    def test_tock_takes_a_cpu_tensor(self, capsys):
        t = Timer()
        t.tick("mm")
        x = torch.randn(64, 64)
        duration = t.tock("mm", sync=x @ x)
        assert duration >= 0
        t.print()
        assert "mm:" in capsys.readouterr().out

    def test_module_timer_is_a_timer(self):
        assert isinstance(timer, Timer)


class TestProfiling:
    def test_timed_call_returns_the_median_and_the_result(self):
        calls = []

        def fn(x):
            calls.append(1)
            return x * 2

        seconds, result = profiling.timed_call(fn, torch.ones(4), warmup=2, iters=3)
        assert seconds >= 0 and torch.equal(result, torch.full((4,), 2.0))
        assert len(calls) == 5

    def test_steps_per_second(self):
        rate = profiling.steps_per_second(lambda s, k: s + k, torch.zeros(3), 1.0, steps=50)
        assert rate > 0

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path / "prof")) as out:
            torch.randn(32, 32).sum()
        trace = json.loads((out / "trace.json").read_text())
        assert trace["traceEvents"]
