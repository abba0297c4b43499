"""What every cell shares: finding a cell's files by the names that
BENCHMARK.json gives, the benchmark's spans, the traced slice and its
reduction to busy time, kernel time and idle gaps, and the result line."""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass

BENCH = pathlib.Path(__file__).resolve().parent.parent  # nfbench/
ROOT = BENCH.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "nfopp_tpu")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workloads(spec: dict | None = None) -> list:
    """The name of every cell in BENCHMARK.json."""
    return [w["name"] for w in (load_spec() if spec is None else spec)["workloads"]]


def load_json(kind: str, name: str) -> dict:
    """nfbench/<kind>/<name>.json: a configuration, a traffic mix or a cell's
    limits."""
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(path: pathlib.Path, name: str):
    """A module of the benchmark from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"nfbench_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_module(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py", f"driver_{name}")


def reference_module(name: str):
    return load_module(BENCH / "reference" / f"{name}.py", f"reference_{name}")


def metric_reader(name: str):
    return load_module(BENCH / "layer_metrics" / f"{name}.py", f"metric_{name}")


@dataclass
class Cell:
    """One entry of `workloads`, with its configuration, traffic, limits and
    the metrics BENCHMARK.json gives it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, spec: dict | None = None) -> "Cell":
        spec = load_spec() if spec is None else spec
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
        w = cells[name]

        def mine(metric: dict) -> bool:
            return name in metric.get("workloads", [name])

        return cls(name, w["chips"], load_json("configs", w["config"]),
                   load_json("traffic", w["traffic"]), load_json("limits", name),
                   [m for m in spec["end_to_end"] if mine(m)],
                   [m for m in spec["per_layer"] if mine(m)])

    @property
    def small(self) -> dict:
        """The traffic's "small" block: `traffic` overrides that cut the mix
        to a size the CPU tests hold (the widths stay the configuration's),
        the window in `seconds` there and `card_seconds` on the card, each
        long enough for every followed unit to complete, and the `faults`
        the cell can have (`nfbench/faults.py`)."""
        return self.traffic["small"]


def batch_seed(seed: int, index: int) -> int:
    """A seed for unit `index` of a run seeded `seed` (any whole number)."""
    import numpy as np

    words = np.random.SeedSequence([seed % 2 ** 64, index]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


# ----------------------------------------------------------------- spans

class Spans:
    """The benchmark's own spans around its calls into the program: host
    times in memory, and under tracing a profiler range of the same name."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self.tracing = False

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.tracing:
            import torch

            with torch.profiler.record_function(f"nfbench.{name}"):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str, since: float = 0.0) -> tuple[float, int]:
        """(seconds, count) of the spans named `name` that began at `since` or later."""
        times = [t1 - t0 for n, t0, t1 in self.records if n == name and t0 >= since]
        return sum(times), len(times)


# ----------------------------------------------------------- the trace

@dataclass
class Trace:
    """The reduction of one traced slice: device kernels (name, start us,
    duration us), the benchmark's spans in it, and the slice's extent."""

    kernels: list
    spans: list
    start_us: float
    end_us: float

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def intervals(self) -> list:
        """The union of the kernels' device intervals, in order."""
        merged = []
        for _, ts, dur in sorted(self.kernels, key=lambda k: k[1]):
            lo, hi = max(ts, self.start_us), min(ts + dur, self.end_us)
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.intervals()) / 1e6

    def kernel_time(self, patterns) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds one of
        `patterns`."""
        hits = [dur for name, _, dur in self.kernels if any(p in name for p in patterns)]
        return sum(hits) / 1e6, len(hits)

    def top_kernels(self, count: int = 10) -> list:
        by_name: dict = {}
        for name, _, dur in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
        return [[short_name(name), us / 1e6] for name, us in top]

    def idle_gaps(self, count: int = 10) -> list:
        """The longest gaps between device work in the slice, each named by
        what the host spent most of it in: the innermost benchmark span."""
        edges = [self.start_us] + [x for iv in self.intervals() for x in iv] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_during(lo, hi), (hi - lo) / 1e6] for lo, hi in gaps[:count]]

    def host_during(self, lo: float, hi: float) -> str:
        """The span name that is innermost on the host for the largest part
        of [lo, hi) ("outside" where no span is open)."""
        inside = [(ts, ts + dur, name) for name, ts, dur in self.spans
                  if ts < hi and ts + dur > lo]
        cuts = sorted({lo, hi} | {t for a, b, _ in inside for t in (a, b) if lo < t < hi})
        time_in: dict = {}
        for a, b in zip(cuts, cuts[1:]):
            open_ = [(e - s, name) for s, e, name in inside if s <= a and e >= b]
            name = min(open_)[1] if open_ else "outside"
            time_in[name] = time_in.get(name, 0.0) + (b - a)
        return max(time_in, key=time_in.get)


def short_name(kernel: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters."""
    name = kernel.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:120]


class Tracer:
    """One traced slice of a run: `start()` and `stop()` bracket it, and the
    trace goes to a file under TMPDIR that is read and deleted at once."""

    def __init__(self, enabled: bool, spans: Spans, device):
        self.enabled = enabled and device.type == "cuda"
        self.spans = spans
        self.device = device
        self.trace: Trace | None = None
        self._prof = None

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self.trace is not None:
            return
        import torch

        torch.cuda.synchronize(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.spans.tracing = True
        self._range = torch.profiler.record_function("nfbench.slice")
        self._range.__enter__()

    def warm(self) -> None:
        """Start the profiler once around a small kernel, so that its own
        start-up (CUPTI) falls in the set-up and not in the window."""
        if not self.enabled:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.spans.tracing = False
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        self._prof = None
        kernels, spans, extent = [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            if e.get("cat") == "kernel":
                kernels.append((e["name"], float(e["ts"]), float(e["dur"])))
            elif e.get("cat") == "user_annotation" and e["name"].startswith("nfbench."):
                name = e["name"][len("nfbench."):]
                if name == "slice":
                    extent = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                else:
                    spans.append((name, float(e["ts"]), float(e["dur"])))
        if extent is None or not kernels:
            raise RuntimeError("the trace holds no slice or no kernel events: device time "
                               "not measured")
        self.trace = Trace(kernels, spans, extent[0], extent[1])


# ------------------------------------------------------------ the guard

def forbidden_modules() -> list:
    """Top-level names in sys.modules, compared whole, that the run must not
    have loaded."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = BENCH / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
