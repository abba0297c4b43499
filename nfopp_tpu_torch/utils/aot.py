"""Captured programs: a function run as one CUDA graph (the counterpart of
`nfopp_tpu/utils/aot.py`).

In the JAX package a solve runs as one compiled XLA program, and
`aot_or_compile` gets that program onto the chip without paying for its
compile: it loads a serialized executable stored under a content key, or
compiles and stores one. The port's counterpart of "this solve runs as one
program that is already built" is a function captured into a
`torch.cuda.CUDAGraph` over static input buffers and replayed: one graph
launch in place of the hundreds of kernel launches, and the host work around
them, of its eager run.

The keys keep JAX's semantics: `aot_key(name, *parts)` over the torch and
CUDA versions, the device name and count, the Python version,
`source_digest()` (every `nfopp_tpu_torch/**/*.py` and `kernels/csrc/*`) and
the caller's parts; `shape_digest` for a program's arguments (structure,
shapes, dtypes, devices), `content_digest` for constants it closes over.

`aot_or_compile(name, fn, example_args, *key_parts)` on CUDA warms `fn` up
twice on a side stream on clones of the arguments, the second time under
`torch.cuda.set_sync_debug_mode("error")` (a host sync in `fn` raises there,
naming the op), captures it on that stream over
static copies of them, and returns a program that copies new arguments into
those buffers, replays the graph and returns the static outputs (which the
next replay overwrites). Programs are kept in the process by key: a second
request with the same key returns the stored program with `loaded=True`. A
failed capture raises; nothing on the card falls back to eager. Given CPU
tensors (the caller asked for the CPU) it returns `fn` itself with
`loaded=False`, as JAX's does on a CPU backend.

- A `torch.Generator` among the arguments (top level) is an argument like a
  tensor: the program holds a private generator on its device, registered
  with the graph; each replay copies the caller's generator state in and the
  advanced state back, so the caller's generator ends where the eager run
  would leave it. A CPU generator draws on the host and cannot be captured:
  the capture refuses it.
- The kernels' launch counters (`kernels.LAUNCHES`) count in Python, so they
  see the capture only: the program records the launches it captured, adds
  them on each replay, and counts none of the warm-up's.
- The graph reads what `fn` closes over (a solver's constant tensors) at the
  addresses it had at capture, so a program keeps `fn` alive: a stored
  program replayed for another solver of the same key (its constants equal
  by the key) after the capturing solver is gone reads live memory.
- A step of `fn` that must run on the host, such as a collective over gloo
  (`between_replays(x, step)`), splits the program into segments: the
  capture ends a graph where `fn` reaches it and begins the next, all in
  one memory pool. A replay runs the first graph, then for each such step
  `step` on the buffer the graph before it wrote, copies the result into
  the fixed buffer the graph after it reads, and runs that graph: one host
  step each, in the eager order. The warm-ups skip the step (they return
  `x`), so a capture makes no collective. Without such a step a program is
  one graph.

No counterpart: JAX's `save_aot`, `try_load_aot` and `aot_path`. A CUDA
graph holds device addresses of its process and cannot outlive it. What
persists across processes is the content-keyed kernel library
(`kernels/build.py::library_path`), which `utils/compile_cache.py` builds and
loads before any timed work.
"""
from __future__ import annotations

import contextlib
import hashlib
import pathlib
import sys
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import profiling
from .tree import tree_leaves, tree_map

__all__ = [
    "AotProgram",
    "aot_key",
    "aot_or_compile",
    "between_replays",
    "content_digest",
    "shape_digest",
    "source_digest",
]

_PACKAGE = pathlib.Path(__file__).resolve().parents[1]
_SOURCE_DIGEST_CACHE: str | None = None
# the programs captured in this process, by key (JAX's on-disk store)
_PROGRAMS: dict[str, "AotProgram"] = {}
# while `_capture` runs `fn`: what `between_replays` does there
_CAPTURING: "_Segments | None" = None


def source_digest() -> str:
    """Digest of the port's own sources (every nfopp_tpu_torch/**/*.py and
    kernels/csrc/*, path and contents), mixed into every key so that an edit
    of the code never serves a program captured from the old one. Cached per
    process."""
    global _SOURCE_DIGEST_CACHE
    if _SOURCE_DIGEST_CACHE is None:
        h = hashlib.sha256()
        files = sorted(_PACKAGE.rglob("*.py")) + sorted((_PACKAGE / "kernels" / "csrc").iterdir())
        for path in files:
            h.update(str(path.relative_to(_PACKAGE)).encode())
            h.update(path.read_bytes())
        _SOURCE_DIGEST_CACHE = h.hexdigest()[:16]
    return _SOURCE_DIGEST_CACHE


def _values(tree: Any) -> list:
    """Tensors, arrays and numbers of a tree (dicts, tuples, lists) in order."""
    if isinstance(tree, dict):
        return [v for k in tree for v in _values(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for x in tree for v in _values(x)]
    return [tree] if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, int, float)) else []


def content_digest(tree: Any) -> str:
    """Digest of a tree's contents (shapes, dtypes, bytes of its tensors and
    arrays): for constants a program closes over, whose values it bakes in."""
    h = hashlib.sha256()
    for leaf in _values(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            h.update(f"{tuple(t.shape)}{t.dtype}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            arr = np.asarray(leaf)
            h.update(f"{arr.shape}{arr.dtype}".encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def _structure(tree: Any) -> str:
    if isinstance(tree, torch.Tensor):
        return f"T{tuple(tree.shape)}{tree.dtype}{tree.device}"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_structure(v)}" for k, v in tree.items()) + "}"
    if isinstance(tree, (tuple, list)):
        return f"{type(tree).__name__}(" + ",".join(_structure(x) for x in tree) + ")"
    return type(tree).__name__


def shape_digest(tree: Any) -> str:
    """Digest of a tree's structure and its tensors' shapes, dtypes and
    devices, not their values: for a program's arguments."""
    return hashlib.sha256(_structure(tree).encode()).hexdigest()[:16]


def aot_key(name: str, *signature_parts) -> str:
    """`name` + a digest of the torch and CUDA versions, the device name and
    count, the Python version, the source digest and the parts (each by its
    repr: a NamedTuple config gives its full contents)."""
    cuda = torch.cuda.is_available()
    ident = "|".join([
        name,
        torch.__version__,
        str(torch.version.cuda),
        torch.cuda.get_device_name(0) if cuda else "cpu",
        str(torch.cuda.device_count() if cuda else 0),
        f"py{sys.version_info.major}.{sys.version_info.minor}",
        source_digest(),
        *[repr(p) for p in signature_parts],
    ])
    return f"{name}-{hashlib.sha256(ident.encode()).hexdigest()[:16]}"


class AotProgram(NamedTuple):
    """A program and its provenance (see aot_or_compile)."""

    fn: Callable  # call with the full argument list
    loaded: bool  # True = taken from this process's store (capture bypassed)
    seconds: float  # wall time of the lookup or of the warm-up and capture
    key: str

    def __call__(self, *args):
        return self.fn(*args)


def between_replays(x: torch.Tensor, step: Callable[[torch.Tensor], torch.Tensor]
                    ) -> torch.Tensor:
    """`step(x)`, a step on the host (a collective over gloo) inside a
    function that may be captured: run as is outside a capture; inside one,
    the program's segment ends here and each replay runs `step` between
    this segment and the next (see the module)."""
    return step(x) if _CAPTURING is None else _CAPTURING.split(x, step)


class _Segments:
    """The graphs of one capture, split at its host steps: a step's input
    buffer (written by the graph before it), the step, and the fixed buffer
    its result goes to (read by the graph after it)."""

    def __init__(self, generators: list, pool):
        self.generators, self.pool = generators, pool
        self.graphs: list = []
        self.steps: list = []
        self.warming = True
        self.capturing = False

    def begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        graph.capture_begin(pool=self.pool)
        self.graphs.append(graph)
        self.capturing = True

    def end(self) -> None:
        self.capturing = False
        self.graphs[-1].capture_end()

    def split(self, x: torch.Tensor, step: Callable) -> torch.Tensor:
        if self.warming:
            return x
        self.end()
        result = torch.empty_like(x)
        self.steps.append((x, step, result))
        self.begin()
        return result

    def replay(self) -> None:
        self.graphs[0].replay()
        for (x, step, result), graph in zip(self.steps, self.graphs[1:]):
            result.copy_(step(x))
            graph.replay()


def _device(args: tuple) -> torch.device:
    """The device of the arguments' first tensor (CPU without one)."""
    leaves = [leaf for arg in args for leaf in tree_leaves(arg)]
    return leaves[0].device if leaves else torch.device("cpu")


def aot_or_compile(
    name: str,
    fn: Callable,
    example_args: tuple,
    *key_parts,
    enabled: bool = True,
    verbose: bool = False,
) -> AotProgram:
    """The stored program of (`name`, key_parts), or `fn` captured on
    `example_args` and stored: the caller passes what the program depends
    on beyond its arguments' shapes (configs, sizes, `content_digest` of
    constants). `enabled=False` bypasses the store (a fresh capture, not
    kept). On the CPU, `fn` itself."""
    key = aot_key(name, *key_parts)
    device = _device(example_args)
    if device.type != "cuda":
        return AotProgram(fn, False, 0.0, key)
    t0 = time.perf_counter()
    if enabled and key in _PROGRAMS:
        program = _PROGRAMS[key]._replace(loaded=True, seconds=time.perf_counter() - t0)
        if verbose:
            print(f"program {name} taken from the store", file=sys.stderr, flush=True)
        return program
    with profiling.span("capture", program=name):
        program = AotProgram(_capture(fn, example_args, device), False, 0.0, key)
    program = program._replace(seconds=time.perf_counter() - t0)
    if enabled:
        _PROGRAMS[key] = program
    if verbose:
        print(f"program {name} captured in {program.seconds:.2f}s", file=sys.stderr, flush=True)
    return program


def _static_copy(arg: Any, device: torch.device) -> Any:
    """A private generator for a generator argument, clones for a tree of
    tensors (each checked to be on the program's device)."""
    if isinstance(arg, torch.Generator):
        if arg.device.type != "cuda":
            raise ValueError(
                "a captured program draws its noise on the card and cannot take a CPU "
                "torch.Generator: pass torch.Generator(device='cuda') (seeded) instead"
            )
        return torch.Generator(device=arg.device)
    for leaf in tree_leaves(arg):
        if leaf.device != device:
            raise ValueError(f"a captured program's arguments live on {device}; got a tensor "
                             f"on {leaf.device}")
    return tree_map(torch.clone, arg)


def _capture(fn: Callable, example_args: tuple, device: torch.device) -> Callable:
    """Warm `fn` up on clones, capture it over static copies of the
    arguments (in segments where it reaches `between_replays`) and return
    the replaying program."""
    global _CAPTURING
    from ..kernels.common import LAUNCHES

    static = tuple(_static_copy(arg, device) for arg in example_args)
    generators = [(i, g) for i, g in enumerate(static) if isinstance(g, torch.Generator)]
    counted = dict(LAUNCHES)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    segments = _Segments([g for _, g in generators], torch.cuda.graph_pool_handle())
    sync_mode = torch.cuda.get_sync_debug_mode()
    _CAPTURING = segments
    try:
        with torch.cuda.stream(stream):
            # the first call may build what the body's ops build once and keep
            # (device constants copied from the host, the kernel library); in
            # the second, a host sync (a value read back, a data-dependent
            # branch) raises, naming the op, rather than breaking the capture
            for check in (False, True):
                torch.cuda.set_sync_debug_mode("error" if check else sync_mode)
                fn(*(a if isinstance(a, torch.Generator) else tree_map(torch.clone, a)
                     for a in static))
            torch.cuda.set_sync_debug_mode(sync_mode)
            torch.cuda.synchronize(device)
            LAUNCHES.update(counted)
            segments.warming = False
            segments.begin()
            out = fn(*static)
            segments.end()
        torch.cuda.current_stream(device).wait_stream(stream)
        captured = {k: n - counted[k] for k, n in LAUNCHES.items() if n != counted[k]}
    finally:
        if segments.capturing:  # `fn` raised inside a capture: close it, keep its error
            with torch.cuda.stream(stream), contextlib.suppress(RuntimeError):
                segments.end()
        _CAPTURING = None
        torch.cuda.set_sync_debug_mode(sync_mode)
        LAUNCHES.update(counted)
    static_leaves = [None if isinstance(a, torch.Generator) else tree_leaves(a) for a in static]

    def replay(*args):
        if len(args) != len(static):
            raise ValueError(f"the program takes {len(static)} arguments, got {len(args)}")
        for arg, buffers in zip(args, static_leaves):
            if buffers is None:
                continue
            leaves = tree_leaves(arg)
            if len(leaves) != len(buffers):
                raise ValueError("an argument's structure differs from the captured one")
            for new, buf in zip(leaves, buffers):
                if new is buf:
                    continue
                if new.shape != buf.shape or new.dtype != buf.dtype:
                    raise ValueError(f"argument {tuple(new.shape)} {new.dtype} where the program "
                                     f"was captured on {tuple(buf.shape)} {buf.dtype}")
                buf.copy_(new)
        for i, g in generators:
            g.set_state(args[i].get_state())
        segments.replay()
        for i, g in generators:
            args[i].set_state(g.get_state())
        for k, n in captured.items():
            LAUNCHES[k] += n
        return out

    # the graph also reads tensors that `fn` closes over and its arguments do
    # not hold (a solver's constants, such as its inverse Hessian): the
    # program keeps `fn`, and so them, alive for as long as it is stored, so
    # a replay for another solver of the same key never reads freed memory
    replay.fn = fn
    replay.segments = len(segments.graphs)
    return replay
