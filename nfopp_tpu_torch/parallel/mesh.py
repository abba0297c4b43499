"""The problem mesh: the problem batch sharded over processes, one per card
(port of `nfopp_tpu/parallel/mesh.py`).

JAX builds a 1-D device mesh and lets XLA partition every vmapped step along
the batch axis. The port follows PyTorch's own idiom instead: one process per
card over `torch.distributed`. Every rank holds rows [rank*b, (rank+1)*b) of
a global batch of size*b problems (the order JAX's NamedSharding gives
device i), runs the solver on them with its own kernels, and meets the other
ranks only where the JAX program would communicate:

    initialize_distributed(...)          # once per process
    mesh = problem_mesh()                # every rank of the default group
    states = shard_batch(states, mesh)   # this rank's rows, on mesh.device
    loss = mean_over_problems(values, mesh)   # local sum + all_reduce

A mesh of size 1 needs no process group (the single-card behaviour). Where a
process group exists, its collectives run even at size 1. A `RowLayout`
(a solver's `layout`) decides which rows of a global batch a rank holds
and how a block drawn for the global batch is cut to them. Collectives over
the gloo backend move their tensors through the host (gloo's CUDA support
covers only broadcast and all_reduce); `COLLECTIVES` counts every collective
of this module and the host seconds spent in it.
"""
from __future__ import annotations

import datetime
import functools
import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..utils import profiling
from ..utils.device import check_device
from ..utils.tree import tree_leaves, tree_map

__all__ = [
    "BATCH_AXIS",
    "COLLECTIVES",
    "ProblemMesh",
    "RowLayout",
    "all_over_problems",
    "any_over_problems",
    "barrier",
    "batch_sharding",
    "count_over_problems",
    "gather_batch",
    "initialize_distributed",
    "mean_over_problems",
    "problem_mesh",
    "rank_zero_decides",
    "replicate",
    "reset_collectives",
    "shard_batch",
    "sum_over_ranks",
]

BATCH_AXIS = "problems"

# every collective of this module: how many, and the host seconds they took
COLLECTIVES = {"count": 0, "seconds": 0.0}


def reset_collectives() -> None:
    COLLECTIVES.update(count=0, seconds=0.0)


@dataclass(frozen=True)
class ProblemMesh:
    """One rank's view of the mesh: its process group (None for a mesh of one
    process without torch.distributed), its rank and the group's size, and
    the device its rows live on."""

    group: Any
    rank: int
    size: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        """Whether the mesh runs collectives (it has a process group)."""
        return self.group is not None

    @property
    def wire(self) -> torch.device:
        """Where a collective's tensors travel: the host under gloo, else the
        rank's device."""
        return torch.device("cpu") if dist.get_backend(self.group) == "gloo" else self.device


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(torch.cuda.device_count(), 1)


def problem_mesh(device=None, group=None) -> ProblemMesh:
    """The mesh over every rank of `group` (default: the default process
    group once `initialize_distributed` has run, else a mesh of this process
    alone). `device` defaults to cuda:<local rank>, and raises where there is
    no card: pass device="cpu" for the plain path."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    device = torch.device("cuda", _local_rank()) if device is None else device
    device = check_device(device, "problem_mesh")
    if group is None:
        return ProblemMesh(None, 0, 1, device)
    if device.type == "cuda" and dist.get_backend(group) == "nccl":
        torch.cuda.set_device(device)  # nccl's communicator is bound to the current card
    return ProblemMesh(group, dist.get_rank(group), dist.get_world_size(group), device)


@functools.lru_cache(maxsize=1024)
def _segments(first: int, batch: int, group_size: int) -> tuple:
    """(group, lo, hi) for each group of `group_size` consecutive global rows
    that rows first .. first+batch-1 touch: rows [lo, hi) of the `batch`
    lie in it."""
    cuts = range(first // group_size * group_size, first + batch, group_size)
    return tuple((c // group_size, max(c - first, 0), min(c + group_size - first, batch))
                 for c in cuts)


@functools.lru_cache(maxsize=1024)
def _crossing_groups(spans: tuple, group_size: int) -> tuple:
    """The groups of which more than one rank holds rows (`spans`: every
    rank's rows [lo, hi) of the global batch), in order: one slot each on
    the wire of the solver's group mean."""
    holders: dict = {}
    for lo, hi in spans:
        for group, _, _ in (_segments(lo, hi - lo, group_size) if hi > lo else ()):
            holders[group] = holders.get(group, 0) + 1
    return tuple(sorted(g for g, n in holders.items() if n > 1))


@dataclass(frozen=True)
class RowLayout:
    """Which rows of a global batch each rank of `mesh` holds: `spans`, every
    rank's rows [lo, hi) from 0 to the global batch (a rank may hold none),
    or None for the even split, rank r holding [r*b, (r+1)*b) (as JAX's
    NamedSharding gives device r). Methods taking `batch` answer for the
    global batch of which this rank holds `batch` rows."""

    mesh: ProblemMesh
    spans: tuple | None = None

    @classmethod
    def alone(cls, device) -> RowLayout:
        """This process alone, whatever process group exists."""
        return cls(ProblemMesh(None, 0, 1, torch.device(device)))

    def with_rows(self, spans) -> RowLayout:
        """This layout with the ranks' rows `spans`, checked."""
        spans = tuple((int(lo), int(hi)) for lo, hi in spans)
        if len(spans) != self.mesh.size or spans[0][0] != 0 or any(
                a[1] != b[0] for a, b in zip(spans, spans[1:])) or any(
                lo > hi for lo, hi in spans):
            raise ValueError(f"spans {spans} do not split a global batch over the mesh's "
                             f"{self.mesh.size} ranks")
        return RowLayout(self.mesh, spans)

    def spans_of(self, batch: int) -> tuple:
        """Every rank's rows of the global batch."""
        if self.spans is None:
            return tuple((r * batch, (r + 1) * batch) for r in range(self.mesh.size))
        lo, hi = self.spans[self.mesh.rank]
        if hi - lo != batch:
            raise ValueError(f"a batch of {batch} on rank {self.mesh.rank}, whose rows are "
                             f"{lo}:{hi} of {self.spans[-1][1]}")
        return self.spans

    def first(self, batch: int) -> int:
        """The global row of this rank's first row."""
        return self.spans_of(batch)[self.mesh.rank][0]

    def block_rows(self, batch: int, per: int = 1) -> tuple[int, slice]:
        """(global block's rows, this rank's of them), a row per `per` problems."""
        first = self.first(batch)
        lo = first // per
        hi = (first + batch - 1) // per + 1 if batch else lo
        return self.spans_of(batch)[-1][1] // per, slice(lo, hi)

    def cut(self, draw: Callable[[int], Any], batch: int, per: int = 1, axis: int = 0) -> Any:
        """`draw(rows)`, a tree drawn for the global block (a row per `per`
        problems along `axis`), cut to this rank's rows: a problem's draws do
        not depend on how many ranks share the batch."""
        total, rows = self.block_rows(batch, per)
        return tree_map(lambda x: x[(slice(None),) * axis + (rows,)], draw(total))

    def group_index(self, batch: int, group_size: int, device) -> torch.Tensor:
        """Each of this rank's rows' group, counted from this rank's first."""
        first = self.first(batch)
        rows = torch.arange(first, first + batch, device=device)
        return torch.div(rows, group_size, rounding_mode="floor") - first // group_size

    def segments(self, batch: int, group_size: int) -> tuple:
        """(group, lo, hi): this rank's rows [lo, hi) of each group it holds."""
        return _segments(self.first(batch), batch, group_size)

    def crossing_groups(self, batch: int, group_size: int) -> tuple:
        """The groups whose rows more than one rank holds."""
        return _crossing_groups(self.spans_of(batch), group_size)

    def check_group_size(self, batch: int, group_size: int) -> None:
        """A group size divides the global batch, as in JAX."""
        total = self.spans_of(batch)[-1][1]
        if group_size < 1 or total % group_size != 0:
            what = "batch" if total == batch else "global batch"
            raise ValueError(f"{what} {total} not divisible by group_size {group_size}")

    def within(self, lo: int, hi: int, batch: int) -> tuple:
        """Every rank's rows of the global rows [lo, hi), counted from lo."""
        return tuple((min(max(a - lo, 0), hi - lo), min(max(b - lo, 0), hi - lo))
                     for a, b in self.spans_of(batch))


def batch_sharding(mesh: ProblemMesh, batch: int) -> slice:
    """The rows of a global batch of `batch` problems this rank owns, split
    evenly (`RowLayout`)."""
    if batch % mesh.size != 0:
        raise ValueError(f"global batch {batch} not divisible by the mesh size {mesh.size}")
    return slice(*RowLayout(mesh).spans_of(batch // mesh.size)[mesh.rank])


def shard_batch(tree: Any, mesh: ProblemMesh, batch: int | None = None) -> Any:
    """This rank's rows of every leaf with a leading batch axis of `batch`
    (default: the longest leading axis of the tree), placed on mesh.device.
    A leaf with a leading axis of 1 (one world shared by the batch) or none
    is replicated; any other leading axis raises. Arrays become tensors."""
    tree = _as_tensors(tree)
    leaves = tree_leaves(tree)
    if batch is None:
        batch = max((x.shape[0] for x in leaves if x.ndim), default=1)
    rows = batch_sharding(mesh, batch)

    def take(x: torch.Tensor) -> torch.Tensor:
        if x.ndim and x.shape[0] == batch:
            x = x[rows]
        elif x.ndim and x.shape[0] != 1:
            raise ValueError(f"a leaf {tuple(x.shape)} has neither the batch axis {batch} "
                             "nor a shared leading axis of 1")
        return x.to(mesh.device)

    return tree_map(take, tree)


def replicate(tree: Any, mesh: ProblemMesh) -> Any:
    """The same tree on every rank's device (shared scene data)."""
    return tree_map(lambda x: x.to(mesh.device), _as_tensors(tree))


def _as_tensors(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree)
    return tree


def _collective(fn, *args) -> None:
    t0 = time.perf_counter()
    fn(*args)
    COLLECTIVES["count"] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0


def sum_over_ranks(x: torch.Tensor, mesh: ProblemMesh) -> torch.Tensor:
    """The elementwise sum of `x` over the ranks (one all_reduce), on x's
    device; every rank gets the same bits."""
    if not mesh.distributed:
        return x
    wire = x.detach().to(mesh.wire, copy=True)
    _collective(dist.all_reduce, wire, dist.ReduceOp.SUM, mesh.group)
    return wire.to(x.device)


def gather_batch(tree: Any, mesh: ProblemMesh) -> Any:
    """Every rank's rows of a batched tree (each leaf [b, ...]) gathered into
    the global batch [size*b, ...], the same on every rank, in
    `batch_sharding`'s order: the counterpart of reading a global jax.Array.
    One all_gather per dtype."""
    if not mesh.distributed:
        return tree
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    b = leaves[0].shape[0] if leaves[0].ndim else None
    if b is None or any(x.ndim == 0 or x.shape[0] != b for x in leaves):
        raise ValueError("gather_batch needs every leaf with the same leading batch axis, got "
                         f"{[tuple(x.shape) for x in leaves]}")
    gathered = [None] * len(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        wire_dtype = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([leaves[i].detach().reshape(b, -1).to(wire_dtype) for i in idx], dim=1)
        flat = flat.to(mesh.wire)
        parts = [torch.empty_like(flat) for _ in range(mesh.size)]
        _collective(dist.all_gather, parts, flat, mesh.group)
        full = torch.cat(parts).to(leaves[idx[0]].device)
        widths = [leaves[i][0].numel() for i in idx]
        for i, piece in zip(idx, torch.split(full, widths, dim=1)):
            shape = (mesh.size * b,) + tuple(leaves[i].shape[1:])
            gathered[i] = piece.reshape(shape).to(dtype)
    it = iter(gathered)
    return tree_map(lambda _: next(it), tree)


def mean_over_problems(values: torch.Tensor, mesh: ProblemMesh | None = None) -> torch.Tensor:
    """The mean over the global batch of this rank's rows `values` [b, ...]:
    the local sum, one all_reduce(SUM), a division by the global count (JAX's
    `jnp.mean(values, axis=0)` on a sharded array)."""
    mesh = problem_mesh(device=values.device) if mesh is None else mesh
    total = sum_over_ranks(torch.sum(values, dim=0), mesh)
    return total / (values.shape[0] * mesh.size)


def _flag_sum(count: int, mesh: ProblemMesh) -> int:
    wire = torch.tensor([count], dtype=torch.int32, device=mesh.wire)
    _collective(dist.all_reduce, wire, dist.ReduceOp.SUM, mesh.group)
    return int(wire.item())


def count_over_problems(flags: torch.Tensor, mesh: ProblemMesh | None) -> tuple[int, int]:
    """(this rank's, the global batch's) number of problems with their flag
    set (one host sync, one small all_reduce): the global count is the same
    on every rank, so a decision taken from it is taken alike. The run
    loop's host decisions: a `sync` span."""
    with profiling.span("sync"):
        local = int(flags.sum())
        if mesh is None or not mesh.distributed:
            return local, local
        return local, _flag_sum(local, mesh)


def any_over_problems(flags: torch.Tensor, mesh: ProblemMesh | None) -> bool:
    """Whether any problem of the global batch has its flag set."""
    return count_over_problems(flags, mesh)[1] > 0


def all_over_problems(flags: torch.Tensor, mesh: ProblemMesh | None) -> bool:
    """Whether every problem of the global batch has its flag set."""
    return not any_over_problems(~flags, mesh)


def rank_zero_decides(decision: bool, mesh: ProblemMesh | None) -> bool:
    """Rank 0's `decision`, broadcast to every rank (for decisions read from
    a clock, which differs between ranks)."""
    if mesh is None or not mesh.distributed:
        return decision
    wire = torch.tensor([int(decision)], dtype=torch.int32, device=mesh.wire)
    _collective(dist.broadcast, wire, dist.get_global_rank(mesh.group, 0), mesh.group)
    return bool(wire.item())


def barrier(mesh: ProblemMesh) -> None:
    """Every rank waits for the others (an all_reduce, which every backend
    takes on its own wire)."""
    if mesh.distributed:
        _flag_sum(1, mesh)


def _choose_backend(num_processes: int) -> tuple[str, str]:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= local and cards > 0:
        return "nccl", f"{cards} card(s) for {local} local rank(s): one card per rank"
    if cards == 0:
        return "gloo", "no card: the ranks run on the CPU"
    return "gloo", f"{cards} card(s) for {local} local rank(s): ranks share a card"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    init_method: str | None = None,
    timeout: float = 120.0,
) -> str | None:
    """Join the process group (`torch.distributed.init_process_group`); a
    no-op for one process unless `init_method` is given. Returns the backend,
    or None when nothing was initialised.

    `coordinator_address` ("host:port" of rank 0) becomes a tcp:// rendezvous;
    `init_method` (e.g. "file:///path") takes its place. Unset arguments come
    from torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT. The
    backend is chosen explicitly and printed: nccl where every local rank has
    a card of its own, gloo on the CPU or where ranks share a card; nccl
    refuses two ranks on one card. A backend that fails raises: nothing
    falls back to another backend or to one process. Every collective and
    the rendezvous give up after `timeout` seconds.
    """
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    num_processes = 1 if num_processes is None else num_processes
    if num_processes <= 1 and init_method is None:
        return None
    if init_method is None:
        if coordinator_address is None:
            raise ValueError(f"{num_processes} processes need a coordinator address or an "
                             "init_method")
        init_method = f"tcp://{coordinator_address}"
    if process_id is None:
        raise ValueError("a process of a distributed run needs its process_id (rank)")
    reason = "chosen by the caller"
    if backend is None:
        backend, reason = _choose_backend(num_processes)
    print(f"[rank {process_id}] torch.distributed backend {backend} ({reason}), "
          f"world {num_processes}", flush=True)
    dist.init_process_group(backend=backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return backend
