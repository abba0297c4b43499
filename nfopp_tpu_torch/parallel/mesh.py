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
process group exists, its collectives run even at size 1. Collectives over
the gloo backend move their tensors through the host (gloo's CUDA support
covers only broadcast and all_reduce); `COLLECTIVES` counts every collective
of this module and the host seconds spent in it.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass
from typing import Any

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
    "all_over_problems",
    "any_over_problems",
    "barrier",
    "batch_sharding",
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


def batch_sharding(mesh: ProblemMesh, batch: int) -> slice:
    """The rows of a global batch of `batch` problems this rank owns: rank i
    holds [i*b, (i+1)*b), as JAX's NamedSharding(PartitionSpec('problems'))
    gives device i."""
    if batch % mesh.size != 0:
        raise ValueError(f"global batch {batch} not divisible by the mesh size {mesh.size}")
    b = batch // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


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


def _flag_sum(flag: bool, mesh: ProblemMesh) -> int:
    wire = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.wire)
    _collective(dist.all_reduce, wire, dist.ReduceOp.SUM, mesh.group)
    return int(wire.item())


def any_over_problems(flags: torch.Tensor, mesh: ProblemMesh | None) -> bool:
    """Whether any problem of the global batch has its flag set (one host
    sync, one small all_reduce): a host decision every rank takes alike.
    The run loop's one host decision: a `sync` span."""
    with profiling.span("sync"):
        local = bool(flags.any())
        if mesh is None or not mesh.distributed:
            return local
        return _flag_sum(local, mesh) > 0


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
        _flag_sum(True, mesh)


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
