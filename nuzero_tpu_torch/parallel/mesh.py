"""A data-parallel mesh of processes and its placements (counterpart of
``nuzero_tpu/parallel/mesh.py``).

In the JAX package one SPMD program shards the self-play batch and the
replay buffer's game axis over a ``dp`` mesh of devices and keeps params
and optimizer state replicated; XLA inserts the gradient all-reduce.  The
port runs one process per card over ``torch.distributed``: a ``Mesh`` is
this process's place in the process group (rank, world size, device), and
its collectives are the ones the coordinator calls by hand (the gradient
all-reduce of ``training/learner.py``, the assembly of a sampled batch in
``training/replay.py``, the finished-game counts of
``training/pipeline.py``).

``place_replicated`` broadcasts every tensor of a tree from rank 0;
``place_batch_sharded`` keeps this rank's block of every tensor whose
leading axis the world size divides and replicates the rest, the JAX
package's rule (``nuzero_tpu/parallel/mesh.py:84-107``).  Both take the
full global value on every rank, as the JAX functions do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from nuzero_tpu_torch.parallel.distributed import local_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel process group (the
    default group): ``rank`` of ``size`` ranks, on ``device``.  It owns the
    ranks' layout of a sharded axis: rank r holds the r-th of ``size``
    equal contiguous blocks (``block``, ``owned``)."""

    rank: int
    size: int
    device: torch.device

    def block(self, n: int) -> slice:
        """This rank's block of a leading axis of ``n`` rows; ``n`` must
        divide evenly over the ranks."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} rows does not divide over the mesh "
                             f"size {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def owned(self, index: torch.Tensor, per_rank: int):
        """Global indices into ``size`` blocks of ``per_rank`` each ->
        (whether this rank's block holds each, its offset in its block)."""
        return index // per_rank == self.rank, index % per_rank

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on the leading axis, in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        """Every rank waits for every other (an all-reduce on the mesh's
        device, which both backends run)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(device: Optional[torch.device] = None) -> Mesh:
    """The mesh of the initialized default process group with this rank on
    ``device`` (default: ``local_device()``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized; call "
                           "parallel.distributed.initialize_distributed first")
    device = torch.device(device) if device is not None else local_device()
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(), device=device)


def default_mesh(device) -> Optional[Mesh]:
    """The mesh of the process group on ``device`` where one of more than
    one rank is initialized, else None (the JAX entry points' ``make_mesh(
    devices) if len(devices) > 1 else None``)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh(device)
    return None


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement over ``mesh``: ``split`` keeps this rank's block of the
    leading axis (JAX's ``PartitionSpec("dp")``), else the whole is
    replicated (``PartitionSpec()``)."""

    mesh: Mesh
    split: bool

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the global value ``x``, on the mesh's device
        (a split is a view of its block)."""
        x = x.to(self.mesh.device)
        if self.split:
            return x[self.mesh.block(x.shape[0])]
        if x.dtype == torch.bool:  # gloo reduces no bool tensors
            return self.mesh.broadcast(x.to(torch.uint8)).bool()
        return self.mesh.broadcast(x.clone())


def shard_batch(mesh: Mesh) -> Sharding:
    """Leading-axis sharding for game batches and replay game slots."""
    return Sharding(mesh, True)


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def batch_sharding(x, mesh: Mesh) -> Sharding:
    """The JAX package's rule: shard where the leading axis is non-empty and
    the mesh's size divides it, replicate scalars and the rest."""
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) >= 1 and shape[0] > 0 and shape[0] % mesh.size == 0:
        return shard_batch(mesh)
    return replicate(mesh)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists, tuples, named
    tuples and dataclasses; other leaves (numbers, None) stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def place_replicated(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` replicated over the mesh: rank 0's value,
    broadcast (params, optimizer state)."""
    repl = replicate(mesh)
    return tree_map(repl.place, tree)


def place_batch_sharded(tree: Any, mesh: Mesh) -> Any:
    """Each tensor of ``tree`` (the global value, the same on every rank)
    by ``batch_sharding``: this rank's block of its leading axis, or the
    whole, replicated."""
    return tree_map(lambda x: batch_sharding(x, mesh).place(x), tree)
