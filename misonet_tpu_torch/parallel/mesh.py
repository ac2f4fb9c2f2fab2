"""Data-parallel mesh over ``torch.distributed`` (misonet_tpu/parallel/mesh.py).

The JAX package shards a batch over a 1-D ``data`` mesh and lets XLA insert
the gradient psum.  Here one process drives one device (a card over NCCL,
or a CPU rank over gloo): a :class:`Mesh` is a process group over the first
``size`` ranks with the axis's name, :func:`shard_batch` gives each rank
its contiguous block of the batch's rows (where ``NamedSharding(P(axis))``
puts them), :func:`replicate` broadcasts parameters from the mesh's first
rank, and the train steps average gradients over the group
(``train/steps.py``).

``data_spec`` has no counterpart: torch tensors carry no sharding
annotation, so the layout it names is what :func:`shard_batch` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``ranks`` (global ranks, in mesh order), their process
    group (None on a rank outside the mesh) and the axis name."""

    ranks: tuple[int, ...]
    group: object
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's position along the axis; raises outside it."""
        rank = dist.get_rank()
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not in the mesh {self.ranks}")
        return self.ranks.index(rank)


def make_mesh(num_devices: int = 0, axis: str = "data") -> Mesh:
    """1-D mesh over the first ``num_devices`` ranks (all of them when 0).
    Needs an initialized process group (``parallel.distributed.initialize``);
    every rank must call it, as ``new_group`` does."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "misonet_tpu_torch.parallel.distributed."
                           "initialize() first")
    world = dist.get_world_size()
    n = num_devices or world
    if not 0 < n <= world:
        raise ValueError(f"make_mesh: {n} devices, the world has {world}")
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    return Mesh(ranks, group if dist.get_rank() in ranks else None, axis)


def mesh_size_for_batch(batch_size: int, num_devices: int) -> int:
    """The largest divisor of ``batch_size`` not above ``num_devices``."""
    for d in range(min(num_devices, batch_size), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def make_mesh_for_batch(batch_size: int, num_devices: int = 0,
                        axis: str = "data") -> Mesh:
    """Mesh whose size divides ``batch_size``: the largest divisor of the
    batch not above the device count (all ranks when 0), so any batch
    shards cleanly.  Ranks past it hold a mesh they are not in."""
    avail = num_devices or dist.get_world_size()
    return make_mesh(mesh_size_for_batch(batch_size, avail), axis)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous block of axis 0 of every array (tensor or
    numpy) in a dict / list / tuple tree; the batch must divide by the mesh
    size.  Other leaves pass through."""
    k, n = mesh.index, mesh.size

    def rows(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: a batch of {x.shape[0]} does not "
                             f"divide over {n} devices")
        m = x.shape[0] // n
        return x[k * m:(k + 1) * m]

    return _tree_map(rows, batch)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of ``tree`` (a module's parameters and
    buffers, or a dict / list / tuple of tensors) from the mesh's first
    rank, in place; returns ``tree``.

    Each tensor is received into a buffer and copied in with ``copy_``, so
    its version counter moves, as any in-place update's does: caches keyed
    by it (``DenseBlockFlat.stacked_weights``) see the new values, which a
    broadcast straight into the tensor would not tell them."""
    tensors = ([*tree.parameters(), *tree.buffers()]
               if isinstance(tree, torch.nn.Module) else [])
    if not isinstance(tree, torch.nn.Module):
        _tree_map(lambda x: tensors.append(x)
                  if isinstance(x, torch.Tensor) else None, tree)
    for t in tensors:
        buf = t.detach().clone()
        dist.broadcast(buf, mesh.ranks[0], group=mesh.group)
        t.copy_(buf)
    return tree


def sum_over(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh in place (this rank must be in it)."""
    mesh.index  # noqa: B018  (raises outside the mesh)
    dist.all_reduce(t, group=mesh.group)
    return t


def mean_over(tensors, mesh: Mesh) -> None:
    """Replace each tensor by its mean over the mesh, in place: one
    all_reduce of their concatenation (identical results on every rank)."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = sum_over(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    flat /= mesh.size
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
