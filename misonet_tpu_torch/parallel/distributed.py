"""Multi-process bootstrap over ``torch.distributed``
(misonet_tpu/parallel/distributed.py).

Call :func:`initialize` once at process start on every rank, then build
the mesh with ``parallel.make_mesh()`` and shard each batch with
``parallel.shard_batch``.  Under ``torchrun --nproc_per_node=N`` the rank,
world size and rendezvous address come from its environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the
card); elsewhere pass them.  One process per card.

The backend follows the device: NCCL for CUDA, gloo for the CPU.  A card
never falls back to gloo: without NCCL, :func:`initialize` raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU; raises for a card
    without NCCL."""
    device = torch.device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL here: the card's "
                               "collectives need it (gloo is for the CPU)")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               device="cuda", force: bool = False) -> bool:
    """Initialize the default process group; returns whether one is set up.

    Arguments left None come from torchrun's environment (``WORLD_SIZE``,
    default 1; ``RANK``, default 0; ``tcp://MASTER_ADDR:MASTER_PORT``).  A
    world of one process is left alone unless ``force`` (so the same entry
    point works everywhere).  ``device``: "cuda" (the default; this rank's
    card is ``LOCAL_RANK``, else ``rank`` modulo the cards) or "cpu"."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and not force:
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError("initialize: give init_method, or set MASTER_ADDR "
                             "and MASTER_PORT (torchrun does)")
        init_method = f"tcp://{addr}:{port}"
    backend = backend_for(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def host_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1
