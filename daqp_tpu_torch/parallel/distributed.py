"""Process-group wiring: ``torch.distributed`` in place of JAX's
coordination service and mesh.

Counterpart of ``daqp_tpu/parallel/distributed.py`` (``:28 initialize``,
``:56 global_mesh``, ``:65 distribute_batch``).  Every process calls
:func:`initialize` once with the group's address, size and its rank
(nothing on the machine announces a cluster); :func:`global_mesh` gives
the process's :class:`World` (its rank, the group's size, the backend
and the device it solves on), and :func:`distribute_batch` cuts this
rank's block of lanes out of a full per-process copy of the batch.

NCCL carries the collectives of tensors on the card, gloo those on the
CPU; a gloo group may also serve ranks that solve on the card (its
collectives then go through the host), as two processes sharing one
card must, since NCCL refuses two ranks on one device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class World(NamedTuple):
    """One process's place in the group: ``backend`` None for a world of
    one process without a group; ``device`` where it solves."""
    rank: int
    size: int
    backend: Optional[str]
    device: torch.device


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the process group (idempotent: nothing happens when a group
    is already up).  ``backend``: "nccl" (the default: collectives on the
    card) or "gloo" (on the host); ``init_method``, ``world_size`` and
    ``rank`` as ``torch.distributed.init_process_group`` takes them,
    e.g. ``"tcp://localhost:29500"``, 2, 0."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend or "nccl", init_method=init_method,
                            world_size=world_size, rank=rank)


def global_mesh(device=None) -> World:
    """The current group's :class:`World`.  ``device`` defaults to the
    card: ``cuda:(rank mod the cards visible)``; pass ``"cpu"`` to solve
    on the host."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    rank, size = dist.get_rank(), dist.get_world_size()
    backend = str(dist.get_backend())
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to solve on the host")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return World(rank, size, backend, torch.device(device))


def distribute_batch(world: World, *arrays):
    """This rank's contiguous block of each full per-process batch array
    (the leading axis split in ``world.size`` equal blocks), as tensors
    on ``world.device``.  Every process passes the same full arrays."""
    out = []
    for arr in arrays:
        B = arr.shape[0]
        if B % world.size:
            raise ValueError(f"batch {B} is not divisible by the world "
                             f"size {world.size}")
        k = B // world.size
        block = arr[world.rank * k:(world.rank + 1) * k]
        if not isinstance(block, torch.Tensor):
            block = torch.as_tensor(np.ascontiguousarray(block))
        out.append(block.to(world.device))
    return tuple(out)
