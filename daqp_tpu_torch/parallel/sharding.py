"""Scale-out over ranks: batches split by rank with reduced statistics,
and one MIQP whose branch-and-bound tree is split over the ranks.

Counterpart of ``daqp_tpu/parallel/sharding.py`` (``:49
solve_batch_sharded``, ``:149 solve_batch_miqp_sharded``, ``:192
exchange_incumbent``, ``:199-301 solve_miqp_sharded``).  Where the JAX
module runs one ``shard_map`` program over a mesh, each process here is
one rank of a ``torch.distributed`` group (:mod:`.distributed`), solves
its own lanes with the port's single-card entries, and meets the others
only in collectives: the statistics (``ShardedStats``: sums and a max)
and the MIQP's incumbent bound (a min between node waves), the one
value whose exchange changes what a solver does (bnb.c:29-31, 62).
Every collective goes through ``_collective``, which moves a tensor to
the backend's device (the host for gloo, the card for NCCL) and back.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import batch as pbatch
from .. import bnb, core, transform
from ..ops import host_any
from ..types import (ACTIVE, BINARY, DAQP_INF, EXIT_INFEASIBLE,
                     EXIT_OPTIMAL, IMMUTABLE, LOWER, SOFT, Settings)
from .distributed import World, global_mesh

TIERS = ("flat", "pallas", "prox", "naive")


def make_mesh(n_devices: Optional[int] = None, device=None) -> World:
    """The current group's :class:`World`, or without a group a world of
    one process; ``n_devices``, when given, must be its size.  ``device``
    as ``distributed.global_mesh`` (the card unless ``"cpu"``)."""
    if dist.is_initialized():
        world = global_mesh(device)
    else:
        world = World(0, 1, None, pbatch.resolve_device((), device))
    if n_devices is not None and n_devices != world.size:
        raise ValueError(f"n_devices={n_devices}, but the world has "
                         f"{world.size} ranks")
    return world


def _collective(world: World, t: torch.Tensor, op=None) -> torch.Tensor:
    """The all-reduce of ``t`` by ``op`` (a ``dist.ReduceOp``), or with
    ``op`` None its all-gather, a (size, *t.shape) tensor; computed on the
    backend's device (the host for gloo, ``world.device`` for NCCL) and
    returned on ``t``'s.  A world without a group has one rank: the
    result is ``t`` itself (gathered: ``t[None]``)."""
    if world.backend is None:
        return t.clone() if op is not None else t[None].clone()
    dev = torch.device("cpu") if world.backend == "gloo" else world.device
    x = t.detach().to(dev, copy=True).contiguous()
    if op is None:
        parts = [torch.empty_like(x) for _ in range(world.size)]
        dist.all_gather(parts, x)
        x = torch.stack(parts)
    else:
        dist.all_reduce(x, op=op)
    return x.to(t.device)


class ShardedStats(NamedTuple):
    total_iterations: int   # SUM over ranks
    n_optimal: int          # SUM over ranks: lanes with exit flag 1
    max_iterations: int     # MAX over ranks


def _stats(res, world: World) -> ShardedStats:
    it = res.iterations.to(torch.int64)
    sums = _collective(world, torch.stack(
        [it.sum(), (res.exitflag == EXIT_OPTIMAL).sum()]), dist.ReduceOp.SUM)
    top = _collective(world, it.max() if it.numel() else it.new_zeros(()),
                      dist.ReduceOp.MAX)
    (total, n_opt), top = sums.tolist(), int(top)
    return ShardedStats(int(total), int(n_opt), top)


def solve_batch_sharded(H, f, A, bupper, blower, sense, st: Settings,
                        world: World, ms: int = 0, repair_rounds: int = 2,
                        tier: str = "flat",
                        lane_chunk: int = pbatch.LANE_CHUNK,
                        has_soft: Optional[bool] = None,
                        K: Optional[int] = None):
    """This rank's lanes (``distribute_batch``'s block) solved on
    ``world.device``: (the local ``BatchResult``, ``ShardedStats`` over
    the group).  ``tier``:

    * ``"flat"`` (default): ``solve_batch_flat_jit`` in chunks of
      ``lane_chunk``, K = n + the most soft rows of a lane + 1 unless
      given;
    * ``"pallas"``: ``solve_batch_kernel_stream`` (K1, then K2, or B7
      with ``has_soft``, which defaults to whether ``sense`` has SOFT
      bits);
    * ``"prox"``: ``solve_batch_prox_kernel`` (semidefinite H; B4);
    * ``"naive"``: ``solve_batch_jit`` (the ordered tier) with
      ``repair_rounds``, K = n + 1 unless given.

    The device decides kernel or twin, as on one card."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    H, f, A, bupper, blower, sense = pbatch._tensors(
        H, f, A, bupper, blower, sense, world.device)
    n = A.shape[-1]
    soft = (sense & SOFT) > 0
    if tier == "pallas" and has_soft is None:
        has_soft = host_any(soft)
    if K is None:
        K = n + 1
        if tier == "flat" and soft.numel():
            K += int(soft.sum(-1).amax())
    args = (H, f, A, bupper, blower, sense, st)
    if tier == "flat":
        res = pbatch.solve_batch_flat_jit(*args, ms=ms, K=K,
                                          lane_chunk=lane_chunk)
    elif tier == "pallas":
        res = pbatch.solve_batch_kernel_stream(*args, ms=ms,
                                               has_soft=bool(has_soft))
    elif tier == "prox":
        res = pbatch.solve_batch_prox_kernel(*args, ms=ms)
    else:
        res = pbatch.solve_batch_jit(*args, ms=ms, K=K,
                                     repair_rounds=repair_rounds)
    return res, _stats(res, world)


def solve_batch_miqp_sharded(H, f, A, bupper, blower, sense, st: Settings,
                             world: World, ms: int = 0,
                             bin_ids: tuple = None):
    """This rank's MIQPs through ``solve_batch_miqp_kernel`` (node waves
    on K1 and K2): (the local result, ``ShardedStats``).  The instances
    are independent, so only the statistics cross ranks; for one MIQP
    whose tree is split over the ranks see :func:`solve_miqp_sharded`."""
    H, f, A, bupper, blower, sense = pbatch._tensors(
        H, f, A, bupper, blower, sense, world.device)
    res = pbatch.solve_batch_miqp_kernel(H, f, A, bupper, blower, sense, st,
                                         ms=ms, bin_ids=bin_ids)
    return res, _stats(res, world)


def exchange_incumbent(bound: torch.Tensor, world: World) -> torch.Tensor:
    """The least incumbent bound over the ranks: the distributed
    dominance cut (bnb.c:29-31, 62; daqp.c:20-23)."""
    return _collective(world, bound, dist.ReduceOp.MIN)


def _tree_worker(H, f, A, bupper, blower, sense, ms: int, st: Settings,
                 rounds: int, node_budget: int, rank: int, size: int,
                 exchange):
    """One rank's part of the tree: the first floor(log2(size)) binaries
    fixed to the bits of ``rank`` (ACTIVE and IMMUTABLE, LOWER where the
    bit is 1, as branch and bound fixes a binary, bnb.c:106-107), then
    ``rounds`` waves of ``node_budget`` nodes, each followed by
    ``exchange(bound)`` (the MIN over ranks; the identity for one rank
    alone), then the rest of the subtree.  Returns (x, fval, nodes):
    the local incumbent's x and objective, DAQP_INF without one.

    fval comes from the incumbent's own u, never from the tree's bound:
    after an exchange the bound may be another rank's, and a rank
    reporting it beside its own x would claim an objective its x does
    not have (the JAX module saw x at +30.7 reported at -36.2,
    ``daqp_tpu/parallel/sharding.py:273-278``)."""
    bits = sense.cpu().numpy().astype(np.int32)
    bin_ids = tuple(int(i) for i in np.flatnonzero(bits & BINARY))
    for i, bid in enumerate(bin_ids[:size.bit_length() - 1]):
        b = bits[bid] | ACTIVE | IMMUTABLE
        bits[bid] = b | LOWER if (rank >> i) & 1 else b & ~LOWER
    sense = torch.as_tensor(bits, device=H.device)
    n = A.shape[1]
    ldpd = core.build_ldp(H, f, A, bupper, blower, sense, ms, st)
    c = bnb.bnb_init(ldpd, bin_ids, st, n + 1)
    for _ in range(rounds):
        c = bnb.bnb_run(c, bin_ids, st, node_budget=node_budget)
        c = c._replace(bound=exchange(c.bound))
    c = bnb.bnb_run(c, bin_ids, st)
    if not c.incumbent_found:
        return (torch.zeros(n, dtype=H.dtype, device=H.device),
                torch.tensor(DAQP_INF, dtype=H.dtype, device=H.device),
                c.nodecount)
    u = c.incumbent_u
    x = transform.ldp_to_qp_solution(core.batched(ldpd), u[None])[0]
    return x, 0.5 * (u @ u - ldpd.v @ ldpd.v), c.nodecount


def solve_miqp_sharded(H, f, A, bupper, blower, sense, ms: int,
                       st: Settings, world: World, rounds: int = 16,
                       node_budget: int = 32):
    """One MIQP, its branch-and-bound tree split over the ranks: each
    rank runs :func:`_tree_worker` on its subtree with the bound
    exchanged between waves, then the ranks all-gather their incumbents
    and take the least.  Every rank returns (x, fval, status, nodes):
    the winner's x, its objective recomputed from x in the working
    dtype, EXIT_OPTIMAL or EXIT_INFEASIBLE, and the nodes of all
    ranks."""
    H, f, A, bupper, blower, sense = pbatch._tensors(
        H, f, A, bupper, blower, sense, world.device)
    x, fval, nodes = _tree_worker(
        H, f, A, bupper, blower, sense, ms, st, rounds, node_budget,
        world.rank, world.size, lambda b: exchange_incumbent(b, world))
    all_f = _collective(world, fval)
    all_x = _collective(world, x)
    w = int(torch.argmin(all_f))
    found = float(all_f[w]) < DAQP_INF
    xg = all_x[w]
    fg = 0.5 * (xg @ H @ xg) + f @ xg
    nodes = _collective(world, torch.tensor(nodes, device=x.device),
                        dist.ReduceOp.SUM)
    return (xg, fg, EXIT_OPTIMAL if found else EXIT_INFEASIBLE,
            int(nodes))
