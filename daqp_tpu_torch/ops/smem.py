"""Shared memory per block of each CUDA kernel, and the check before a
launch.

The formulas mirror the kernels' allocators in ``csrc/``:
``slot_smem_floats`` (``slot_step.cuh``; K2 and B3 as they are, both
of B3's bodies, ``mpc_horizon``; B4-B6 plus their own arrays), the warp
bodies of B5 and B6 up to ``WARP_MAX_K`` slots and columns (``slot_warp_smem_floats``, ``slot_warp.cuh``, plus the
kernel's arrays, one lane a block; each C entry takes its warp body where
that block fits the card's opt-in, ``warp_body``), ``dense_smem_floats``
(``dense_round.cu``, B7), the packed triangles, a warp each, and the
table of the block that K1 and B9 share (``chol_warp.cuh warp_floats``)
or their one matrix a block of several warps (``wide_floats``),
B8's packed triangles of a lane tile (``chol_lanes.cu Lanes::floats``)
and B10's panel or phase-2 stages (``chol_blk.cu Blk::floats``).
A lane that needs more than the card lets one block opt in to raises
``ValueError`` before anything is enqueued.
"""
from __future__ import annotations

import torch

F32 = 4                 # bytes per float
K_WARPS = 4             # slot_step.cuh: kThreads / 32
RED_STRIDE = 6          # slot_step.cuh: kRedStride
WARP_MAX_K = 32         # slot_warp.cuh: kWarpMaxK, B5's and B6's warp bodies
HORIZON_K = 64          # mpc_segment.cu: kHorizonK, kHorizonN, kHorizonM,
HORIZON_N = 64          # the ceilings of B3's horizon body
HORIZON_M = 128
WARP_POS = 6            # slot_warp.cuh: kPosArrays, per-position values
H100_OPTIN = 232448     # bytes one block may opt in to on an H100
DENSE_THREADS = 128     # dense_round.cu: kDenseThreads
DENSE_WARPS = DENSE_THREADS // 32
DENSE_RED = 6           # dense_round.cu: kDenseRed
BLK_NB = 32             # chol_blk.cu: kNB, the panel width
BLK_N64 = 64            # chol_blk.cu: kN64, 64 threads a block up to this n
BLK_N128 = 256          # chol_blk.cu: kN128, 128 up to this n, then 256
BLK_KT = 16             # chol_blk.cu: kKT, the phase-2 k-tile depth
BLK_XLD = BLK_KT + 4    # chol_blk.cu: kXLd


def slot_floats(m: int, n: int, K: int) -> int:
    """K2 and B3 (``slot_smem_floats``): E, W, M, 7 m-vectors, 15
    K-vectors and the used-slot list, 4 n-vectors, two halves of
    reduction scratch."""
    return (K * (K | 1) + K * (n | 1) + m * (n | 1) + 7 * m + 16 * K + 4 * n
            + 2 * K_WARPS * RED_STRIDE)


def mpc_horizon(m: int, n: int, K: int) -> bool:
    """Whether B3 runs its horizon body at m rows, n columns and K slots
    (``mpc_segment.cu mpc_body``'s choice by shape), else the 128-thread
    one; both take ``slot_floats``."""
    return K <= HORIZON_K and n <= HORIZON_N and m <= HORIZON_M


def slot_warp_floats(m: int, n: int, K: int) -> int:
    """The warp step's lane (``slot_warp_smem_floats``): the layout of
    ``slot_floats`` without the reduction scratch, the used-slot list at
    WARP_MAX_K entries, WARP_POS arrays of as many per-position values
    and 4 floats to align them to 16 bytes."""
    return (K * (K | 1) + K * (n | 1) + m * (n | 1) + 7 * m + 15 * K
            + 4 * n + (1 + WARP_POS) * WARP_MAX_K + 4)


def avi_own(m: int, n: int) -> int:
    """B5's arrays after the step's layout: five n x n matrices, seven
    n-vectors, the two bounds."""
    return 5 * n * (n | 1) + 7 * n + 2 * m


def lp_own(m: int, n: int) -> int:
    """B6's arrays after the step's layout: five n-vectors, four bounds."""
    return 5 * n + 4 * m


def warp_body(m: int, n: int, K: int, own, limit: int = H100_OPTIN) -> bool:
    """Whether the kernel whose arrays after the step's layout take
    ``own(m, n)`` floats (``avi_own`` for B5, ``lp_own`` for B6) runs its
    warp body at m rows, n columns and K slots on a card whose block may
    opt in to ``limit`` bytes (its C entry's choice), else the 128-thread
    one."""
    return (K <= WARP_MAX_K and n <= WARP_MAX_K
            and F32 * (slot_warp_floats(m, n, K) + own(m, n)) <= limit)


def prox_floats(m: int, n: int, K: int) -> int:
    """B4 (``prox_segment.cu prox_smem_floats``)."""
    return slot_floats(m, n, K) + n * (n | 1) + 5 * n + 2 * m


def segment_floats(own, m: int, n: int, K: int,
                   limit: int = H100_OPTIN) -> int:
    """The block of the kernel whose arrays take ``own(m, n)`` floats: its
    warp body's where ``warp_body`` takes it, else its 128-thread body's
    (``slot_floats`` plus its arrays)."""
    if warp_body(m, n, K, own, limit):
        return slot_warp_floats(m, n, K) + own(m, n)
    return slot_floats(m, n, K) + own(m, n)


def avi_floats(m: int, n: int, K: int, limit: int = H100_OPTIN) -> int:
    """B5's block (``avi_segment.cu``): ``avi_warp_smem_floats`` where
    ``warp_body`` takes the warp body, else ``avi_smem_floats``."""
    return segment_floats(avi_own, m, n, K, limit)


def lp_floats(m: int, n: int, K: int, limit: int = H100_OPTIN) -> int:
    """B6's block: ``lp_warp_smem_floats`` where ``warp_body`` takes the
    warp body, else ``lp_smem_floats`` (``lp_segment.cu``)."""
    return segment_floats(lp_own, m, n, K, limit)


def dense_floats(m: int, n: int, has_sw: bool) -> int:
    """B7, plain/soft or SOFT_WEIGHTS (``dense_smem_floats``): E, M, 17
    m-vectors (the active-row list among them), u and u_new, two halves
    of reduction scratch and 4 counters; SOFT_WEIGHTS 7 m-vectors and 2
    scalars more."""
    return (m * (m | 1) + m * (n | 1) + 17 * m + 2 * n
            + 2 * DENSE_WARPS * DENSE_RED + 4 + (7 * m + 2 if has_sw else 0))


def chol_lanes_floats(n: int, lanes: int) -> int:
    """B8 (``Lanes::floats``): per lane n (n + 1) / 2 packed elements and
    two n-vectors, one pad word per 32 floats."""
    e = n * (n + 1) // 2 + 2 * n
    return e * lanes + (e - 1) // (32 // lanes)


def chol_warp_floats(n: int, per_block: int) -> int:
    """K1 and B9 (``warp_floats``): per matrix n (n + 1) / 2 packed
    elements, and the block's (row, column) table of as many 16-bit
    words."""
    t = n * (n + 1) // 2
    return per_block * t + (t + 1) // 2


def chol_wide_floats(n: int) -> int:
    """K1 and B9 at one matrix a block of several warps
    (``wide_floats``): the packed triangle, 4 floats for the reads of
    four rows past the last one, and 16 of the diagonal block's
    scratch."""
    return n * (n + 1) // 2 + 4 + 16


def blk_threads(n: int) -> int:
    """B10's threads per block at n (``chol_blk.cu launch_threads``)."""
    return 64 if n <= BLK_N64 else 128 if n <= BLK_N128 else 256


def chol_blk_floats(n: int) -> int:
    """B10 (``Blk::floats``): phase 1 the n-row panel, nb = BLK_NB pivots
    and the diagonal block's L, rows of nb + 4; phase 2 the diagonal
    block, nb inverse pivots and, for n > nb, two stages of an X k-tile (a
    row per thread, BLK_XLD wide) and an L k-tile (BLK_KT rows of nb + 4)."""
    nb = BLK_NB
    ldp = nb + 4
    stage = blk_threads(n) * BLK_XLD + BLK_KT * ldp
    return max(n * ldp + nb + nb * ldp,
               nb * ldp + nb + (2 * stage if n > nb else 0))


def available(dev) -> int:
    """Bytes of shared memory one block may opt in to on ``dev``."""
    return torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin


def limit(dev) -> int:
    """``available(dev)`` on a CUDA device; an H100's on the CPU, where the
    twins stand in for the kernels an H100 would launch."""
    dev = torch.device(dev)
    return available(dev) if dev.type == "cuda" else H100_OPTIN


def sms(dev) -> int:
    """Streaming multiprocessors of ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def check(kernel: str, shape: dict, floats: int, dev=None,
          limit: int | None = None) -> None:
    """Raise ``ValueError`` if one block of ``kernel`` at ``shape`` needs
    more than ``limit`` bytes of shared memory (default: what ``dev``
    allows)."""
    need = F32 * floats
    limit = available(dev) if limit is None else limit
    if need > limit:
        dims = ", ".join(f"{k}={v}" for k, v in shape.items())
        raise ValueError(
            f"{kernel}: one lane at {dims} needs {need} bytes of shared "
            f"memory per block; the card allows {limit}")
