"""Batched QP solving on the port's kernel path.

Counterpart of ``daqp_tpu/batch.py``: ``:56 BatchResult``, ``:248
solve_batch_pallas_jit``, ``:315 solve_batch_pallas_stream_jit``, ``:428
_difficulty_nviol``, ``:451 _pallas_batch_core`` (its hard branch,
:609-694) and ``:2582 kkt_residuals``.

The path: K1 factors every H (``ops.chol.batched_rinv_regularized``),
``transform.build_ldp`` builds the LDP data, ``ops.slot`` runs K2 rounds
with exact repair and polish, and the slot state maps back to x, lam,
fval.  Left behind as TPU workarounds: the 512-lane guard and its
routing, the 128-lane padding, and the in-core difficulty sort for tile
occupancy (one block per QP has no tiles).  Soft batches (the dense-mask
kernel), SOFT_WEIGHTS, ``guess_cap`` and ``deadline`` belong to later
slices and raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import transform
from .ops import chol, host_any, slot
from .types import (ACTIVE, IMMUTABLE, LOWER, SOFT, DAQP_INF,
                    EXIT_NONCONVEX, EXIT_UNSUPPORTED, Settings)


class BatchResult(NamedTuple):
    x: torch.Tensor           # (B, n)
    lam: torch.Tensor         # (B, m)
    fval: torch.Tensor        # (B,)
    exitflag: torch.Tensor    # (B,) int32
    iterations: torch.Tensor  # (B,) int32
    soft_slack: torch.Tensor  # (B,)


def _unported(has_soft, deadline, sw, guess_cap) -> None:
    if has_soft or sw is not None:
        raise NotImplementedError(
            "soft constraints and SOFT_WEIGHTS run on the dense-mask kernel "
            "(daqp_tpu/ops/pallas_batch.py run_kernel_round), which a later "
            "slice of the port brings over (ROADMAP A9)")
    if guess_cap:
        raise NotImplementedError(
            "guess_cap (primal-init active-set guess) is ported in a later "
            "slice (ROADMAP A5)")
    if deadline is not None:
        raise NotImplementedError(
            "deadline (wall-clock limit between rounds) is ported in a later "
            "slice (ROADMAP A5)")


def _tensors(H, f, A, bupper, blower, sense):
    """The inputs as tensors on H's device, in H's float type."""
    dev = H.device if isinstance(H, torch.Tensor) else torch.device("cpu")
    H = torch.as_tensor(H, device=dev)
    out = [H] + [torch.as_tensor(x, device=dev).to(H.dtype)
                 for x in (f, A, bupper, blower)]
    if sense is None:
        sense = torch.zeros(out[3].shape, dtype=torch.int32, device=dev)
    return out + [torch.as_tensor(sense, device=dev).to(torch.int32)]


def _difficulty_nviol(f, A, bupper, blower, ms: int, Rinv):
    """Violated-constraint count at the unconstrained optimum
    x = -Rinv Rinv' f: the stream's difficulty proxy."""
    v = torch.matmul(Rinv.transpose(1, 2), f[..., None])
    x_unc = -torch.matmul(Rinv, v)[..., 0]
    Ax = torch.matmul(A, x_unc[..., None])[..., 0]
    vals = torch.cat([x_unc[:, :ms], Ax], dim=1)
    return ((vals > bupper) | (vals < blower)).sum(dim=-1)


def _kernel_batch_core(H, f, A, bupper, blower, sense, st: Settings,
                       ms: int = 0, fact=None) -> BatchResult:
    """Factor (or take ``fact`` = (Rinv, ok, reg_mask, eps_used)), build
    the LDP, solve on the slot tier and map back to QP space."""
    B = H.shape[0]
    n = A.shape[-1]
    f32 = torch.float32
    if fact is None:
        fact = chol.batched_rinv_regularized(H, st)
    Rinv, okl, regl, eps_l = fact
    ldpd = transform.build_ldp(f, A, bupper, blower, sense, ms, st,
                               Rinv=Rinv)
    ldpd = ldpd._replace(
        error=torch.where(okl, ldpd.error, EXIT_NONCONVEX).to(torch.int32),
        n_prox=torch.where(regl, n, 0).to(torch.int32),
        eps_used=eps_l.to(ldpd.eps_used.dtype))
    immut = ((ldpd.sense & IMMUTABLE) > 0).to(f32)
    soft_lane = ((ldpd.sense & SOFT) > 0).any(dim=1)
    # LDP-space dominance bound = 2 * fval_bound (daqp.c:10)
    fb = 2.0 * torch.full((B,), st.fval_bound, dtype=f32, device=H.device)
    s = slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                       n_true=n, fbound=fb)
    act_bits = (ldpd.sense & ACTIVE) > 0
    if host_any(act_bits):
        # equalities / warm starts: bulk-activate the sense-ACTIVE rows
        lo_bits = act_bits & ((ldpd.sense & LOWER) > 0)
        s = slot.slot_activate(s, act_bits & ~lo_bits, lo_bits, st)
    s = slot.slot_solve(s, st, n_true=n)
    lam = slot.slot_duals_dense(s)
    x = transform.ldp_to_qp_solution(ldpd, s.u[:, :n])
    fval = 0.5 * (s.fval - (ldpd.v * ldpd.v).sum(1))
    exitflag = torch.where(ldpd.error < 0, ldpd.error, s.status)
    exitflag = torch.where(soft_lane, EXIT_UNSUPPORTED, exitflag)
    return BatchResult(x=x, lam=lam, fval=fval,
                       exitflag=exitflag.to(torch.int32),
                       iterations=s.iterations.to(torch.int32),
                       soft_slack=torch.zeros(B, dtype=x.dtype,
                                              device=x.device))


def solve_batch_kernel(H, f, A, bupper, blower, sense, st: Settings,
                       ms: int = 0, has_soft: Optional[bool] = None,
                       deadline=None, sw=None,
                       guess_cap=None) -> BatchResult:
    """Batched strictly convex QP solve on the kernel path, one call for
    the whole batch (``solve_batch_pallas_jit``).  Tensors on a CUDA
    device launch K1 and K2; CPU tensors run their plain twins.
    ``has_soft=None`` detects soft rows from ``sense``; soft batches are
    not ported yet.  With ``has_soft=False`` a lane carrying soft rows
    exits ``EXIT_UNSUPPORTED``."""
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense)
    if has_soft is None:
        has_soft = host_any((sense & SOFT) > 0)
    _unported(has_soft, deadline, sw, guess_cap)
    return _kernel_batch_core(H, f, A, bupper, blower, sense, st, ms=ms)


def solve_batch_kernel_stream(H, f, A, bupper, blower, sense,
                              st: Settings, ms: int = 0, chunk: int = 256,
                              has_soft: bool = False, deadline=None,
                              sw=None, sort_stream: bool = False,
                              guess_cap=None) -> BatchResult:
    """Streaming solve (``solve_batch_pallas_stream_jit``): one global
    factorization of the whole batch through K1, then ``chunk``-lane
    solves that reuse it.  ``sort_stream`` orders the stream by the
    difficulty proxy first (stable sort).  Each lane's result depends on
    that lane alone, so ``chunk`` and the order only bound memory and
    shape the waves; outputs come back in input order."""
    _unported(has_soft, deadline, sw, guess_cap)
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense)
    B = H.shape[0]
    fact = chol.batched_rinv_regularized(H, st)
    order = None
    if sort_stream:
        nv = _difficulty_nviol(f, A, bupper, blower, ms, fact[0])
        order = torch.argsort(nv, stable=True)
        H, f, A, bupper, blower, sense = (
            x[order] for x in (H, f, A, bupper, blower, sense))
        fact = tuple(x[order] for x in fact)
    parts = []
    for c0 in range(0, B, chunk):
        sl = slice(c0, c0 + chunk)
        parts.append(_kernel_batch_core(
            H[sl], f[sl], A[sl], bupper[sl], blower[sl], sense[sl], st,
            ms=ms, fact=tuple(x[sl] for x in fact)))
    out = BatchResult(*(torch.cat(p) for p in zip(*parts)))
    if order is not None:
        unsort = torch.argsort(order)
        out = BatchResult(*(x[unsort] for x in out))
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def kkt_residuals(H, f, A, bupper, blower, sense, x, lam, ms: int = 0):
    """Per-lane f64 KKT check of a batched solve (host-side NumPy).

    Returns ``(stationarity, violation)``:
      * stationarity — relative ||H x + f + A' lam||_inf;
      * violation   — worst over HARD rows of the relative primal
        violation and the complementarity / dual-sign violation
        min(|lam_i|, slack of the side lam_i's sign claims active).
    """
    H = _np(H).astype(float)
    f = _np(f).astype(float)
    A = _np(A).astype(float)
    bu = _np(bupper).astype(float)
    bl = _np(blower).astype(float)
    x = _np(x).astype(float)
    lam = _np(lam).astype(float)
    B, n = x.shape
    m = bu.shape[-1]
    sense = (np.zeros((B, m), np.int32) if sense is None else _np(sense))

    grad = np.einsum('bij,bj->bi', H, x) + f
    if ms:
        grad[:, :ms] += lam[:, :ms]
    if A.shape[1]:
        grad += np.einsum('bri,br->bi', A, lam[:, ms:])
    denom = (np.abs(H).sum(-1).max(-1) * np.maximum(np.abs(x).max(-1), 1)
             + np.abs(f).max(-1) + 1.0)
    stat = np.abs(grad).max(-1) / denom

    vals = np.concatenate(
        [x[:, :ms], np.einsum('brj,bj->br', A, x)], axis=1) \
        if ms else np.einsum('brj,bj->br', A, x)
    bscale = 1.0 + np.maximum(np.abs(np.where(bu >= DAQP_INF, 0, bu)),
                              np.abs(np.where(bl <= -DAQP_INF, 0, bl)))
    viol = np.maximum(vals - bu, bl - vals) / bscale
    hard = (sense & SOFT) == 0
    lscale = 1.0 + np.abs(lam).max(-1, keepdims=True)
    slack_claim = np.where(lam > 0, bu - vals, vals - bl)
    slack_claim = np.minimum(np.abs(slack_claim) / bscale,
                             np.abs(lam) / lscale)
    comp = np.where(hard, slack_claim, 0.0)
    viol = np.maximum(np.where(hard, viol, -np.inf), comp).max(-1)
    return stat, viol
