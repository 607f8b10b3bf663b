"""QP -> LDP transform, batched, for a given Rinv.

Counterpart of ``daqp_tpu/transform.py``: ``:42 LDPData``, ``:140
build_ldp`` (its given-``Rinv`` branch, vmapped in ``batch.py:523``) and
``:340 ldp_to_qp_solution``.  Batch-leading: (B, m, n), (B, m), (B,).
The products are plain ``torch.matmul`` (XLA does them outside any
kernel in the JAX package); TF32 is off package-wide.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .types import (ACTIVE, IMMUTABLE, SOFT, EXIT_INFEASIBLE, Settings)


class LDPData(NamedTuple):
    """Everything the QP -> LDP transform produces, per lane."""
    M: torch.Tensor          # (B, m, n) normalized constraint rows
    dupper: torch.Tensor     # (B, m)
    dlower: torch.Tensor     # (B, m)
    scaling: torch.Tensor    # (B, m)
    sense: torch.Tensor      # (B, m) int32, equalities auto-marked
    Rinv: torch.Tensor       # (B, n, n) upper inverse Cholesky factor
    v: torch.Tensor          # (B, n) v = Rinv' f
    prox_mask: torch.Tensor  # (B, n) bool
    n_prox: torch.Tensor     # (B,) int32
    eps_used: torch.Tensor   # (B,)
    error: torch.Tensor      # (B,) int32: 0 ok, else an EXIT_* code


def build_ldp(f, A, bupper, blower, sense, ms: int, st: Settings,
              Rinv: torch.Tensor) -> LDPData:
    """M = [Rinv[:ms]; A Rinv], v, the bounds check with auto-equality,
    row normalization with zero rows, and d = b * scaling + M v
    (``daqp_update_ldp``, utils.c:14-135)."""
    B, n, _ = Rinv.shape
    dtype, dev = Rinv.dtype, Rinv.device
    mg = A.shape[1]
    m = ms + mg
    sense = (torch.zeros((B, m), dtype=torch.int32, device=dev)
             if sense is None else sense.to(torch.int32))

    v = torch.matmul(Rinv.transpose(1, 2), f.to(dtype)[..., None])[..., 0]
    M = torch.matmul(A.to(dtype), Rinv)
    if ms > 0:
        M = torch.cat([Rinv[:, :ms, :], M], dim=1)

    # bounds check (daqp_check_bounds, utils.c:457-478)
    bu = bupper.to(dtype)
    bl = blower.to(dtype)
    mutable = (sense & IMMUTABLE) == 0
    diff = bu - bl
    trivially_infeasible = (mutable & (diff < -st.primal_tol)).any(dim=1)
    is_eq = mutable & (diff < st.zero_tol) & ((sense & SOFT) == 0)
    sense = torch.where(is_eq, sense | (ACTIVE | IMMUTABLE), sense)

    # row normalization (utils.c:480-524); zero rows ignored or infeasible
    norms_sq = (M * M).sum(dim=2)
    zero_row = norms_sq < st.zero_tol
    scaling = torch.where(
        zero_row, torch.ones_like(norms_sq),
        1.0 / torch.sqrt(torch.clamp(norms_sq, min=st.zero_tol)))
    M = M * torch.where(zero_row, torch.zeros_like(scaling),
                        scaling)[..., None]
    zero_row_infeasible = (
        zero_row & ((bu < -st.zero_tol) | (bl > st.zero_tol))
        & ((sense & IMMUTABLE) == 0) & ((sense & SOFT) == 0)).any(dim=1)
    sense = torch.where(zero_row, (sense | IMMUTABLE) & ~ACTIVE, sense)

    # d = b * scaling + M v  (daqp_update_d, utils.c:410-455)
    Mv = torch.matmul(M, v[..., None])[..., 0]
    err = torch.where(trivially_infeasible | zero_row_infeasible,
                      EXIT_INFEASIBLE, 0).to(torch.int32)
    return LDPData(M=M, dupper=bu * scaling + Mv, dlower=bl * scaling + Mv,
                   scaling=scaling, sense=sense, Rinv=Rinv, v=v,
                   prox_mask=torch.zeros((B, n), dtype=torch.bool,
                                         device=dev),
                   n_prox=torch.zeros(B, dtype=torch.int32, device=dev),
                   eps_used=torch.zeros(B, dtype=dtype, device=dev),
                   error=err)


def ldp_to_qp_solution(ldp: LDPData, u: torch.Tensor) -> torch.Tensor:
    """x = Rinv (u - v)  (``ldp2qp_solution``, daqp.c:111-139)."""
    return torch.matmul(ldp.Rinv, (u - ldp.v)[..., None])[..., 0]
