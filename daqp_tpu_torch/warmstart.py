"""Warm starts: a starting working set from a primal or dual point, as
sense bits that ``ldp.activate_constraints`` then activates.

Counterpart of ``daqp_tpu/warmstart.py``: ``daqp_primal_init_active``
(src/api.c:555-592), ``daqp_dual_init_active`` (:596-609) and
``daqp_first_violating`` (:538-550).  Tensors on any one device.
"""
from __future__ import annotations

import torch

from .types import ACTIVE, IMMUTABLE, LOWER


def _rows(x, A, ms: int):
    Ax = torch.atleast_2d(A) @ x
    return torch.cat([x[:ms], Ax]) if ms > 0 else Ax


def primal_init_active(x, A, bupper, blower, sense, ms: int, tol=1e-9):
    """Mark the mutable rows tight at ``x`` ACTIVE (at the upper bound,
    else the lower one with LOWER); returns the new sense (int32)."""
    vals = _rows(x, A, ms)
    sense = sense.to(torch.int32)
    up_tight = (vals - bupper).abs() < tol
    lo_tight = (vals - blower).abs() < tol
    mutable = (sense & IMMUTABLE) == 0
    sense = torch.where(mutable & up_tight, (sense | ACTIVE) & ~LOWER, sense)
    sense = torch.where(mutable & ~up_tight & lo_tight,
                        sense | (ACTIVE | LOWER), sense)
    return sense.to(torch.int32)


def dual_init_active(lam, sense, tol=1e-12):
    """Mark the mutable rows ACTIVE by the sign of their dual (negative:
    LOWER); returns the new sense (int32)."""
    sense = sense.to(torch.int32)
    mutable = (sense & IMMUTABLE) == 0
    sense = torch.where(mutable & (lam > tol), (sense | ACTIVE) & ~LOWER,
                        sense)
    sense = torch.where(mutable & (lam < -tol), sense | (ACTIVE | LOWER),
                        sense)
    return sense.to(torch.int32)


def first_violating(x, A, bupper, blower, ms: int, tol=0.0):
    """The index of the first row violated at ``x`` (a 0-d int64 tensor),
    m if none."""
    vals = _rows(x, A, ms)
    viol = (vals > bupper + tol) | (vals < blower - tol)
    return torch.where(viol.any(), torch.argmax(viol.to(torch.int8)),
                       torch.tensor(bupper.shape[0], device=viol.device))
