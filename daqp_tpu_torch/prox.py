"""Constants of the proximal-point outer loop.

The port's own copy of ``daqp_tpu/prox.py:32-52`` (``_auto_eta``,
``_auto_eta_static``): the fixed-point tolerance eta of the proximal
iteration (daqp_prox.c:43-48).  The batched semidefinite driver that uses
it is ``batch.solve_batch_prox_kernel``.
"""
from __future__ import annotations

from .types import Settings

DEFAULT_DUAL_TOL = 1e-12
AUTO_ETA_CAP = 1e-6


def auto_eta(st: Settings) -> float:
    """eta_prox, or with eta_prox < 0 the automatic choice: 0.1 dual_tol
    when dual_tol is not the reference default, capped at 1e-6."""
    if float(st.eta_prox) >= 0:
        return float(st.eta_prox)
    if float(st.dual_tol) != DEFAULT_DUAL_TOL:
        return float(min(AUTO_ETA_CAP, 0.1 * float(st.dual_tol)))
    return float(AUTO_ETA_CAP)
