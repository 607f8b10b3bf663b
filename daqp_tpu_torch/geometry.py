"""Polyhedra: the minimal representation and the feasibility test.

Counterpart of ``daqp_tpu/geometry.py:27-130``: ``daqp_minrep``
(src/api.c:507-534, utils.c:699-726) and the raw LDP feasibility solve
with its Farkas certificate (the Julia ``isfeasible``,
api.jl:417-466).  Row i of {x : x[:ms] <= b[:ms], A x <= b[ms:]} is
redundant iff the feasibility LDP with row i forced to equality is
infeasible.  The JAX module runs the m feasibility solves as one
``vmap``; here they run one after another (each result depends on its
row alone).  Rows are used unnormalized, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ldp as ldp_mod
from .api import _host
from .ops import host_read
from .types import (ACTIVE, IMMUTABLE, LOWER, DAQP_INF, EXIT_INFEASIBLE,
                    Settings, as_settings)


def _rows(A, ms: int):
    A = torch.atleast_2d(A)
    n = A.shape[1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return torch.cat([eye[:ms], A]) if ms > 0 else A


def minrep_core(A, b, ms: int, st: Settings) -> torch.Tensor:
    """(m,) int32 on A's device: 1 = redundant, 0 = necessary."""
    M = _rows(A, ms)
    m, n = b.shape[0], M.shape[1]
    dlower = torch.full((m,), -DAQP_INF, dtype=M.dtype, device=M.device)
    out = []
    for i in range(m):
        sense = torch.zeros(m, dtype=torch.int32, device=M.device)
        sense[i] = ACTIVE | IMMUTABLE
        state = ldp_mod.init_state(M, b, dlower, sense, K=n + 1)
        _, state = ldp_mod.activate_constraints(state, st)
        state = ldp_mod.ldp_solve(state, st)
        out.append(int(state.status == EXIT_INFEASIBLE))
    return torch.tensor(out, dtype=torch.int32, device=M.device)


def feasibility_core(A, bupper, blower, sense, ms: int, st: Settings):
    """The raw LDP min ||u|| s.t. bl <= [u[:ms]; A u] <= bu (the explicit
    MPC region query, Julia ``init_c_workspace_ldp``).  Returns
    (feasible, farkas_err, state): when infeasible, the working set's
    duals lam >= 0 are a Farkas certificate (A_W' lam = 0, b_W' lam < 0),
    and farkas_err = b_W' lam + ||A_W' lam|| (api.jl:450-462) should be
    <= 0; 0 when feasible."""
    M = _rows(A, ms)
    m, n = bupper.shape[0], M.shape[1]
    state = ldp_mod.init_state(M, bupper, blower, sense, K=n + 1)
    _, state = ldp_mod.activate_constraints(state, st)
    state = ldp_mod.ldp_solve(state, st)
    feasible = state.status > 0
    if state.status != EXIT_INFEASIBLE:
        return feasible, 0.0, state
    k = state.n_active
    lam = state.lam_star[:k]
    ws = state.WS[:k]
    b_w = torch.where((state.sense[ws] & LOWER) > 0, blower[ws], bupper[ws])
    err = b_w @ lam + torch.linalg.vector_norm(state.Mw[:k].T @ lam)
    return feasible, host_read(err), state


def _settings(settings, dtype) -> Settings:
    return settings if isinstance(settings, Settings) \
        else as_settings(settings, dtype)


def isfeasible(A, bupper, blower, ms=None, sense=None, settings=None,
               validate: bool = False, dtype=None, device=None) -> bool:
    """True iff {u : bl <= [u[:ms]; A u] <= bu} is not empty (the Julia
    ``isfeasible``, api.jl:444-466).  ``validate=True`` checks an
    infeasible verdict against its Farkas certificate."""
    from .batch import resolve_device
    dev = resolve_device((A, bupper, blower, sense), device)
    dtype = torch.get_default_dtype() if dtype is None else dtype

    def t(x):
        return torch.as_tensor(_host(x, np.float64), device=dev).to(dtype)

    A, bupper, blower = torch.atleast_2d(t(A)), torch.atleast_1d(t(bupper)), \
        torch.atleast_1d(t(blower))
    m = bupper.shape[0]
    ms = m - A.shape[0] if ms is None else int(ms)
    sense = torch.zeros(m, dtype=torch.int32, device=dev) if sense is None \
        else torch.as_tensor(_host(sense, np.int32), device=dev)
    ok, err, _ = feasibility_core(A, bupper, blower, sense, ms,
                                  _settings(settings, dtype))
    if validate and not ok:
        assert err <= 1e-6, \
            f"Farkas certificate validation failed (err={err})"
    return bool(ok)


def minrep(A, b, ms=None, settings=None, dtype=None, device=None):
    """An (m,) int numpy array: 1 = redundant, 0 = necessary (the Python
    binding's ``daqp.minrep``, interfaces/daqp-python/daqp.pyx:635-651)."""
    from .batch import resolve_device
    dev = resolve_device((A, b), device)
    dtype = torch.get_default_dtype() if dtype is None else dtype
    A = torch.atleast_2d(torch.as_tensor(_host(A, np.float64), device=dev)
                         .to(dtype))
    b = torch.atleast_1d(torch.as_tensor(_host(b, np.float64), device=dev)
                         .to(dtype))
    ms = b.shape[0] - A.shape[0] if ms is None else int(ms)
    return minrep_core(A, b, ms, _settings(settings, dtype)).cpu().numpy()
