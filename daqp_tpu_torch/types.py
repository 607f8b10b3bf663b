"""Settings, constraint-sense bits and exit flags of the PyTorch port.

Counterpart of ``daqp_tpu/types.py`` (sense bits :26-31, exit flags
:36-56, ``Settings`` :87-114, ``default_settings_f32`` :121-148,
``SoftWeights`` :151, ``Problem`` :167, ``Result`` :188), of
``daqp_tpu/api.py:24 _as_settings`` and of ``daqp_tpu/ldp_flat.py:65
EXIT_REFACTOR``.  Same names, values and defaults; no jax.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# constraint sense bit flags (reference constants.h:57-89)
ACTIVE = 1
LOWER = 2
IMMUTABLE = 4
SOFT = 8
BINARY = 16
SLACK_FIXED = 32

# exit flags (reference constants.h:37-45)
EXIT_SOFT_OPTIMAL = 2
EXIT_OPTIMAL = 1
EXIT_INFEASIBLE = -1
EXIT_CYCLE = -2
EXIT_UNBOUNDED = -3
EXIT_ITERLIMIT = -4
EXIT_NONCONVEX = -5
EXIT_OVERDETERMINED_INITIAL = -6
EXIT_TIMELIMIT = -7
# hierarchical only: a level failed, no degrees of freedom remain
# (daqp_tpu/hierarchical.py:38, hierarchical.c:104)
EXIT_NO_DOF = 3
# the lane carries sense bits the hard-only slot kernel does not support
EXIT_UNSUPPORTED = -9
# internal: still running (never returned to the user)
EXIT_RUNNING = 99
# internal: a removal hit an unstable pivot; the lane waits for the
# host loop's exact refactorization of E
EXIT_REFACTOR = 90

DAQP_INF = 1e30

FLAG_TO_STATUS = {
    EXIT_SOFT_OPTIMAL: "soft_optimal",
    EXIT_OPTIMAL: "optimal",
    EXIT_NO_DOF: "no_dof_remaining",
    EXIT_INFEASIBLE: "infeasible",
    EXIT_CYCLE: "cycle",
    EXIT_UNBOUNDED: "unbounded",
    EXIT_ITERLIMIT: "iteration_limit",
    EXIT_NONCONVEX: "nonconvex",
    EXIT_OVERDETERMINED_INITIAL: "overdetermined_initial_working_set",
    EXIT_TIMELIMIT: "time_limit",
    EXIT_UNSUPPORTED: "unsupported_sense_for_kernel",
}

PRICING_DANTZIG = 0
PRICING_BLAND = 1


class SoftWeights(NamedTuple):
    """Per-row slack bounds and per-side weights of the reference's
    SOFT_WEIGHTS build (types.h:168-180, auxiliary.c:199-274), each
    (B, m) in raw user units; read on SOFT rows only.  A soft row's upper
    side relaxes to ``bupper + sqrt(rho_us) t`` with the penalty
    0.5 (t + d_us sqrt(rho_us))^2, its lower side likewise."""
    d_ls: torch.Tensor
    d_us: torch.Tensor
    rho_ls: torch.Tensor
    rho_us: torch.Tensor


class Settings(NamedTuple):
    """Solver settings; the defaults are the reference's f64 defaults."""
    primal_tol: float = 1e-6
    dual_tol: float = 1e-12
    zero_tol: float = 1e-11
    pivot_tol: float = 1e-6
    progress_tol: float = 1e-14
    cycle_tol: int = 10
    iter_limit: int = 10000
    fval_bound: float = DAQP_INF
    eps_prox: float = 1e-6
    eta_prox: float = -1.0
    rho_soft: float = 1e-6
    rel_subopt: float = 0.0
    abs_subopt: float = 0.0
    sing_tol: float = 3.7e-11
    refactor_tol: float = 1e-9
    time_limit: float = 0.0
    pricing: int = PRICING_DANTZIG


def default_settings_f32() -> Settings:
    """The f32-safe settings of ``daqp_tpu.types.default_settings_f32``
    (the reference's f64 tolerances sit below f32 resolution)."""
    return Settings(primal_tol=3e-5, dual_tol=1e-6, zero_tol=1e-6,
                    pivot_tol=1e-4, progress_tol=1e-7, sing_tol=1e-6,
                    refactor_tol=1e-5, rho_soft=1e-4)


def as_settings(settings, dtype) -> Settings:
    """None or a dict of overrides -> ``Settings`` on the defaults that
    suit ``dtype``; a ``Settings`` passes through."""
    if settings is None or isinstance(settings, dict):
        base = (default_settings_f32() if dtype == torch.float32
                else Settings())
        return base._replace(**(settings or {}))
    return settings


class Problem(NamedTuple):
    """A dense QP instance (types.h:14-50):

    minimize    0.5 x' H x + f' x
    subject to  blower[:ms] <= x[:ms] <= bupper[:ms]
                blower[ms:] <= A x    <= bupper[ms:]

    H is None for an LP; A has shape (m - ms, n); ``sense`` holds the
    per-row bit flags; ``break_points`` the hierarchy's levels."""
    H: Optional[torch.Tensor]
    f: Optional[torch.Tensor]
    A: torch.Tensor
    bupper: torch.Tensor
    blower: torch.Tensor
    sense: Optional[torch.Tensor] = None
    ms: int = 0
    break_points: Optional[tuple] = None


class Result(NamedTuple):
    """A single-instance solve's result (include/api.h:14-26): x, lam
    (m,) and fval, soft_slack (0-d) as tensors on the solve's device; the
    exit flag, iteration and node counts as Python ints."""
    x: torch.Tensor
    lam: torch.Tensor
    fval: torch.Tensor
    exitflag: int
    iterations: int
    soft_slack: torch.Tensor
    nodes: int
    solve_time: float = 0.0
    setup_time: float = 0.0

    @property
    def status(self) -> str:
        return FLAG_TO_STATUS.get(int(self.exitflag), "unknown")
