"""The yardstick of the roofline shares: a frozen copy of the operation
and byte counts of the repository's chip smoke test (``chip_smoke.py``:
``bound``, ``step_flops``, ``prefix_flops``, ``slot_round_flops``,
``dense_step_flops``, ``sw_step_flops``, ``dense_round_flops``, the
factorization's bytes and operations of ``factor_case``), and the published peaks of one NVIDIA H100
SXM (the data sheet's dense rates).

Counts are of the work these inputs need: each input byte read once and
each output byte written once, a step's operations over the slots it
uses.  Nothing here reads a clock.
"""
from __future__ import annotations

PEAK_F32 = 67e12      # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s of HBM3

# lane states of the port's solver state (daqp_tpu_torch/types.py:
# EXIT_RUNNING, EXIT_CYCLE, EXIT_REFACTOR), as the counts read them
RUNNING, CYCLE, REFACTOR = 99, -2, 90


def bound(n_bytes, flops):
    """The least time the card could take: the bytes at the HBM rate or
    the operations at the f32 peak, whichever is longer."""
    t_b, t_f = n_bytes / PEAK_BYTES, flops / PEAK_F32
    return dict(bound_ms=1e3 * max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=n_bytes, flops=flops)


def factor_bytes(B, n, itemsize=4):
    """K1: each matrix's lower triangle read once, Rinv written once."""
    return itemsize * B * (n * (n + 1) // 2 + n * n)


def factor_flops(B, n):
    """K1: a Cholesky factorization and a triangular inverse a matrix."""
    return B * 2 * n ** 3 / 3


def step_flops(m, n, k):
    """One slot step (slot_step.cuh) over k used slots: u = W'lam* and the
    Gram column W a (2 k n each), mu = M u (2 m n), the W update and the
    pending column W prow (2 k n each), a = E g (2 k^2), the E update
    (~4 k^2) and lam*, a_p = E (.) (4 k^2)."""
    return 2 * m * n + 8 * k * n + 10 * k * k


def prefix_flops(n, k):
    """The round prefix g_p = W prow, lam*, a_p = E (.) over k slots."""
    return 2 * k * n + 4 * k * k


def slot_round_flops(s0, sk, m, n):
    """One K2 round from ``s0`` to ``sk`` (objects with ``used`` (B, K),
    ``iterations`` (B,) and, on ``s0``, ``status`` (B,)): per lane its
    steps and, if it ran, the prefix, at k the mean of its used counts
    before and after the round."""
    k = 0.5 * (s0.used.sum(1) + sk.used.sum(1)).double()
    steps = (sk.iterations - s0.iterations).double()
    ran = (s0.status == RUNNING).double()
    return (steps * step_flops(m, n, k) + ran * prefix_flops(n, k)).sum() \
        .item()


def dense_step_flops(k, m, n):
    """One dense-mask step (dense_round.cu) with k active rows: lam*, a_p
    and a (6 k^2), the rank-one E update (4 k^2), u over the active rows
    (2 k n), mu = M u and the add's Gram column (4 m n)."""
    return 10 * k * k + 2 * k * n + 4 * m * n


def sw_step_flops(k, m, n):
    """A dense-mask step of the SOFT_WEIGHTS variant: the blocker's Gram
    column (2 m n), its Schur column and its rank-one term (4 k^2) on top
    of a soft step."""
    return dense_step_flops(k, m, n) + 4 * k * k + 2 * m * n


def dense_round_flops(s0, sk, n, sw=False):
    """One B7 round from ``s0`` to ``sk`` (objects with ``act_up``,
    ``act_lo`` (B, m) and ``iterations`` (B,)): per lane its steps at k the
    mean of its active counts before and after the round."""
    k = 0.5 * ((s0.act_up + s0.act_lo).sum(1) + (sk.act_up + sk.act_lo)
               .sum(1))
    steps = sk.iterations - s0.iterations
    step = sw_step_flops if sw else dense_step_flops
    return (steps.double() * step(k.double(), s0.act_up.shape[1], n)).sum() \
        .item()


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def state_bytes(state, skip=()):
    """Bytes of a solver state's tensor fields, but those named in
    ``skip``."""
    return nbytes(*(v for k, v in state._asdict().items()
                    if k not in skip and hasattr(v, "element_size")))
