"""The benchmark's QP generator, on the device, from a seed.

A PyTorch rewrite of DAQP's test fixture (``generate_test_qp`` in
``interfaces/daqp-julia/test/utils.jl:3-53``, batched as the repository's
``tests/gen.py`` ``generate_test_qp_batch`` batches it): each QP is built
around an optimizer known in closed form.  H = T'T with cond(H) = kappa
(eigenvalues 1, kappa and the rest uniform between), ``n_active`` rows
tight at the optimum with multipliers uniform in (0, 1), the other rows
strictly feasible with a slack of 0.01 + U(0, 1) on each side.  Every
draw comes from one ``torch.Generator`` on the device, in a few large
calls, in float64; the caller casts the data to the type it is served in.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    that fits in 64 bits once reduced modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _rand(g, *shape):
    return torch.rand(shape, generator=g, dtype=F64, device=g.device)


def _randn(g, *shape):
    return torch.randn(shape, generator=g, dtype=F64, device=g.device)


def orthonormal(G: torch.Tensor) -> torch.Tensor:
    """The orthonormal factor Q of G = QR with R's diagonal positive, by
    CholeskyQR2 (two passes of Q = G R^-1, R'R = G'G): a few batched
    calls for the whole batch.  A Gaussian draw is now and then so ill
    conditioned (cond(G) past ~1e8, about one matrix in a run's 163840)
    that G'G is not positive definite in float64, or the two passes leave
    Q short of orthonormal; those matrices alone are factored again by
    Householder QR, which gives the same Q."""
    Q, bad = G, torch.zeros(G.shape[0], dtype=torch.bool, device=G.device)
    for _ in range(2):
        R, info = torch.linalg.cholesky_ex(Q.transpose(1, 2) @ Q,
                                           upper=True)
        bad |= info != 0
        R = torch.where(bad[:, None, None],
                        torch.eye(G.shape[-1], dtype=G.dtype,
                                  device=G.device), R)
        Q = torch.linalg.solve_triangular(R, Q, upper=True, left=False)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    err = (Q.transpose(1, 2) @ Q - eye).abs().amax((1, 2))
    bad |= ~(err <= 1e-12)
    idx = torch.nonzero(bad).flatten()
    if idx.numel():
        Qh, Rh = torch.linalg.qr(G[idx])
        sgn = torch.where(torch.diagonal(Rh, dim1=1, dim2=2) < 0, -1.0, 1.0)
        Q = Q.index_copy(0, idx, Qh * sgn.to(G.dtype)[:, None, :])
    return Q


def qp_batch(g: torch.Generator, B: int, n: int, m: int, ms: int,
             n_active: int, kappa: float) -> dict:
    """B QPs ``min 0.5 x'Hx + f'x  s.t.  blower <= [x[:ms]; A x] <= bupper``
    with their optimizers: a dict of float64 tensors x (B, n), H (B, n, n),
    f (B, n), A (B, m - ms, n), bupper, blower (B, m), and the construction's
    active set: ``active`` (B, m) bool and ``upper`` (B, m) bool (the side
    of an active row)."""
    eig = torch.empty((B, n), dtype=F64, device=g.device)
    eig[:, 0], eig[:, 1] = 1.0, kappa
    eig[:, 2:] = 1.0 + (kappa - 1.0) * _rand(g, B, n - 2)
    Q = orthonormal(_randn(g, B, n, n))
    sq = eig.sqrt()
    T = sq[:, :, None] * Q.transpose(1, 2)             # diag(sq) Q'
    Tinv = Q / sq[:, None, :]
    H = torch.einsum('bij,bik->bjk', T, T)              # T'T
    H = 0.5 * (H + H.transpose(1, 2))

    M = torch.cat([Tinv[:, :ms, :], _randn(g, B, m - ms, n)], 1)
    perm = torch.argsort(_rand(g, B, m), 1)
    act, inact = perm[:, :n_active], perm[:, n_active:]
    is_up = _rand(g, B, n_active) < 0.5
    lam = _rand(g, B, n_active)
    sgn = torch.where(is_up, 1.0, -1.0).to(F64)
    Mact = torch.gather(M, 1, act[:, :, None].expand(B, n_active, n))
    u = -torch.einsum('bij,bi->bj', sgn[:, :, None] * Mact, lam)
    val = torch.einsum('bij,bj->bi', Mact, u)           # M_i u, tight rows
    gap_up, gap_lo = 0.01 + _rand(g, B, n_active), 0.01 + _rand(g, B, n_active)
    dupper = torch.zeros((B, m), dtype=F64, device=g.device)
    dlower = torch.zeros_like(dupper)
    dupper.scatter_(1, act, torch.where(is_up, val, val + gap_up))
    dlower.scatter_(1, act, torch.where(is_up, val - gap_lo, val))
    Min = torch.gather(M, 1, inact[:, :, None].expand(B, m - n_active, n))
    mu = torch.einsum('bij,bj->bi', Min, u)
    dupper.scatter_(1, inact, mu + 0.01 + _rand(g, B, m - n_active))
    dlower.scatter_(1, inact, mu - 0.01 - _rand(g, B, m - n_active))

    v = _randn(g, B, n)
    f = torch.einsum('bij,bi->bj', T, v)                # T'v
    x = torch.einsum('bij,bj->bi', Tinv, u - v)         # T^-1 (u - v)
    A = torch.matmul(M[:, ms:, :], T)
    Mv = torch.einsum('bij,bj->bi', M, v)
    active = torch.zeros((B, m), dtype=torch.bool, device=g.device)
    active.scatter_(1, act, True)
    upper = torch.zeros_like(active)
    upper.scatter_(1, act, is_up)
    return dict(x=x, H=H, f=f, A=A, bupper=dupper - Mv, blower=dlower - Mv,
                active=active, upper=upper)
