"""K1: batched Cholesky + triangular inverse, and the regularized
factorization built on it.

Counterparts: ``daqp_tpu/ops/chol.py:607 batched_chol_rinv_tile`` (the
TPU kernel ``_tile_chol_kernel_loop``, :235) and ``:779
batched_rinv_regularized``.  ``chol_rinv`` launches the CUDA kernel
(``csrc/chol_rinv.cu``) on a CUDA tensor and runs ``chol_rinv_plain`` on
a CPU tensor.
"""
from __future__ import annotations

import torch

from . import _build, host_any

TINY = 1e-30
launches = 0        # kernel launches of chol_rinv (reset by the caller)


def chol_rinv_plain(H: torch.Tensor) -> torch.Tensor:
    """(B, n, n) SPD -> (B, n, n) upper Rinv with H = R'R, in torch ops:
    the right-looking Cholesky with pivots clamped to ``TINY``, then the
    row-wise forward substitution X = L^{-1}; returns X'."""
    B, n, _ = H.shape
    A = H.clone()
    tiny_t = torch.tensor(TINY, dtype=H.dtype, device=H.device)
    for j in range(n):
        piv = torch.sqrt(torch.maximum(A[:, j, j], tiny_t))
        col = A[:, j + 1:, j] / piv[:, None]
        A[:, j, j] = piv
        A[:, j + 1:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    L = torch.tril(A)
    X = torch.zeros_like(A)
    for i in range(n):
        inv = 1.0 / L[:, i, i]
        acc = (L[:, i, :i, None] * X[:, :i, :i]).sum(1)
        X[:, i, :i] = -inv[:, None] * acc
        X[:, i, i] = inv
    return X.transpose(1, 2).contiguous()


def chol_rinv(H: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for a CUDA tensor (f32, contiguous
    (B, n, n)), the plain twin for a CPU tensor."""
    global launches
    if H.device.type == "cpu":
        return chol_rinv_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"chol_rinv: unsupported device {H.device}")
    if H.dtype != torch.float32:
        raise TypeError(f"chol_rinv: CUDA kernel takes float32, got {H.dtype}")
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(
            f"chol_rinv: expected (B, n, n), got {tuple(H.shape)}")
    if not H.is_contiguous():
        raise ValueError("chol_rinv: H must be contiguous")
    B, n, _ = H.shape
    out = torch.empty_like(H)
    if B == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(H.device).cuda_stream
    _build.check(lib.chol_rinv_f32(H.data_ptr(), out.data_ptr(), B, n,
                                   TINY, stream), "chol_rinv_f32")
    launches += 1
    return out


def _attempt(Hb: torch.Tensor, sqrt_zt: torch.Tensor):
    Rinv = chol_rinv(Hb)
    rd = torch.diagonal(Rinv, dim1=1, dim2=2)
    piv = 1.0 / torch.clamp(rd * rd, min=1e-38)          # pivots of R'R
    finite = torch.isfinite(Rinv).all(dim=2).all(dim=1)
    ok = finite & (piv.amin(1) > sqrt_zt * piv.amax(1))
    return Rinv, ok


def batched_rinv_regularized(H: torch.Tensor, st):
    """Per-lane factorization with the reference's full-shift
    retry-doubling regularization (utils.c:253-283).

    Returns ``(Rinv, ok, reg_mask, eps_used)`` as the JAX function does:
    ``ok`` False marks a nonconvex lane, ``reg_mask`` a lane that needed
    H + eps I (eps0 = max(eps_prox, sqrt(zero_tol) max|diag H|), doubled
    at most 16 times), ``eps_used`` its shift.  Retries factor only the
    failing lanes; each lane's result depends on that lane alone."""
    B, n, _ = H.shape
    dtype, dev = H.dtype, H.device
    zero_tol = torch.tensor(st.zero_tol, dtype=dtype, device=dev)
    sqrt_zt = torch.sqrt(zero_tol)
    Hs = 0.5 * (H + H.transpose(1, 2))
    scale = torch.diagonal(Hs, dim1=1, dim2=2).abs().amax(1)
    if st.eps_prox > 0:
        eps = torch.maximum(torch.tensor(st.eps_prox, dtype=dtype,
                                         device=dev), sqrt_zt * scale)
    else:
        eps = torch.full((B,), st.eps_prox, dtype=dtype, device=dev)
    R, ok = _attempt(Hs.contiguous(), sqrt_zt)
    ok0 = ok.clone()
    eps_used = torch.zeros(B, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    tries = 0
    while tries < 16 and host_any(~ok):
        idx = torch.nonzero(~ok).squeeze(1)
        R1, ok1 = _attempt(Hs[idx] + eps[idx, None, None] * eye, sqrt_zt)
        R[idx] = R1
        eps_used[idx] = torch.where(ok1, eps[idx], eps_used[idx])
        ok[idx] = ok1
        eps = eps * 2.0
        tries += 1
    return R, ok, (~ok0) & ok, eps_used
