"""Batched Cholesky + triangular inverse: K1, B8, B9 and B10, the
regularized factorization built on K1, and the XLA-only formulations.

Counterparts in ``daqp_tpu/ops/chol.py``, each computing Rinv = (L^{-1})'
(upper, H = R'R) of a batch of SPD (B, n, n) matrices with pivots
clamped to ``TINY``:

* ``chol_rinv`` (K1, ``csrc/chol_rinv.cu``): ``:607 batched_chol_rinv_tile``
  (the TPU kernel ``_tile_chol_kernel_loop``, :235); twin
  ``chol_rinv_plain``;
* ``chol_rinv_lanes`` (B8, ``csrc/chol_lanes.cu``): ``:127
  batched_chol_rinv_pallas`` (``_chol_kernel``, :22), the lanes-last
  round-1 kernel; twin ``chol_rinv_lanes_plain``;
* ``chol_rinv_dense`` (B9, ``csrc/chol_dense.cu``): ``:563
  batched_chol_rinv_dense`` (``_chol_kernel_dense``, :448); twin
  ``chol_rinv_dense_plain``;
* ``chol_rinv_blk`` (B10, ``csrc/chol_blk.cu``): ``:644
  batched_chol_rinv_blk`` (``_tile_chol_kernel_blk``, :319), panel-8;
  twin ``chol_rinv_blk_plain``, whose order no panel width changes (the
  kernel's panels are 32 wide);
* ``batched_rinv_regularized`` (:779), dispatched by n
  (``factor_route``): K1 up to n = 128, B10 while its block fits, the
  library's Cholesky beyond;
* in torch ops, as the JAX package leaves them to XLA:
  ``batched_chol_rinv`` (:843), ``batched_invsqrt`` (:84) and
  ``batched_chol_rinv_mxu`` (:722, with ``_chol_small_inv``, :692).

K1 and B9 compute the same function in the same expression order and
run one warp-per-matrix body (``csrc/chol_warp.cuh``), each under its own
kernel name and launch count.  Each kernel wrapper launches its CUDA
kernel on a CUDA tensor (f32, contiguous (B, n, n)) and runs its twin on
a CPU tensor; a shape whose block needs more shared memory than the card
allows, or past K1's and B9's 256 columns, raises ValueError before
launch (``smem``).  The twins follow their TPU kernel's
expression order; the padding, one-hot masks and lane tiles of the TPU
layouts are left behind.
"""
from __future__ import annotations

import torch

from . import _build, host_any, smem

TINY = 1e-30
PB = 8              # the TPU kernels' panel width: B10's twin, the MXU form
LANE_TILES = (32, 16, 8, 4, 2, 1)   # B8's lanes per block (chol_lanes.cu)
LANES_BUDGET = 48 * 1024            # B8's preferred bytes of shared memory
WARP_TILES = (8, 4, 2, 1)           # K1's and B9's matrices (warps) a block
WARP_BUDGET = 48 * 1024             # their preferred bytes of shared memory
WARP_MAX_N = 256                    # chol_warp.cuh: 32 kMaxGroups columns
WARP_ROUTE_N = 128                  # factor_route's K1 columns, then B10
WARP_P = (4, 8)                     # chol_warp.cuh kWarpsP: warps a matrix
WARP_SMALL_PER_SM = 8               # warp_shape's switch (matrices an SM)
# kernel launches of chol_rinv (K1), chol_rinv_lanes (B8), chol_rinv_dense
# (B9) and chol_rinv_blk (B10); the caller resets them
launches = 0
lanes_launches = 0
dense_launches = 0
blk_launches = 0


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


def _unblocked_rinv(H: torch.Tensor, by_row: bool) -> torch.Tensor:
    """The round-1 formulation (B8 and ``batched_chol_rinv``): step j
    takes row j (``by_row``) or column j of the symmetric working matrix,
    scales it from the diagonal on by piv = sqrt(max(d, TINY)) (so
    L[j, j] = d / piv), and subtracts its outer product from the rows
    below; then X[i] = (e_i - sum_{k<i} L[i, k] X[k]) / L[i, i]."""
    B, n, _ = H.shape
    A = H.clone()
    Lt = torch.zeros_like(A)                   # Lt[:, j, i] = L[i, j]
    tiny_t = torch.tensor(TINY, dtype=H.dtype, device=H.device)
    below = torch.arange(n, device=H.device)
    for j in range(n):
        v = A[:, j, :] if by_row else A[:, :, j]
        piv = torch.sqrt(torch.maximum(v[:, j], tiny_t))
        coln = v / piv[:, None] * (below >= j).to(H.dtype)
        Lt[:, j] = coln
        A[:, j + 1:] -= coln[:, j + 1:, None] * coln[:, None, :]
    X = torch.zeros_like(A)
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    for i in range(n):
        acc = (Lt[:, :i, i, None] * X[:, :i]).sum(1)
        X[:, i] = (eye[i] - acc) / Lt[:, i, i, None]
    return X.transpose(1, 2).contiguous()


def chol_rinv_lanes_plain(H: torch.Tensor) -> torch.Tensor:
    """B8's twin: ``_chol_kernel``'s expressions (row j read by
    symmetry, L[j, j] = d / piv, division in the substitution)."""
    return _unblocked_rinv(H, by_row=True)


def batched_chol_rinv(H: torch.Tensor) -> torch.Tensor:
    """``daqp_tpu/ops/chol.py:843``: B8's expressions with column j read
    instead of row j (the same for symmetric H).  A non-PD lane gives a
    zero, negative or NaN diagonal that the caller's guards catch."""
    return _unblocked_rinv(H, by_row=False)


def chol_rinv_dense_plain(H: torch.Tensor) -> torch.Tensor:
    """B9's twin, ``_chol_kernel_dense``'s steps without its masks: per
    column j one pass downdates the trailing matrix and writes column j
    (piv on the diagonal, zeros above); per row i one pass accumulates
    sum_{k<i} L[i, k] X[k, :] and writes row i of X in place (-inv acc,
    inv, zeros)."""
    B, n, _ = H.shape
    A = H.clone()
    tiny_t = torch.tensor(TINY, dtype=H.dtype, device=H.device)
    idx = torch.arange(n, device=H.device)
    for j in range(n):
        col = A[:, :, j]
        piv = torch.sqrt(torch.maximum(col[:, j], tiny_t))
        colL = torch.where(idx > j, col / piv[:, None], 0.0)
        Lcol = colL + (idx == j).to(H.dtype) * piv[:, None]
        A -= colL[:, :, None] * colL[:, None, :]
        A[:, :, j] = Lcol
    for i in range(n):
        inv = 1.0 / A[:, i, i]
        acc = (A[:, :i] * A[:, i, :i, None]).sum(1)
        row = torch.where(idx == i, inv[:, None], -inv[:, None] * acc)
        A[:, i] = torch.where(idx > i, 0.0, row)
    return A.transpose(1, 2).contiguous()


def chol_rinv_blk_plain(H: torch.Tensor, pb: int = PB) -> torch.Tensor:
    """B10's twin, ``_tile_chol_kernel_blk``'s panel order (``pb`` = 8)
    with a ragged last panel instead of identity padding.  Phase 1 per
    ``pb``-column panel: micro-steps (pivot, column, downdate of the
    panel's remaining columns), then one rank-``pb`` downdate of the
    trailing columns, t ascending.  Phase 2 per ``pb`` rows: the
    off-block sums over the finished rows k < i0 in ascending k, then the
    diagonal solve row by row.  Every element takes its terms in the same
    ascending order at any ``pb``, so the result does not depend on it
    (``tests/test_torch_chol_kernels.py`` holds 16, 32 and 64 to 8 bit
    for bit)."""
    B, n, _ = H.shape
    A = H.clone()
    tiny_t = torch.tensor(TINY, dtype=H.dtype, device=H.device)
    idx = torch.arange(n, device=H.device)
    for j0 in range(0, n, pb):
        j1 = min(j0 + pb, n)
        for j in range(j0, j1):
            piv = torch.sqrt(torch.maximum(A[:, j, j], tiny_t))
            col = torch.where(idx > j, A[:, :, j] / piv[:, None], 0.0)
            A[:, :, j] = col + (idx == j).to(H.dtype) * piv[:, None]
            if j + 1 < j1:
                cpan = A[:, j + 1:j1, j]
                A[:, :, j + 1:j1] -= col[:, :, None] * cpan[:, None, :]
        if j1 < n:
            pan = A[:, :, j0:j1] * (idx[:, None] > torch.arange(
                j0, j1, device=H.device)).to(H.dtype)   # strictly below
            blk = A[:, :, j1:]
            for t in range(j1 - j0):
                blk = blk - pan[:, :, t, None] * pan[:, None, j1:, t]
            A[:, :, j1:] = blk
    for i0 in range(0, n, pb):
        i1 = min(i0 + pb, n)
        P = A[:, i0:i1].clone()                         # L rows
        acc = torch.zeros_like(P)
        for k in range(i0):
            acc = acc + P[:, :, k, None] * A[:, None, k]
        rows = []
        for t, i in enumerate(range(i0, i1)):
            inv = 1.0 / P[:, t, i]
            r = acc[:, t]
            for s in range(t):
                r = r + P[:, t, i0 + s, None] * rows[s]
            row = torch.where(idx == i, inv[:, None], -inv[:, None] * r)
            rows.append(torch.where(idx > i, 0.0, row))
        A[:, i0:i1] = torch.stack(rows, 1)
    return A.transpose(1, 2).contiguous()


def _cuda_input(fn: str, H: torch.Tensor) -> None:
    if H.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {H.device}")
    if H.dtype != torch.float32:
        raise TypeError(f"{fn}: CUDA kernel takes float32, got {H.dtype}")
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"{fn}: expected (B, n, n), got {tuple(H.shape)}")
    if not H.is_contiguous():
        raise ValueError(f"{fn}: H must be contiguous")


def _stream(H: torch.Tensor):
    return torch.cuda.current_stream(H.device).cuda_stream


def warp_tile(B: int, n: int, limit: int, sms: int) -> int:
    """K1's and B9's matrices (warps) per block: the most of 8, 4, 2, 1
    whose block fits in the 48 KB a block gets without opting in while
    ceil(B / warps) blocks still give each of the ``sms`` SMs one; else 1
    (whose block may opt in to ``limit``: ``smem.check`` raises past it).
    At n = 50: 8 warps (43.4 KB) from B = 8 * 132 on."""
    cap = min(WARP_BUDGET, limit)
    return next((w for w in WARP_TILES
                 if smem.F32 * smem.chol_warp_floats(n, w) <= cap
                 and -(-B // w) >= sms), 1)


def warp_shape(B: int, n: int, limit: int, sms: int) -> tuple[int, int]:
    """K1's and B9's (matrices a block, warps a matrix).  A batch of at
    most ``WARP_SMALL_PER_SM`` matrices an SM (config 4's retry batch of
    256, the flat grid's batches, the stages batches of 1024), or a width
    at which ``warp_tile`` puts one matrix in a block (n >= 99): one
    matrix a block (``chol_wide``), of the fewest warps of ``WARP_P``
    that give each column group of 32 a warp (4 up to n = 128, then 8).
    A larger batch at a smaller width: one warp a matrix, ``warp_tile``
    matrices a block.  Every shape gives the same bits.  On an H100
    (PERF.md §6) 4 warps beat 8, 16 and 32 at every B of 16-1024
    up to n = 128, 8 beat them past it, and at n = 50 4 warps lead one
    warp a matrix at B = 1024 (7.8 matrices an SM) and trail it at 1320
    (10)."""
    w = warp_tile(B, n, limit, sms)
    if B > WARP_SMALL_PER_SM * sms and w > 1:
        return w, 1
    return 1, next((p for p in WARP_P if 32 * p >= n), WARP_P[-1])


def _warp_launch(fn: str, entry: str, H: torch.Tensor) -> torch.Tensor:
    """K1's or B9's launch on a CUDA tensor, shaped by ``warp_shape``; n
    past ``WARP_MAX_N`` or a block past the card's shared memory raises
    ValueError before launch."""
    _cuda_input(fn, H)
    B, n, _ = H.shape
    if n > WARP_MAX_N:
        raise ValueError(f"{fn}: n={n} is past the {WARP_MAX_N} columns "
                         f"a warp's lanes hold")
    per_block, P = warp_shape(B, n, smem.available(H.device),
                              smem.sms(H.device))
    smem.check(fn, dict(n=n, per_block=per_block, P=P),
               smem.chol_warp_floats(n, per_block) if P == 1
               else smem.chol_wide_floats(n), H.device)
    out = torch.empty_like(H)
    if B > 0:
        _build.check(getattr(_build.library(), entry)(
            H.data_ptr(), out.data_ptr(), B, n, per_block, P, TINY,
            _stream(H)), entry)
    return out


@torch.library.custom_op("daqp_tpu_torch::chol_rinv", mutates_args=(),
                         device_types="cpu")
def _chol_rinv_op(H: torch.Tensor) -> torch.Tensor:
    return chol_rinv_plain(H)


@_chol_rinv_op.register_kernel("cuda")
def _chol_rinv_cuda(H: torch.Tensor) -> torch.Tensor:
    global launches
    out = _warp_launch("chol_rinv (K1)", "chol_rinv_f32", H)
    if H.shape[0]:
        launches += 1
    return out


@_chol_rinv_op.register_fake
def _chol_rinv_fake(H: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(H)


def _op_device(fn: str, H: torch.Tensor) -> None:
    """A registered op's device check before dispatch: its fake impl
    would answer any other device (meta among them) without a launch."""
    if H.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {H.device}")


def chol_rinv(H: torch.Tensor) -> torch.Tensor:
    """K1 wrapper, the registered op ``daqp_tpu_torch::chol_rinv``: one
    warp per matrix (the body K1 shares with B9, ``csrc/chol_warp.cuh``)
    on a CUDA tensor, counted in ``launches`` where it launches; the plain
    twin for a CPU tensor."""
    _op_device("chol_rinv (K1)", H)
    return _chol_rinv_op(H)


def lanes_tile(n: int, limit: int) -> int:
    """B8's matrices (lanes) per block: the most of 32, 16, ..., 1 whose
    packed triangles and row buffers fit in the 48 KB a block gets without
    opting in, else the most that fit in ``limit`` bytes (1 if none does:
    ``smem.check`` then raises).  The 48 KB budget is tuned at n = 50,
    where 8 lanes (5 blocks per SM) beat 16 and 32; at n = 100 it takes 2
    lanes, about 6% slower than 4 (PERF.md §6)."""
    def fits(lb, cap):
        return smem.F32 * smem.chol_lanes_floats(n, lb) <= cap
    return next((lb for lb in LANE_TILES if fits(lb, min(LANES_BUDGET,
                                                           limit))),
                next((lb for lb in LANE_TILES if fits(lb, limit)), 1))


def chol_rinv_lanes(H: torch.Tensor) -> torch.Tensor:
    """B8 wrapper: ``lanes_tile`` matrices per block, their packed
    triangles in shared memory, on a CUDA tensor; H (B, n, n) read and
    Rinv (B, n, n) written by the kernel itself.  The twin on a CPU
    tensor."""
    global lanes_launches
    if H.device.type == "cpu":
        return chol_rinv_lanes_plain(H)
    _cuda_input("chol_rinv_lanes", H)
    B, n, _ = H.shape
    lanes = lanes_tile(n, smem.available(H.device))
    smem.check("chol_rinv_lanes (B8)", dict(n=n, lanes=lanes),
               smem.chol_lanes_floats(n, lanes), H.device)
    out = torch.empty_like(H)
    if B == 0:
        return out
    _build.check(_build.library().chol_lanes_f32(
        H.data_ptr(), out.data_ptr(), B, n, lanes, TINY, _stream(H)),
        "chol_lanes_f32")
    lanes_launches += 1
    return out


def chol_rinv_dense(H: torch.Tensor) -> torch.Tensor:
    """B9 wrapper: one warp per matrix (the body B9 shares with K1) on a
    CUDA tensor; the twin on a CPU tensor."""
    global dense_launches
    if H.device.type == "cpu":
        return chol_rinv_dense_plain(H)
    out = _warp_launch("chol_rinv_dense (B9)", "chol_dense_f32", H)
    if H.shape[0]:
        dense_launches += 1
    return out


@torch.library.custom_op("daqp_tpu_torch::chol_rinv_blk", mutates_args=(),
                         device_types="cpu")
def _chol_rinv_blk_op(H: torch.Tensor) -> torch.Tensor:
    return chol_rinv_blk_plain(H)


@_chol_rinv_blk_op.register_fake
def _chol_rinv_blk_fake(H: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(H)


def chol_rinv_blk(H: torch.Tensor) -> torch.Tensor:
    """B10 wrapper, the registered op ``daqp_tpu_torch::chol_rinv_blk``:
    one block per matrix (64 threads up to n = 64, 128 up to 256, then
    256), panels of 32 columns (the twin's order at any width), the
    matrix in device memory, on a CUDA tensor, counted in
    ``blk_launches`` where it launches; the kernel writes Rinv in place of
    its working matrix.  The twin on a CPU tensor."""
    _op_device("chol_rinv_blk (B10)", H)
    return _chol_rinv_blk_op(H)


@_chol_rinv_blk_op.register_kernel("cuda")
def _chol_rinv_blk_cuda(H: torch.Tensor) -> torch.Tensor:
    global blk_launches
    _cuda_input("chol_rinv_blk", H)
    B, n, _ = H.shape
    smem.check("chol_rinv_blk (B10)", dict(n=n), smem.chol_blk_floats(n),
               H.device)
    out = torch.empty_like(H)
    if B == 0:
        return out
    _build.check(_build.library().chol_blk_f32(
        H.data_ptr(), out.data_ptr(), B, n, TINY, _stream(H)),
        "chol_blk_f32")
    blk_launches += 1
    return out


def pivot_ok(Rinv: torch.Tensor, sqrt_zt: torch.Tensor) -> torch.Tensor:
    """The reference's pivot-ratio test on a factor (utils.c:253-283):
    finite, and the smallest pivot of R'R above sqrt(zero_tol) times the
    largest; (B,) bool."""
    rd = torch.diagonal(Rinv, dim1=1, dim2=2)
    piv = 1.0 / torch.clamp(rd * rd, min=1e-38)          # pivots of R'R
    finite = torch.isfinite(Rinv).all(dim=2).all(dim=1)
    return finite & (piv.amin(1) > sqrt_zt * piv.amax(1))


def factor_route(n: int, limit: int) -> str:
    """The factorization ``batched_rinv_regularized`` runs at width n on a
    card whose blocks may opt in to ``limit`` bytes of shared memory:
    "k1" (``chol_rinv``) up to ``WARP_ROUTE_N`` columns while its block
    of one matrix fits, "b10" (``chol_rinv_blk``) while its block fits
    (n <= 1581 on an H100), else "library" (``library_rinv``: the JAX
    package factors in XLA outside any Pallas kernel,
    ``daqp_tpu/transform.py:57``).  On an H100 (PERF.md §6, in turns at
    B = 16-1024) K1 beats B10 and the library in every pairing
    up to n = 128; past it B10 beats K1 in every pairing but at B = 64
    (n = 150-200, within 0.2% either way between runs), B = 256 (n =
    150-200) and n = 150, B = 1024, where K1 leads by 4-11%."""
    if n <= WARP_ROUTE_N and smem.F32 * smem.chol_wide_floats(n) <= limit:
        return "k1"
    if smem.F32 * smem.chol_blk_floats(n) <= limit:
        return "b10"
    return "library"


def library_rinv(H: torch.Tensor) -> torch.Tensor:
    """Rinv by the library: ``cholesky_ex``, NaN on a lane whose
    factorization fails (``pivot_ok`` rejects it), then a triangular solve
    against I."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    return torch.linalg.solve_triangular(L.transpose(1, 2),
                                         eye.expand_as(H), upper=True)



def _attempt(factor, Hb: torch.Tensor, sqrt_zt: torch.Tensor):
    Rinv = factor(Hb)
    return Rinv, pivot_ok(Rinv, sqrt_zt)


def batched_rinv_regularized(H: torch.Tensor, st, graph: bool = False):
    """Per-lane factorization with the reference's full-shift
    retry-doubling regularization (utils.c:253-283).

    Returns ``(Rinv, ok, reg_mask, eps_used)`` as the JAX function does:
    ``ok`` False marks a nonconvex lane, ``reg_mask`` a lane that needed
    H + eps I (eps0 = max(eps_prox, sqrt(zero_tol) max|diag H|), doubled
    at most 16 times), ``eps_used`` its shift.  Retries factor only the
    failing lanes, found by one host read a try; each lane's result
    depends on that lane alone.  ``graph``: the form ``torch.export``
    traces, with no host read: all 16 tries run on every lane, each
    kept only on the lanes still failing, so a lane gets what the host
    loop gives it.  The factorization is ``factor_route``'s for n and the
    device, decided before any launch."""
    B, n, _ = H.shape
    dtype, dev = H.dtype, H.device
    factor = {"k1": chol_rinv, "b10": chol_rinv_blk,
              "library": library_rinv}[factor_route(n, smem.limit(dev))]
    zero_tol = torch.tensor(st.zero_tol, dtype=dtype, device=dev)
    sqrt_zt = torch.sqrt(zero_tol)
    Hs = 0.5 * (H + H.transpose(1, 2))
    scale = torch.diagonal(Hs, dim1=1, dim2=2).abs().amax(1)
    if st.eps_prox > 0:
        eps = torch.maximum(torch.tensor(st.eps_prox, dtype=dtype,
                                         device=dev), sqrt_zt * scale)
    else:
        eps = torch.full((B,), st.eps_prox, dtype=dtype, device=dev)
    R, ok = _attempt(factor, Hs.contiguous(), sqrt_zt)
    ok0 = ok.clone()
    eps_used = torch.zeros(B, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    if graph:
        for _ in range(16):
            R1, ok1 = _attempt(factor, Hs + eps[:, None, None] * eye,
                               sqrt_zt)
            todo = ~ok
            R = torch.where(todo[:, None, None], R1, R)
            eps_used = torch.where(todo & ok1, eps, eps_used)
            ok = ok | ok1
            eps = eps * 2.0
        return R, ok, (~ok0) & ok, eps_used
    tries = 0
    while tries < 16 and host_any(~ok):
        idx = torch.nonzero(~ok).squeeze(1)
        R1, ok1 = _attempt(factor, Hs[idx] + eps[idx, None, None] * eye,
                           sqrt_zt)
        R[idx] = R1
        eps_used[idx] = torch.where(ok1, eps[idx], eps_used[idx])
        ok[idx] = ok1
        eps = eps * 2.0
        tries += 1
    return R, ok, (~ok0) & ok, eps_used


def batched_invsqrt(H: torch.Tensor, iters: int = 14) -> torch.Tensor:
    """``daqp_tpu/ops/chol.py:84``: (B, n, n) SPD -> symmetric
    S = H^{-1/2} by the coupled Newton-Schulz (Denman-Beavers) iteration,
    batched products only (f32 products in full f32: TF32 is off)."""
    B, n, _ = H.shape
    eye = torch.eye(n, dtype=H.dtype, device=H.device).expand(B, n, n)
    c = (H * H).sum((1, 2), keepdim=True).sqrt()
    Y, Z = H / c, eye
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * torch.matmul(Z, Y)
        Y, Z = torch.matmul(Y, T), torch.matmul(T, Z)
    return Z / torch.sqrt(c)


def _chol_small_inv(A: torch.Tensor, tiny: float):
    """``daqp_tpu/ops/chol.py:692``: (B, p, p) SPD -> (R, Rinv), both
    upper with A = R'R, by an unrolled Cholesky and back-substitution;
    pivots clamp to ``tiny``."""
    B, p, _ = A.shape
    col = torch.arange(p, device=A.device)
    tiny_t = torch.tensor(tiny, dtype=A.dtype, device=A.device)
    rows = []
    for i in range(p):
        acc = A[:, i, :]
        for k in range(i):
            acc = acc - rows[k][:, i:i + 1] * rows[k]
        piv = torch.sqrt(torch.maximum(acc[:, i], tiny_t))
        rows.append(torch.where(col >= i, acc / piv[:, None], 0.0))
    xrows = [None] * p
    for i in reversed(range(p)):
        inv = 1.0 / rows[i][:, i]
        acc = torch.zeros((B, p), dtype=A.dtype, device=A.device)
        for k in range(i + 1, p):
            acc = acc + rows[i][:, k:k + 1] * xrows[k]
        xi = torch.where(col == i, inv[:, None], -inv[:, None] * acc)
        xrows[i] = torch.where(col >= i, xi, 0.0)
    return torch.stack(rows, 1), torch.stack(xrows, 1)


def batched_chol_rinv_mxu(H: torch.Tensor, tiny: float = TINY) -> torch.Tensor:
    """``daqp_tpu/ops/chol.py:722``: blocked right-looking Cholesky and
    blocked back-substitution whose panel and trailing updates are
    batched products, with the 8x8 diagonal blocks by
    ``_chol_small_inv``.  A ragged last block replaces the identity
    padding (the padded block is decoupled: same result)."""
    B, n, _ = H.shape
    A22 = H
    panels = []                       # (Rkk_inv, Rk_rest) per block row
    for k0 in range(0, n, PB):
        p = min(PB, n - k0)
        _, Rkk_inv = _chol_small_inv(A22[:, :p, :p], tiny)
        Rk_rest = torch.matmul(Rkk_inv.transpose(1, 2), A22[:, :p, p:])
        A22 = A22[:, p:, p:] - torch.matmul(Rk_rest.transpose(1, 2),
                                            Rk_rest)
        panels.append((Rkk_inv, Rk_rest))
    Xlow = panels[-1][0]
    for Dinv, Ri_rest in reversed(panels[:-1]):
        p, r = Dinv.shape[-1], Xlow.shape[-1]
        Xi = torch.cat([Dinv, -torch.matmul(
            Dinv, torch.matmul(Ri_rest, Xlow))], dim=2)
        Xlow = torch.cat([Xi, torch.cat([Xlow.new_zeros((B, r, p)), Xlow],
                                        dim=2)], dim=1)
    return Xlow
