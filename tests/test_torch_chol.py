"""K1 (daqp_tpu_torch.ops.chol): the plain twin of the CUDA Cholesky +
inverse kernel against the JAX tile kernel it replaces
(``ops/chol.py batched_chol_rinv_tile``, Pallas interpret mode) and the
regularized factorization against JAX's ``batched_rinv_regularized``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu.api import _as_settings
from daqp_tpu.ops import chol
from daqp_tpu_torch import convert
from daqp_tpu_torch.ops import chol as pchol


def _spd_batch(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    return np.einsum('bij,bkj->bik', A, A) + np.eye(n)


# The twin runs the same per-element arithmetic as the TPU kernel; only
# the inverse's row sums are taken in another order.  f64 leaves ~1e-14
# relative, f32 ~1e-6; the gates sit well above either.
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-4)])
@pytest.mark.parametrize("n", [8, 13])
def test_chol_twin_matches_tile_kernel(n, dtype, rtol):
    H = _spd_batch(128, n, seed=n).astype(dtype)
    Rj = np.asarray(jax.jit(lambda h: chol.batched_chol_rinv_tile(
        h, interpret=True))(jnp.asarray(H)))
    Rp = pchol.chol_rinv(torch.as_tensor(H)).numpy()
    assert Rp.dtype == dtype
    assert np.abs(np.tril(Rp, -1)).max() == 0.0          # upper triangular
    assert np.abs(Rp - Rj).max() <= rtol * np.abs(Rj).max()


def test_rinv_regularized_matches_jax():
    # f64 with the reference settings, as test_chol_ops.py:47 does in its
    # own setup: lane 3 singular (rank 1) needs the full-shift retry;
    # lane 5 is mildly indefinite (a few doublings fix it); lane 7 is
    # strongly indefinite (16 doublings do not: nonconvex)
    n = 9
    st = _as_settings(None, jnp.float64)
    H = _spd_batch(128, n, seed=4)
    H[3] = np.outer(np.arange(n), np.arange(n))
    H[5] = np.diag(np.r_[np.ones(n - 1), -1e-5])
    H[7] = np.diag(np.r_[np.ones(n - 1), -1.0])
    Rj, okj, regj, epsj = (np.asarray(v) for v in jax.jit(
        lambda h: chol.batched_rinv_regularized(h, st, interpret=True))(
            jnp.asarray(H)))
    Rp, okp, regp, epsp = (v.numpy() for v in pchol.batched_rinv_regularized(
        torch.as_tensor(H), convert.settings_from_jax(st)))
    assert okj[3] and regj[3] and okj[5] and regj[5] and not okj[7]
    # the flags and shifts come from the same f64 max/sqrt/doubling
    # arithmetic on both sides: exact
    np.testing.assert_array_equal(okp, okj)
    np.testing.assert_array_equal(regp, regj)
    np.testing.assert_array_equal(epsp, epsj)
    # a healthy or regularized lane's factor to f64 rounding, relative to
    # its own scale (a shifted singular direction has |Rinv| ~ eps^-1/2)
    for b in np.nonzero(okj)[0]:
        assert np.abs(Rp[b] - Rj[b]).max() <= 1e-8 * np.abs(Rj[b]).max(), b


def test_rinv_regularized_routes_past_k1():
    # n = 300 is past K1's 256 columns: the dispatch takes B10 (its twin
    # on CPU tensors), which factors it like the JAX package's XLA
    # factorization (ops/chol.py:843 batched_chol_rinv) within 1e-10
    from daqp_tpu_torch.ops import smem
    n = 300
    assert pchol.factor_route(50, smem.H100_OPTIN) == "k1"
    assert pchol.factor_route(n, smem.H100_OPTIN) == "b10"
    assert pchol.factor_route(1582, smem.H100_OPTIN) == "library"
    st = _as_settings(None, jnp.float64)
    H = _spd_batch(2, n, seed=300)
    Rj = np.asarray(jax.jit(chol.batched_chol_rinv)(jnp.asarray(H)))
    Rp, okp, regp, epsp = pchol.batched_rinv_regularized(
        torch.as_tensor(H), convert.settings_from_jax(st))
    assert okp.all() and not regp.any() and (epsp == 0).all()
    assert np.abs(Rp.numpy() - Rj).max() <= 1e-10 * np.abs(Rj).max()
