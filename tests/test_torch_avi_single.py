"""The port's single-instance AVI (daqp_tpu_torch.avi_solver, api.avi)
against the JAX package on the CPU in f64: test_avi.py's three cases and
two soft AVIs (SOFT rows regularize the exact KKT step; the batched tier
is hard-only), the same exit flag and iteration count and x within 1e-6
of JAX's."""
import numpy as np
import pytest
import torch

import daqp_tpu
import daqp_tpu_torch as dt
from tests.gen import generate_test_avi

F64 = dict(dtype=torch.float64, device="cpu")


def _both(H, f, A, b, sense=None, ms=0):
    rj = daqp_tpu.avi(H, f, A, b, sense=sense, ms=ms)
    rp = dt.avi(H, f, A, b, sense=sense, ms=ms, **F64)
    assert rp.exitflag == int(rj.exitflag), (rp.exitflag, int(rj.exitflag))
    assert rp.iterations == int(rj.iterations)
    assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= 1e-6
    assert np.abs(rp.lam.numpy() - np.asarray(rj.lam)).max() <= 1e-6 * (
        1.0 + np.abs(np.asarray(rj.lam)).max())
    return rp


def test_avi_small_matches_jax():
    rng = np.random.default_rng(17)
    for _ in range(5):
        x, H, f, A, b = generate_test_avi(10, 50, rng)
        rp = _both(H, f, A, b)
        assert rp.exitflag == dt.EXIT_OPTIMAL
        assert np.linalg.norm(rp.x.numpy() - x) < 1e-4


def test_avi_reference_size_matches_jax():
    rng = np.random.default_rng(23)
    x, H, f, A, b = generate_test_avi(100, 500, rng)
    rp = _both(H, f, A, b)
    assert rp.exitflag == dt.EXIT_OPTIMAL
    assert np.linalg.norm(rp.x.numpy() - x) < 1e-4


def test_avi_unconstrained_matches_jax():
    rng = np.random.default_rng(31)
    Mm = rng.random((6, 6))
    H = Mm.T @ Mm + np.eye(6) + 0.1 * (rng.random((6, 6))
                                       - rng.random((6, 6)))
    f = rng.standard_normal(6)
    x_unc = np.linalg.solve(H, -f)
    A = rng.standard_normal((4, 6))
    rp = _both(H, f, A, A @ x_unc + 1.0)
    assert rp.exitflag == dt.EXIT_OPTIMAL
    assert np.linalg.norm(rp.x.numpy() - x_unc) < 1e-8


@pytest.mark.parametrize("seed", [41, 43])
def test_soft_avi_matches_jax(seed):
    # a constructed AVI with its first 10 rows SOFT and pulled inward by
    # 0.05, so that the soft rows are violated at the solution
    rng = np.random.default_rng(seed)
    x, H, f, A, b = generate_test_avi(10, 30, rng)
    sense = np.zeros(30, np.int32)
    sense[:10] = dt.SOFT
    b = b.copy()
    b[:10] -= 0.05
    rp = _both(H, f, A, b, sense=sense)
    assert rp.exitflag > 0
