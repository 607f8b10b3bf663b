"""Batches with SOFT rows on the port's dense-mask tier (B7's twin on the
CPU): against the JAX package's soft kernel path (``batch.py:588-608``,
interpret mode), through the stream entry, on the adversarial conflicting
soft equality, and the soundness of ``chip_smoke.py``'s ``soft`` gate for
the JAX package itself."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import batch as batch_mod
from daqp_tpu.api import _as_settings
import daqp_tpu_torch as dt
from tests.gen import generate_test_qp_batch

ROOT = Path(__file__).resolve().parents[1]
KEYS = ('H', 'f', 'A', 'bupper', 'blower')


def _bland_data():
    # test_pallas_kernel.py:49-53 (test_dense_kernel_bland_pricing)
    d = generate_test_qp_batch(128, 8, 20, 0, 5, 1e2, rng=2,
                               dtype=np.float32)
    sense = d['sense'].copy()
    sense[:, :4] |= dt.SOFT
    return d, sense


@pytest.mark.parametrize("pricing", [0, 1])
def test_soft_batch_matches_jax(pricing):
    d, sense = _bland_data()
    over = {"pricing": pricing, "iter_limit": 600}
    rj = batch_mod.solve_batch_pallas_jit(
        *[jnp.asarray(d[k]) for k in KEYS], jnp.asarray(sense),
        st=_as_settings(over, jnp.float32), ms=0, has_soft=True,
        interpret=True)
    rp = dt.solve_batch_kernel(*[d[k] for k in KEYS], sense,
                               st=dt.as_settings(over, torch.float32),
                               has_soft=True, device="cpu")
    fj, fp = np.asarray(rj.exitflag), rp.exitflag.numpy()
    assert (fp > 0).mean() > 0.95, np.unique(fp, return_counts=True)
    agree = (fp == fj) & (fp > 0)
    assert agree.sum() >= 124, (np.unique(fj), np.unique(fp))
    # the JAX test's own Dantzig-vs-Bland gate (1e-4) on x; lam by its
    # scale, soft_slack and fval through the same iterate
    assert np.abs(rp.x.numpy() - np.asarray(rj.x))[agree].max() < 1e-4
    lj = np.asarray(rj.lam)[agree]
    assert np.abs(rp.lam.numpy()[agree] - lj).max() \
        < 1e-4 * (1.0 + np.abs(lj).max())
    for name in ('soft_slack', 'fval'):
        a, b = getattr(rp, name).numpy()[agree], np.asarray(
            getattr(rj, name))[agree]
        assert np.abs(a - b).max() < 1e-4 * (1.0 + np.abs(b).max()), name


def test_soft_stream_matches_one_call():
    # each lane's result depends on that lane alone: chunking and the
    # difficulty sort change nothing
    d, sense = _bland_data()
    st = dt.as_settings({"iter_limit": 600}, torch.float32)
    args = [torch.as_tensor(d[k]) for k in KEYS] + [torch.as_tensor(sense)]
    one = dt.solve_batch_kernel(*args, st=st, has_soft=None)
    stream = dt.solve_batch_kernel_stream(*args, st=st, chunk=48,
                                          has_soft=True, sort_stream=True)
    np.testing.assert_array_equal(stream.exitflag.numpy(),
                                  one.exitflag.numpy())
    for name in ('x', 'lam', 'fval', 'soft_slack'):
        np.testing.assert_allclose(getattr(stream, name).numpy(),
                                   getattr(one, name).numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    # soft rows without has_soft stay loud on the slot tier
    hard = dt.solve_batch_kernel(*args, st=st, has_soft=False)
    assert (hard.exitflag.numpy() == dt.EXIT_UNSUPPORTED).all()


def test_conflicting_soft_equality():
    # test_pallas_adversarial.py:64-87: a soft x1 >= 1 against a hard
    # x1 <= 0 -> SOFT_OPTIMAL with the hard bound held
    B, n = 128, 8
    rng = np.random.default_rng(19)
    Q = rng.standard_normal((B, n, n)).astype(np.float32)
    H = np.einsum('bij,bkj->bik', Q, Q) + np.eye(n, dtype=np.float32)
    f = np.zeros((B, n), np.float32)
    A = np.tile(np.eye(n, dtype=np.float32)[None], (B, 1, 1))
    A = np.concatenate([A, A[:, :1]], axis=1)
    bu = np.concatenate([np.zeros((B, 1)), np.full((B, n - 1), 10.0),
                         np.full((B, 1), 1e30)], axis=1).astype(np.float32)
    bl = np.concatenate([np.full((B, n), -10.0), np.ones((B, 1))],
                        axis=1).astype(np.float32)
    sense = np.zeros((B, n + 1), np.int32)
    sense[:, n] = dt.SOFT
    r = dt.solve_batch_kernel(H, f, A, bu, bl, sense,
                              st=dt.as_settings({"iter_limit": 200},
                                                torch.float32),
                              device="cpu")
    flags = r.exitflag.numpy()
    assert (flags == dt.EXIT_SOFT_OPTIMAL).all(), np.unique(flags)
    assert (r.x.numpy()[:, 0] <= 1e-4).all()
    assert (r.soft_slack.numpy() > 0).all()


def test_config2_soft_gate_holds_for_jax():
    # chip_smoke.py's soft phase holds the port to ||x - x_oracle||_2 <=
    # 1e-4 on config 2 with rows 0-19 SOFT.  The gate must hold for the
    # JAX package itself: a 128-lane sample of the same data (every 80th
    # lane), JAX in interpret mode and the port's twin, against the f64
    # oracle at the port's rho_soft and tolerances.
    spec = importlib.util.spec_from_file_location("chip_smoke_soft",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    d = generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT, cs.KAPPA,
                               rng=cs.SEED, dtype=np.float32)
    idx = np.arange(0, cs.B, 80)
    sense = d['sense'][idx].copy()
    sense[:, :cs.SOFT_ROWS] |= dt.SOFT
    data = [d[k][idx] for k in KEYS]
    over = {"iter_limit": 1000}
    rj = batch_mod.solve_batch_pallas_jit(
        *map(jnp.asarray, data), jnp.asarray(sense),
        st=_as_settings(over, jnp.float32), ms=0, has_soft=True,
        interpret=True)
    st = dt.as_settings(over, torch.float32)
    rp = dt.solve_batch_kernel(*data, sense, st=st, device="cpu")
    oracle = cs.oracle_module("daqp_numpy")
    for flags, x in ((np.asarray(rj.exitflag), np.asarray(rj.x)),
                     (rp.exitflag.numpy(), rp.x.numpy())):
        for k in range(len(idx)):
            ref = oracle.quadprog(*(a[k].astype(np.float64) for a in data),
                                  sense[k], 0,
                                  {"rho_soft": float(st.rho_soft),
                                   "primal_tol": float(st.primal_tol),
                                   "dual_tol": float(st.dual_tol)})
            assert flags[k] > 0 and ref['exitflag'] > 0
            assert np.linalg.norm(x[k] - ref['x']) <= cs.ACC_TOL, k
