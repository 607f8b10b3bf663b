"""The port's flat tier end to end (daqp_tpu_torch.batch.
solve_batch_flat_jit) and ``solve_batch`` on the CPU in f64, against the
JAX package's ``solve_batch_flat_jit`` on the same lanes: the same exit
flags and iterations, x and fval within 1e-8.  The cases of
test_flat_batch.py (the constructed solution within 1e-6, chunks of 8
lanes, the single-instance ``quadprog`` within 1e-9, dual stationarity
within 1e-6) share one batch and one JAX call; then the SOFT_WEIGHTS
batch of test_soft_weights.py:196 (the lifted slack QP within 1e-6, the
single-instance SOFT_WEIGHTS path within 1e-7), the deadline of
test_timelimit.py:110 through ``solve_batch``'s ``time_limit``, and
``batch_route`` at an H100's shared memory."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import batch as jbatch
from daqp_tpu.api import _as_settings
from daqp_tpu.types import SoftWeights as JaxSoftWeights
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, convert
from daqp_tpu_torch.ops import smem
from tests.gen import generate_test_qp_batch

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
B, N, M, MS, N_ACT = 32, 20, 50, 5, 12
ST = _as_settings(None, jnp.float64)
PST = convert.settings_from_jax(ST)


def _port_args(d):
    return [torch.as_tensor(d[k]) for k in KEYS]


def _same_as_jax(rp, rj):
    np.testing.assert_array_equal(rp.exitflag.numpy(),
                                  np.asarray(rj.exitflag))
    np.testing.assert_array_equal(rp.iterations.numpy(),
                                  np.asarray(rj.iterations))
    assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= 1e-8
    assert np.abs(rp.fval.numpy() - np.asarray(rj.fval)).max() <= 1e-8


@pytest.fixture(scope="module")
def main_batch():
    d = generate_test_qp_batch(B, N, M, MS, N_ACT, 1e2, rng=99)
    rj = jbatch.solve_batch_flat_jit(*[jnp.asarray(d[k]) for k in KEYS], ST,
                                     ms=MS)
    rp = pbatch.solve_batch_flat_jit(*_port_args(d), PST, ms=MS)
    return d, rj, rp


def test_flat_matches_jax_and_constructed(main_batch):
    d, rj, rp = main_batch
    _same_as_jax(rp, rj)
    assert np.abs(rp.lam.numpy() - np.asarray(rj.lam)).max() <= 1e-8
    assert (rp.exitflag == dt.EXIT_OPTIMAL).all()
    assert np.linalg.norm(rp.x.numpy() - d['x'], axis=1).max() < 1e-6


def test_flat_chunked_keeps_each_lane(main_batch):
    # chunks of 8 lanes: every lane as in one chunk (a lane's result
    # depends on that lane alone)
    d, _, rp = main_batch
    rc = pbatch.solve_batch_flat_jit(*_port_args(d), PST, ms=MS,
                                     lane_chunk=8)
    assert torch.equal(rc.exitflag, rp.exitflag)
    assert torch.equal(rc.iterations, rp.iterations)
    assert (rc.x - rp.x).abs().max().item() <= 1e-12


def test_flat_matches_single_instance(main_batch):
    d, _, rp = main_batch
    for b in range(0, B, 4):
        r1 = dt.quadprog(*[d[k][b] for k in KEYS], ms=MS,
                         dtype=torch.float64, device="cpu")
        assert np.abs(rp.x[b].numpy() - r1.x.numpy()).max() <= 1e-9, b
        assert abs(float(rp.fval[b]) - float(r1.fval)) <= 1e-9, b


def test_flat_duals_stationary(main_batch):
    # H x + f + [I_ms 0; A]' lam = 0
    d, _, rp = main_batch
    x, lam = rp.x.numpy(), rp.lam.numpy()
    grad = np.einsum('bij,bj->bi', d['H'], x) + d['f'] \
        + np.einsum('bri,br->bi', d['A'], lam[:, MS:])
    grad[:, :MS] += lam[:, :MS]
    assert np.linalg.norm(grad, axis=1).max() < 1e-6


def _lifted_x(H, f, A, bu, bl, soft_rows, d_ls, d_us, rho_ls, rho_us):
    """test_soft_weights.py's lifted slack QP (x, t >= 0: a'x - sqrt(rho)
    t <= b per soft side, penalty 0.5 (t + d sqrt(rho))^2) solved by the
    port's single-instance path in f64; its x."""
    n, m, k = H.shape[0], A.shape[0], len(soft_rows)
    nz = n + 2 * k
    Hz = np.eye(nz)
    Hz[:n, :n] = H
    su, sl = np.sqrt(rho_us), np.sqrt(rho_ls)
    fz = np.concatenate([f, (d_us * su)[soft_rows], (d_ls * sl)[soft_rows]])
    rows, rub, rlb = [], [], []
    for i in range(m):
        r = np.zeros(nz)
        r[:n] = A[i]
        if i in soft_rows:
            j = soft_rows.index(i)
            up, lo = r.copy(), r.copy()
            up[n + j], lo[n + k + j] = -su[i], sl[i]
            rows += [up, lo]
            rub += [bu[i], 1e30]
            rlb += [-1e30, bl[i]]
        else:
            rows.append(r)
            rub.append(bu[i])
            rlb.append(bl[i])
    rows += list(np.eye(nz)[n:])                # slack nonnegativity
    rub += [1e30] * (2 * k)
    rlb += [0.0] * (2 * k)
    r = dt.quadprog(Hz, fz, np.asarray(rows), np.asarray(rub),
                    np.asarray(rlb), ms=0, dtype=torch.float64, device="cpu")
    assert r.exitflag in (1, 2), r.exitflag
    return r.x.numpy()[:n]


def test_soft_weights_flat_matches_jax_and_lifted_qp():
    rng = np.random.default_rng(57)
    Bs, n, m = 24, 6, 14
    soft_rows = [0, 3, 7, 11]
    ns = len(soft_rows)
    Hs, fs = np.empty((Bs, n, n)), np.empty((Bs, n))
    As = np.empty((Bs, m, n))
    bus, bls = np.empty((Bs, m)), np.empty((Bs, m))
    d_ls, d_us = np.zeros((Bs, m)), np.zeros((Bs, m))
    rho_ls, rho_us = np.ones((Bs, m)), np.ones((Bs, m))
    for b in range(Bs):
        Q = rng.standard_normal((n, n))
        Hs[b] = Q @ Q.T + 0.5 * np.eye(n)
        fs[b] = 3 * rng.standard_normal(n)
        As[b] = rng.standard_normal((m, n))
        bus[b] = 0.3 * rng.random(m)
        bls[b] = bus[b] - 0.3 - 0.5 * rng.random(m)
        d_ls[b, soft_rows] = 0.4 * rng.random(ns)
        d_us[b, soft_rows] = 0.4 * rng.random(ns)
        rho_ls[b, soft_rows] = 0.5 + rng.random(ns)
        rho_us[b, soft_rows] = 0.5 + rng.random(ns)
    sense = np.zeros((Bs, m), np.int32)
    sense[:, soft_rows] = dt.SOFT
    sw = (d_ls, d_us, rho_ls, rho_us)
    st = _as_settings({"iter_limit": 500}, jnp.float64)
    rj = jbatch.solve_batch_flat_jit(
        *(jnp.asarray(v) for v in (Hs, fs, As, bus, bls, sense)), st, ms=0,
        K=n + ns + 1, sw=JaxSoftWeights(*(jnp.asarray(v) for v in sw)))
    # solve_batch passes K = n + max_ns + 1 itself
    rp = dt.solve_batch(Hs, fs, As, bus, bls, sense, ms=0,
                        settings={"iter_limit": 500},
                        soft_weights=dict(zip(dt.SoftWeights._fields, sw)),
                        device="cpu")
    _same_as_jax(rp, rj)
    flags, xs = rp.exitflag.numpy(), rp.x.numpy()
    assert np.all(flags > 0)
    for b in range(Bs):
        x_ref = _lifted_x(Hs[b], fs[b], As[b], bus[b], bls[b], soft_rows,
                          *(v[b] for v in sw))
        assert np.abs(xs[b] - x_ref).max() < 1e-6, b
    for b in range(0, Bs, 5):
        one = dt.quadprog(Hs[b], fs[b], As[b], bus[b], bls[b], sense[b],
                          ms=0, soft_weights=dict(zip(
                              dt.SoftWeights._fields, (v[b] for v in sw))),
                          dtype=torch.float64, device="cpu")
        assert one.exitflag == flags[b], b
        assert np.abs(xs[b] - one.x.numpy()).max() < 1e-7, b


def test_solve_batch_time_limit():
    # the deadline is read as each chunk starts: past it every lane exits
    # TIMELIMIT; a generous one changes nothing
    d = generate_test_qp_batch(24, 8, 16, 0, 5, 1e2, rng=61)
    args = _port_args(d)
    r = pbatch.solve_batch_flat_jit(*args, PST, deadline=time.perf_counter()
                                    - 1.0)
    assert (r.exitflag == dt.EXIT_TIMELIMIT).all()
    r = dt.solve_batch(*args, settings={"time_limit": 1e-9})
    assert (r.exitflag == dt.EXIT_TIMELIMIT).all()
    r_far = dt.solve_batch(*args, settings={"time_limit": 1e6})
    r_none = dt.solve_batch(*args)
    assert (r_far.exitflag == 1).all()
    assert torch.equal(r_far.x, r_none.x)


def test_batch_route_at_h100_limit():
    f32, f64, lim = torch.float32, torch.float64, smem.H100_OPTIN
    route = pbatch.batch_route
    # config 2 (n = 50, m = 100): K2; with soft rows or SOFT_WEIGHTS: B7
    assert route(f32, 50, 100, False, False, lim) == "kernel"
    assert route(f32, 50, 100, True, False, lim) == "kernel"
    assert route(f32, 50, 100, True, True, lim) == "kernel"
    # f64 never reaches a kernel; the reference grid's shapes are past
    # K2's block (n = 100, m = 500) and K1's columns (n = 500)
    assert route(f64, 50, 100, False, False, lim) == "flat"
    assert route(f32, 100, 500, False, False, lim) == "flat"
    assert route(f32, 200, 1000, False, False, lim) == "flat"
    assert route(f32, 500, 2500, False, False, lim) == "flat"
    # K2's and B7's last fitting m at n = 50 (chip_smoke.py's `limits`)
    assert route(f32, 50, 893, False, False, lim) == "kernel"
    assert route(f32, 50, 894, False, False, lim) == "flat"
    assert route(f32, 50, 209, True, False, lim) == "kernel"
    assert route(f32, 50, 210, True, False, lim) == "flat"
    assert route(f32, 50, 205, True, True, lim) == "kernel"
    assert route(f32, 50, 206, True, True, lim) == "flat"


def test_solve_batch_takes_the_route():
    # an f32 batch that fits runs the kernel stream's twins, an f64 one
    # the flat tier: each result equals that entry's own
    d = generate_test_qp_batch(16, 10, 24, 0, 6, 1e2, rng=62)
    a64 = _port_args(d)
    a32 = [a.float() if a.is_floating_point() else a for a in a64]
    st32 = dt.as_settings(None, torch.float32)
    r32 = dt.solve_batch(*a32)
    k32 = pbatch.solve_batch_kernel_stream(*a32, st32)
    assert torch.equal(r32.x, k32.x) and torch.equal(r32.exitflag,
                                                     k32.exitflag)
    r64 = dt.solve_batch(*a64)
    f64 = pbatch.solve_batch_flat_jit(*a64, dt.as_settings(None,
                                                           torch.float64))
    assert torch.equal(r64.x, f64.x) and torch.equal(r64.exitflag,
                                                     f64.exitflag)
    assert (r64.exitflag == 1).all() and r64.x.dtype == torch.float64
