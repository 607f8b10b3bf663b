"""The port's f64 backstop (``batch.backstop_resolve``) and ``deadline`` on
every batched entry, on the CPU.

Counterparts of test_backstop.py (a forced-failure batch, a silent
corruption, a clean batch returned as the same object), of the LP, AVI
and hierarchical backstops of test_batch_lp.py, test_batch_avi.py and
test_batch_hiqp.py on the port's tiers (the loud and injected lanes
re-solved in f64 by the port's own ``linprog``, ``avi`` and hierarchical
``quadprog``, as the JAX package's backstops re-solve them), of the SW
escalation of test_soft_weights.py (a forced-failure SOFT_WEIGHTS lane
re-solved by the port and by ``daqp_tpu.batch.backstop_resolve(sw=...)``
to the same answer) and of test_timelimit.py's batched cases: an
expired deadline gives every lane of each of the six port entries
EXIT_TIMELIMIT, a generous one the same flags and host syncs as none."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daqp_tpu
from daqp_tpu import batch as batch_mod
from daqp_tpu.api import _as_settings
from daqp_tpu.types import SoftWeights as JSoftWeights
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, ops
from tests.gen import (generate_test_avi_two_sided, generate_test_lp,
                       generate_test_qp_batch)
from tests.test_batch_hiqp import _rand_hier

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')


def _port_result(r) -> dt.BatchResult:
    """A JAX ``BatchResult`` as the port's, on the CPU."""
    return dt.BatchResult(*(torch.as_tensor(np.array(x)) for x in r))


def _flat(d, st, **kw):
    return batch_mod.solve_batch_flat_jit(
        *(jnp.asarray(d[k]) for k in KEYS), st, ms=0, **kw)


def _same(rj, rp, rtol=1e-8):
    fj, fp = np.asarray(rj.exitflag), rp.exitflag.numpy()
    assert (fj == fp).all(), (fj, fp)
    xj = np.asarray(rj.x)
    tol = rtol * (1.0 + np.abs(xj).max())
    assert np.abs(rp.x.numpy() - xj).max() <= tol
    assert np.abs(rp.lam.numpy() - np.asarray(rj.lam)).max() <= tol


def test_backstop_repairs_iterlimit_lanes_as_jax():
    # test_backstop.py's forced failures: the flat tier at iter_limit 3
    d = generate_test_qp_batch(8, 12, 40, 0, 8, 1e2, rng=5)
    res = _flat(d, _as_settings({"iter_limit": 3}, jnp.float64))
    assert np.any(np.asarray(res.exitflag) != 1)
    args = [d[k] for k in KEYS]
    rj = batch_mod.backstop_resolve(res, *args, ms=0)
    rp = dt.backstop_resolve(_port_result(res), *args, ms=0)
    _same(rj, rp)
    assert (rp.exitflag.numpy() == dt.EXIT_OPTIMAL).all()
    assert np.linalg.norm(rp.x.numpy() - d['x'], axis=1).max() < 1e-6


def test_backstop_catches_silent_kkt_failures_as_jax():
    d = generate_test_qp_batch(8, 10, 30, 0, 6, 1e2, rng=6)
    res = _flat(d, _as_settings(None, jnp.float64))
    x = np.asarray(res.x).copy()
    x[3] += 0.05                     # wrong, and still flagged optimal
    res = res._replace(x=jnp.asarray(x))
    args = [d[k] for k in KEYS]
    rj = batch_mod.backstop_resolve(res, *args, ms=0)
    rp = dt.backstop_resolve(_port_result(res), *args, ms=0)
    _same(rj, rp)
    assert np.linalg.norm(rp.x.numpy() - d['x'], axis=1).max() < 1e-6


def test_backstop_on_the_port_batch():
    # the port's own f32 batch: a clean batch comes back as the same
    # object after one KKT check (one host sync); a silently corrupted
    # lane is solved again in f64, within 1e-5 of the constructed optimum
    # (of the f64 data: the f32 data's own optimum lies ~1e-6 from it)
    d = generate_test_qp_batch(16, 10, 30, 0, 6, 1e2, rng=7,
                               dtype=np.float32)
    args = [torch.as_tensor(d[k]) for k in KEYS]
    st = dt.as_settings({"iter_limit": 500}, torch.float32)
    res = dt.solve_batch_kernel(*args, st=st)
    assert (res.exitflag.numpy() == 1).all()
    ops.host_syncs = 0
    assert dt.backstop_resolve(res, *args, ms=0, settings=st) is res
    assert ops.host_syncs == 1
    x = res.x.clone()
    x[3] += 0.05
    n0 = pbatch.backstop_lanes
    fixed = dt.backstop_resolve(res._replace(x=x), *args, ms=0, settings=st)
    assert pbatch.backstop_lanes - n0 == 1
    assert fixed.x.dtype == torch.float32
    err = np.linalg.norm(fixed.x.numpy().astype(np.float64) - d['x'], axis=1)
    assert err[3] < 1e-5 and err.max() < 1e-4
    # forced failures: lanes left ITERLIMIT with x zero, as lanes that
    # ran out of iterations; the backstop solves each of them
    res = dt.solve_batch_kernel_stream(*args, st=st, chunk=8)
    failed = np.arange(16) % 4 == 1
    low = res._replace(
        x=torch.where(torch.as_tensor(failed)[:, None], 0.0, res.x),
        exitflag=torch.where(torch.as_tensor(failed), dt.EXIT_ITERLIMIT,
                             res.exitflag).to(torch.int32))
    n0 = pbatch.backstop_lanes
    fixed = dt.backstop_resolve(low, *args, ms=0)
    assert pbatch.backstop_lanes - n0 == failed.sum()
    assert (fixed.exitflag.numpy() == 1).all()
    err = np.linalg.norm(fixed.x.numpy().astype(np.float64) - d['x'], axis=1)
    assert err[failed].max() < 1e-5 and err.max() < 1e-4


def _sw_batch(seed=170010, B=16):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 10))
    m = int(rng.integers(n + 3, 2 * n + 8))
    ns = int(rng.integers(1, max(2, m // 3)))
    rows = sorted(rng.choice(m, ns, replace=False).tolist())
    d = {k: [] for k in KEYS[:5]}
    sw = {k: np.zeros((B, m)) for k in ('d_ls', 'd_us')}
    sw.update({k: np.ones((B, m)) for k in ('rho_ls', 'rho_us')})
    for b in range(B):
        Q = rng.standard_normal((n, n))
        d['H'].append(Q @ Q.T + 0.5 * np.eye(n))
        d['f'].append(3 * rng.standard_normal(n))
        d['A'].append(rng.standard_normal((m, n)))
        bu = 0.3 * rng.random(m)
        d['bupper'].append(bu)
        d['blower'].append(bu - 0.3 - 0.5 * rng.random(m))
        sw['d_ls'][b, rows] = 0.4 * rng.random(ns)
        sw['d_us'][b, rows] = 0.4 * rng.random(ns)
        sw['rho_ls'][b, rows] = 0.5 + rng.random(ns)
        sw['rho_us'][b, rows] = 0.5 + rng.random(ns)
    d = {k: np.stack(v) for k, v in d.items()}
    d['sense'] = np.zeros((B, m), np.int32)
    d['sense'][:, rows] = dt.SOFT
    return d, sw, n + ns + 1


def test_backstop_sw_lane_as_jax():
    # a SOFT_WEIGHTS lane forced to fail (wrong x, CYCLE) goes through
    # the single-instance SW solver in both packages, to the same answer
    d, sw, K = _sw_batch()
    keys = ('d_ls', 'd_us', 'rho_ls', 'rho_us')
    jsw = JSoftWeights(*(jnp.asarray(sw[k]) for k in keys))
    res = _flat(d, _as_settings({"iter_limit": 2000}, jnp.float64), K=K,
                sw=jsw)
    assert (np.asarray(res.exitflag) > 0).all()
    b = 5
    bad = res._replace(exitflag=jnp.asarray(res.exitflag).at[b].set(-2),
                       x=jnp.asarray(res.x).at[b].set(1e3))
    args = [d[k] for k in KEYS]
    rj = batch_mod.backstop_resolve(bad, *args, ms=0, sw=jsw)
    rp = dt.backstop_resolve(_port_result(bad), *args, ms=0,
                             sw=dt.SoftWeights(*(torch.as_tensor(sw[k])
                                                 for k in keys)))
    _same(rj, rp)
    assert (rp.exitflag.numpy() > 0).all()
    one = dt.quadprog(*(a[b] for a in args), soft_weights={
        k: sw[k][b] for k in keys}, dtype=torch.float64, device="cpu")
    assert torch.equal(rp.x[b], one.x)
    others = np.arange(16) != b
    assert np.array_equal(rp.x.numpy()[others], np.asarray(res.x)[others])


# ---------------------------------------------------------------------------
# deadline on the six batched entries
# ---------------------------------------------------------------------------
def _qp_args(B=12, soft=False):
    d = generate_test_qp_batch(B, 8, 20, 0, 5, 1e2, rng=62,
                               dtype=np.float32)
    args = [torch.as_tensor(d[k]) for k in KEYS]
    if soft:
        args[5] = args[5] | dt.SOFT * (torch.arange(20) < 4).to(torch.int32)
    return args


def _prox_args(B=8, n=10, m=20, rank=5):
    rng = np.random.default_rng(11)
    Q = rng.standard_normal((B, n, rank))
    H = np.einsum('bir,bjr->bij', Q, Q)
    out = [H, rng.standard_normal((B, n)), rng.standard_normal((B, m, n)),
           5 + 5 * rng.random((B, m)), -(5 + 5 * rng.random((B, m)))]
    return [torch.as_tensor(a, dtype=torch.float32) for a in out] + [None]


def _hiqp_args(B=8, n=6, bp=(0, 4, 8, 12)):
    rng = np.random.default_rng(77)
    A, bu, bl = zip(*(_rand_hier(rng, n, bp) for _ in range(B)))
    t = (lambda a: torch.as_tensor(np.stack(a), dtype=torch.float32))
    return [None, torch.zeros((B, n)), t(A), t(bu), t(bl), None], bp


def _avi_args(B=8, n=6, m=12):
    # AVIs whose unconstrained point is infeasible: a lane the shortcut
    # answers at set-up never runs, and keeps its optimal flag
    rng = np.random.default_rng(29)
    probs = []
    while len(probs) < B:
        p = generate_test_avi_two_sided(n, m, rng)
        r = p[3] @ np.linalg.solve(p[1], -p[2])
        if ((r > p[4]) | (r < p[5])).any():
            probs.append(p)
    H, f, A, bu, bl = (np.stack([p[i] for p in probs]) for i in range(1, 6))
    return [torch.as_tensor(a, dtype=torch.float32)
            for a in (H, f, A, bu, bl)] + [None]


def _lp_args(B=8, n=4, m=10):
    rng = np.random.default_rng(17)
    probs = [generate_test_lp(n, m, 0, rng) for _ in range(B)]
    return [torch.as_tensor(np.stack([p[i] for p in probs]),
                            dtype=torch.float32) for i in (1, 2, 3, 4)] \
        + [None]


ENTRIES = {
    "kernel": lambda dl, **kw: dt.solve_batch_kernel(
        *_qp_args(), st=_st(), deadline=dl),
    "kernel_soft": lambda dl, **kw: dt.solve_batch_kernel(
        *_qp_args(soft=True), st=_st(), deadline=dl),
    "stream": lambda dl, **kw: dt.solve_batch_kernel_stream(
        *_qp_args(), st=_st(), chunk=8, deadline=dl),
    "prox": lambda dl, fused=True: dt.solve_batch_prox_kernel(
        *_prox_args(), st=_st(), fused=fused, deadline=dl),
    "hiqp": lambda dl, **kw: dt.solve_batch_hiqp_kernel(
        *_hiqp_args()[0], st=_st(), break_points=_hiqp_args()[1],
        deadline=dl),
    "avi": lambda dl, fused=True: dt.solve_batch_avi_kernel(
        *_avi_args(), st=_st(), fused=fused, deadline=dl),
    "lp": lambda dl, fused=False: dt.solve_batch_lp_kernel(
        *_lp_args(), st=_st(), fused=fused, deadline=dl),
    "miqp": lambda dl, **kw: dt.solve_batch_miqp_kernel(
        *_miqp_args(), st=_st(), deadline=dl, device="cpu"),
}


def _miqp_args():
    from tests.test_torch_miqp import _miqps
    return _miqps(8, 8, 20, 3, seed=23)


def _st():
    return dt.as_settings({"iter_limit": 1000}, torch.float32)


@pytest.mark.parametrize("entry,fused", [
    ("kernel", None), ("kernel_soft", None), ("stream", None),
    ("prox", True), ("prox", False), ("hiqp", None), ("avi", True),
    ("avi", False), ("lp", False), ("lp", True), ("miqp", None)])
def test_deadline_on_batched_entries(entry, fused):
    kw = {} if fused is None else dict(fused=fused)
    run = ENTRIES[entry]
    ops.host_syncs = 0
    r0 = run(None, **kw)
    syncs_none = ops.host_syncs
    assert (r0.exitflag.numpy() != dt.EXIT_TIMELIMIT).all()
    # expired: every lane exits TIMELIMIT
    r1 = run(time.perf_counter() - 1.0, **kw)
    assert (r1.exitflag.numpy() == dt.EXIT_TIMELIMIT).all(), \
        np.unique(r1.exitflag.numpy())
    # generous: the same flags and x as none, and the same host syncs
    ops.host_syncs = 0
    r2 = run(time.perf_counter() + 1e6, **kw)
    assert ops.host_syncs == syncs_none
    assert torch.equal(r2.exitflag, r0.exitflag)
    assert torch.equal(r2.x, r0.x)


def test_jax_batched_kernel_deadline_agrees():
    # test_time_limit_batched_kernel on the same lanes: both packages
    # give every lane TIMELIMIT past the deadline and optimal before it
    d = generate_test_qp_batch(32, 10, 24, 0, 6, 1e2, rng=62,
                               dtype=np.float32)
    st = _as_settings({"iter_limit": 400}, jnp.float32)
    args = [jnp.asarray(d[k]) for k in KEYS]
    pargs = [torch.as_tensor(d[k]) for k in KEYS]
    pst = dt.as_settings({"iter_limit": 400}, torch.float32)
    for dl, want in ((time.perf_counter() - 1.0, dt.EXIT_TIMELIMIT),
                     (time.perf_counter() + 1e6, dt.EXIT_OPTIMAL)):
        rj = batch_mod.solve_batch_pallas_jit(
            *args, st=st, ms=0, has_soft=False, interpret=True,
            deadline=jnp.asarray(dl, jnp.float64))
        rp = dt.solve_batch_kernel(*pargs, st=pst, deadline=dl)
        assert (np.asarray(rj.exitflag) == want).all()
        assert (rp.exitflag.numpy() == want).all()
    assert daqp_tpu.EXIT_TIMELIMIT == dt.EXIT_TIMELIMIT


def _lp_batch(B, n, m, seed):
    rng = np.random.default_rng(seed)
    probs = [generate_test_lp(n, m, 0, rng) for _ in range(B)]
    return [np.stack([p[i] for p in probs]) for i in range(5)]


def _inject(res, lane, flag, x_val):
    flags = res.exitflag.clone()
    flags[lane] = flag
    x = res.x.clone()
    x[lane] = x_val
    return res._replace(exitflag=flags, x=x)


def test_backstop_lp_on_the_port_tier():
    # test_batch_lp.py's differential batch (its first 16 lanes) on the
    # port's per-pass tier: the loud lanes and an injected one re-solve
    # to the constructed vertex, each as the single-instance f64 linprog
    # gives it
    xs, fs, As, bus, bls = _lp_batch(16, 10, 50, 3)
    args = [torch.as_tensor(a, dtype=torch.float32)
            for a in (fs, As, bus, bls)]
    sense = np.zeros((16, 50), np.int32)
    res = dt.solve_batch_lp_kernel(*args, torch.as_tensor(sense),
                                   dt.as_settings({"iter_limit": 3000},
                                                  torch.float32))
    res = _inject(res, 5, dt.EXIT_ITERLIMIT, float("nan"))
    loud = (res.exitflag.numpy() != 1).sum()
    n0 = pbatch.backstop_lanes
    rep = dt.backstop_resolve_lp(res, fs, As, bus, bls, sense)
    assert pbatch.backstop_lanes - n0 == loud >= 1
    assert (rep.exitflag.numpy() == 1).all(), rep.exitflag
    assert np.abs(rep.x.numpy() - xs).max() < 1e-4
    one = dt.linprog(fs[5], As[5], bus[5], bls[5], ms=0,
                     dtype=torch.float64, device="cpu")
    assert np.abs(rep.x[5].numpy() - one.x.numpy()).max() < 1e-6
    # a clean batch comes back as the same object
    assert dt.backstop_resolve_lp(rep, fs, As, bus, bls, sense) is rep


def test_backstop_lp_keeps_unbounded_lanes():
    # test_batch_lp_unbounded_lane: an UNBOUNDED lane is an answer, not
    # a failure: the backstop leaves it
    xs, fs, As, bus, bls = _lp_batch(8, 6, 20, 9)
    fs[3] = 0.0
    fs[3, 0] = -1.0
    As[3] = 0.0
    As[3, :, 1] = 1.0
    bus[3], bls[3] = 1.0, -1.0
    sense = np.zeros((8, 20), np.int32)
    res = dt.solve_batch_lp_kernel(
        *(torch.as_tensor(a, dtype=torch.float32)
          for a in (fs, As, bus, bls)), torch.as_tensor(sense),
        dt.as_settings({"iter_limit": 2000}, torch.float32))
    assert res.exitflag[3] == dt.EXIT_UNBOUNDED
    rep = dt.backstop_resolve_lp(res, fs, As, bus, bls, sense)
    flags = rep.exitflag.numpy()
    assert flags[3] == dt.EXIT_UNBOUNDED and (np.delete(flags, 3) == 1).all()
    assert np.abs(np.delete(rep.x.numpy() - xs, 3, axis=0)).max() < 1e-4


def test_backstop_avi_on_the_port_tier_as_jax():
    # test_batch_avi_backstop: lane 3 made loud with garbage x re-solves
    # to the constructed solution, as the JAX package's backstop gives
    # it; the other lanes are untouched
    rng = np.random.default_rng(47)
    probs = [generate_test_avi_two_sided(8, 20, rng) for _ in range(8)]
    xs, Hs, fs, As, bus, bls = (np.stack([p[i] for p in probs])
                                for i in range(6))
    sense = np.zeros((8, 20), np.int32)
    res = dt.solve_batch_avi_kernel(
        *(torch.as_tensor(a, dtype=torch.float32)
          for a in (Hs, fs, As, bus, bls)), torch.as_tensor(sense),
        dt.as_settings({"iter_limit": 1500}, torch.float32))
    bad = _inject(res, 3, dt.EXIT_CYCLE, 1e9)
    rep = dt.backstop_resolve_avi(bad, Hs, fs, As, bus, bls, sense)
    assert rep.exitflag[3] == dt.EXIT_OPTIMAL
    assert np.abs(rep.x[3].numpy() - xs[3]).max() < 1e-5
    keep = np.flatnonzero(bad.exitflag.numpy() == 1)
    assert torch.equal(rep.x[keep], bad.x[keep])
    rj = batch_mod.backstop_resolve_avi(
        batch_mod.BatchResult(*(jnp.asarray(x.numpy()) for x in bad)),
        Hs, fs, As, bus, bls, sense)
    # (the port's result keeps the batch's f32 tensors)
    assert np.abs(rep.x[3].numpy() - np.asarray(rj.x)[3]).max() < 1e-6


def test_backstop_hiqp_on_the_port_tier_as_jax():
    # test_batch_hiqp_backstop: lane 2 made loud with a NaN x walks the
    # hierarchy again in f64 (the tier's rho_soft), as the JAX package's
    # backstop walks it; exit 3 lanes are left as they are
    rng = np.random.default_rng(53)
    bp = (0, 6, 12, 18)
    B, n, m = 8, 8, 18
    As, bus, bls = np.empty((B, m, n)), np.empty((B, m)), np.empty((B, m))
    for b in range(B):
        As[b], bus[b], bls[b] = _rand_hier(rng, n, bp)
    fs = np.zeros((B, n))
    sense = np.zeros((B, m), np.int32)
    res = dt.solve_batch_hiqp_kernel(
        None, *(torch.as_tensor(a, dtype=torch.float32)
                for a in (fs, As, bus, bls)), torch.as_tensor(sense),
        dt.as_settings({"iter_limit": 2000}, torch.float32),
        break_points=bp)
    bad = _inject(res, 2, dt.EXIT_ITERLIMIT, float("nan"))
    st = {"rho_soft": 3e-2}
    rep = dt.backstop_resolve_hiqp(bad, None, fs, As, bus, bls, sense,
                                   break_points=bp, settings=st)
    assert rep.exitflag[2] > 0 and torch.isfinite(rep.x[2]).all()
    loud = bad.exitflag.numpy() < 0
    assert (rep.exitflag.numpy()[~loud] == bad.exitflag.numpy()[~loud]).all()
    rj = batch_mod.backstop_resolve_hiqp(
        batch_mod.BatchResult(*(jnp.asarray(x.numpy()) for x in bad)),
        None, fs, As, bus, bls, sense, break_points=bp, settings=st)
    assert (np.asarray(rj.exitflag) == rep.exitflag.numpy()).all()
    assert np.abs(rep.x[2].numpy() - np.asarray(rj.x)[2]).max() < 1e-6
