"""B7 (daqp_tpu_torch.ops.dense): the plain twin of the CUDA dense-mask
round against the JAX kernel it replaces (``ops/pallas_batch.py
run_kernel_round``, Pallas interpret mode) on one carried-over state, the
host-loop pieces against their JAX counterparts on one state, the state
conversion, and the structure of ``dense_solve``'s last polish."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import transform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import pallas_batch as pb
from daqp_tpu.types import IMMUTABLE, SOFT
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert
from daqp_tpu_torch.ops import dense
from tests.gen import generate_test_qp_batch

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
BP = 32             # lanes the port runs (the JAX kernel runs 128)


def _soft4():
    # test_pallas_kernel.py:49-53: four SOFT rows per lane
    d = generate_test_qp_batch(128, 8, 20, 0, 5, 1e2, rng=2,
                               dtype=np.float32)
    d['sense'] = d['sense'].copy()
    d['sense'][:, :4] |= SOFT
    return d


def _soft_pair():
    # a conflicting soft pair: row 1 duplicates row 0 with a disjoint band
    # (test_batch_hiqp.py:68-91), rows 0-3 soft, identity metric
    rng = np.random.default_rng(5)
    B, n, m = 128, 6, 8
    A = rng.standard_normal((B, m, n))
    b0 = np.einsum('bmn,bn->bm', A, rng.standard_normal((B, n)))
    bu, bl = b0 + 0.5, b0 - 0.5
    A[:, 1] = A[:, 0]
    bu[:, 0], bl[:, 0] = b0[:, 0] - 1.0, b0[:, 0] - 2.0
    bl[:, 1], bu[:, 1] = b0[:, 1] + 1.0, b0[:, 1] + 2.0
    sense = np.zeros((B, m), np.int32)
    sense[:, :4] = SOFT
    f32 = np.float32
    return dict(H=np.tile(np.eye(n, dtype=f32), (B, 1, 1)),
                f=np.zeros((B, n), f32), A=A.astype(f32),
                bupper=bu.astype(f32), blower=bl.astype(f32), sense=sense)


def _hard():
    return generate_test_qp_batch(128, 10, 24, 0, 6, 1e2, rng=33,
                                  dtype=np.float32)


CASES = {
    "soft4": (_soft4, {}, True),
    "bland": (_soft4, {"pricing": 1}, True),
    "soft_pair": (_soft_pair, {"rho_soft": 3e-2}, True),
    "hard": (_hard, {}, False),
}


def _cold(case):
    make, over, has_soft = CASES[case]
    d = make()
    st = _as_settings({"iter_limit": 600, **over}, jnp.float32)
    ldpd = jax.vmap(functools.partial(transform.build_ldp, ms=0, st=st))(
        *[jnp.asarray(d[k]) for k in KEYS])
    immut = ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32)
    soft = ((ldpd.sense & SOFT) > 0).astype(jnp.float32)
    s = pb.dense_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                      soft)
    m, n = d['A'].shape[1:]
    return s, st, m, n, has_soft


def _port(sj, m, n):
    """The JAX state's first BP lanes as the port's state."""
    s = convert.dense_state_from_jax(sj, m, n)
    return dense.map_state(lambda x: x[:BP].contiguous(), s)


def _jax_np(sj, m, n):
    """The JAX state's first BP lanes, padding sliced off, lanes-last."""
    out = {}
    for name, x in sj._asdict().items():
        if x is None:
            continue
        a = np.asarray(x)[..., :BP]
        if name == 'M':
            a = a[:m, :n]
        elif name == 'E':
            a = a[:m, :m]
        elif name == 'u':
            a = a[:n]
        elif a.shape[0] != 1:
            a = a[:m]
        out[name] = a
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_round_matches_jax_kernel(case):
    s, st, m, n, has_soft = _cold(case)
    sj = _jax_np(pb.run_kernel_round(s, st, n, steps=192, interpret=True,
                                     has_soft=has_soft), m, n)
    sp = convert.dense_state_to_numpy(dense.run_kernel_round(
        _port(s, m, n), convert.settings_from_jax(st), n, steps=192,
        has_soft=has_soft))
    assert (sp['status'][0] == sj['status'][0]).all(), \
        (sp['status'][0], sj['status'][0])
    agree = (sp['act_up'] == sj['act_up']).all(0) \
        & (sp['act_lo'] == sj['act_lo']).all(0)
    # (the paths may part at an f32 tie on the singularity gate and meet
    # again, so iteration counts are not compared)
    assert agree.sum() >= BP - 1, agree.sum()
    # u relative to its scale: each rank-one update of E carries the f32
    # rounding of its sums (taken in another order by XLA) times the
    # conditioning of the working set of the moment; a lane whose set
    # passes through a ~1e-5 Schur pivot (the soft gate admits pivots
    # down to 0.25 rho) ends ~1e-4 apart in absolute terms
    gap = np.abs(sp['u'] - sj['u'])[:, agree].max(0)
    scale = 1.0 + np.abs(sj['u'][:, agree]).max(0)
    # Bland's slow pivots run through sets whose E reaches ~1e3 (Schur
    # pivots near the gate): there both sides end up to ~6e-3 from the
    # exact u on their common working set before any polish (measured on
    # this case, JAX 5.7e-3, the twin 5.9e-3).  A lane outside the 1e-4
    # gate must then be within twice the JAX kernel's distance to the
    # exact u plus K2's pre-polish drift gate, 1e-3 (1 + ||u||)
    ex_p, ex_j = (_exact_gap(sj, x, st.rho_soft if has_soft else 0.0)[agree]
                  for x in (sp, sj))
    ok = (gap <= 1e-4 * scale) | (ex_p <= 2.0 * ex_j + 1e-3 * scale)
    assert ok.all(), (gap / scale, ex_p, ex_j)


def _exact_gap(sj, s, rho):
    """Per lane, ||u - u_exact||_inf of the lanes-last state ``s``, u_exact
    = -M_W' lam*, lam* = -(M_W M_W' + rho S_W)^-1 d_W in f64 on the
    working set W of ``s``."""
    M = sj['M'].astype(np.float64)
    out = []
    for b in range(M.shape[-1]):
        up, lo = s['act_up'][:, b] > 0, s['act_lo'][:, b] > 0
        W = np.nonzero(up | lo)[0]
        Mw = M[W, :, b]
        d = np.where(up, sj['dupper'][:, b], sj['dlower'][:, b])[W]
        G = Mw @ Mw.T + rho * np.diag(sj['soft'][W, b])
        u = Mw.T @ np.linalg.solve(G, d) if len(W) else np.zeros(M.shape[1])
        out.append(np.abs(s['u'][:, b] - u).max())
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def _after_round(case="soft4", steps=192):
    s, st, m, n, has_soft = _cold(case)
    s1 = pb.run_kernel_round(s, st, n, steps=steps, interpret=True,
                             has_soft=has_soft)
    return s1, st, convert.settings_from_jax(st), m, n


def _close(a, b, tol):
    """max over lanes of |a - b| / (1 + max|b|), lanes last."""
    ax = tuple(range(a.ndim - 1))
    return (np.abs(a - b).max(ax) / (1.0 + np.abs(b).max(ax))).max() <= tol


def test_state_conversion_round_trip():
    s1, _, _, m, n = _after_round(steps=5)
    sp = _port(s1, m, n)
    assert sp.M.shape == (BP, m, n) and sp.E.shape == (BP, m, m)
    back = convert.dense_state_to_numpy(sp)
    ref = _jax_np(s1, m, n)
    for name, a in back.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    # the pending row index comes from the one-hot
    assert (sp.pid[sp.pend > 0] >= 0).all()


def test_polish_matches_jax():
    s1, st, stp, m, n = _after_round()
    sj = _jax_np(pb.polish(s1, st), m, n)
    sp = convert.dense_state_to_numpy(dense.polish(_port(s1, m, n), stp))
    assert (sp['status'] == sj['status']).all()
    # two refinement steps through a Newton-refreshed f32 E
    for name in ('u', 'lam_star', 'fval', 'E'):
        assert _close(sp[name], sj[name], 1e-5), name


def test_exact_repair_matches_jax():
    s1, st, stp, m, n = _after_round(steps=6)
    status = np.asarray(s1.status).copy()
    status[0, :4] = dt.EXIT_REFACTOR
    status[0, 4:8] = dt.EXIT_CYCLE
    s1 = s1._replace(status=jnp.asarray(status),
                     repaired=jnp.zeros_like(s1.repaired))
    sj = _jax_np(pb.exact_repair(s1, st), m, n)
    sp = convert.dense_state_to_numpy(dense.exact_repair(_port(s1, m, n),
                                                         stp))
    for name in ('status', 'pend', 'repaired', 'cycle', 'best_fval'):
        np.testing.assert_array_equal(sp[name], sj[name], err_msg=name)
    # a fresh f32 Cholesky inverse on both sides (XLA vs LAPACK)
    assert _close(sp['E'], sj['E'], 1e-5)


def test_activate_matches_jax():
    s1, st, stp, m, n = _after_round()
    s0, _, _, _, _ = _cold("soft4")
    up, lo = s1.act_up, s1.act_lo           # a working set the solver met
    sj = _jax_np(pb.dense_activate(s0, up, lo, st), m, n)
    sp = convert.dense_state_to_numpy(dense.dense_activate(
        _port(s0, m, n), torch.as_tensor(np.array(up)[:m, :BP].T),
        torch.as_tensor(np.array(lo)[:m, :BP].T), stp))
    for name in ('status', 'act_up', 'act_lo', 'lam'):
        np.testing.assert_array_equal(sp[name], sj[name], err_msg=name)
    assert _close(sp['E'], sj['E'], 1e-5)


@pytest.mark.parametrize("start", [0, 4])
def test_reactivate_refresh_matches_jax(start):
    s1, st, stp, m, n = _after_round("soft_pair")
    s1 = s1._replace(soft=jnp.zeros_like(s1.soft))      # hardened level
    s2, n_imm = pb.dense_reactivate(s1, st, n, start)
    sj = _jax_np(pb.newton_refresh(s2, st), m, n)
    p2, p_imm = dense.dense_reactivate(_port(s1, m, n), stp, n, start)
    sp = convert.dense_state_to_numpy(dense.newton_refresh(p2, stp))
    for name in ('act_up', 'act_lo'):
        np.testing.assert_array_equal(sp[name], sj[name], err_msg=name)
    np.testing.assert_array_equal(p_imm.numpy(), np.asarray(n_imm)[:BP])
    # sequential f32 rank-one re-adds, then one Newton step
    assert _close(sp['E'], sj['E'], 1e-5)
    assert _close(sp['lam'], sj['lam'], 1e-6)


def test_last_polish_reopen_exits_loud(monkeypatch):
    # dense_solve polishes three times; a lane the third polish re-opens
    # has no rounds left to run and must exit loud, never optimal
    s, st, m, n, _ = _cold("soft4")
    sp = _port(s, m, n)
    stp = convert.settings_from_jax(st)
    calls = []
    polish = dense.polish

    def spy(s, st):
        out = polish(s, st)
        calls.append(int(out.status[0]))
        if len(calls) == 3:
            out = out._replace(status=torch.where(
                torch.arange(out.status.shape[0]) == 0, dt.EXIT_RUNNING,
                out.status).to(torch.int32))
        return out

    monkeypatch.setattr(dense, "polish", spy)
    out = dense.dense_solve(sp, stp, n_true=n)
    assert len(calls) == 3
    assert calls[-1] in (dt.EXIT_OPTIMAL, dt.EXIT_SOFT_OPTIMAL)
    assert int(out.status[0]) < 0, int(out.status[0])
    assert (out.status[1:] > 0).all()
