"""The port's semidefinite proximal batch (daqp_tpu_torch.batch
``solve_batch_prox_kernel``, kernel B4 ``run_prox_segment``) on its CPU
twins, against the JAX package's Pallas tier in interpret mode
(``batch.solve_batch_prox_pallas_jit``, ``ops/pallas_slot.py
run_prox_segment``) and the f64 single-instance solver, at the sizes of
test_semidefinite.py and test_fused_tiers.py; and the port's transform
(``factorize_hessian``, the H branch of ``build_ldp``, ``update_vd``)
against JAX's in f64."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daqp_tpu
from daqp_tpu import batch as jbatch
from daqp_tpu import transform as jtransform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import chol as jchol
from daqp_tpu.ops import pallas_slot as ps
from daqp_tpu.prox import _auto_eta
from daqp_tpu.types import IMMUTABLE
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, convert, prox as pprox
from daqp_tpu_torch import transform as ptransform
from daqp_tpu_torch.ops import slot as pslot

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
OVER = {"iter_limit": 1000}


def _semidefinite(B, n, m, rank, seed):
    """test_semidefinite.py's rank-deficient batch."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, n, rank)).astype(np.float32)
    return dict(H=np.einsum('bir,bjr->bij', Q, Q),
                f=rng.standard_normal((B, n)).astype(np.float32),
                A=rng.standard_normal((B, m, n)).astype(np.float32),
                bupper=(5 + 5 * rng.random((B, m))).astype(np.float32),
                blower=-(5 + 5 * rng.random((B, m))).astype(np.float32),
                sense=np.zeros((B, m), np.int32))


def _mixed_pd(B=128, n=10, m=24):
    """test_semidefinite.py's mixed batch: PD lanes beside semidefinite
    ones."""
    rng = np.random.default_rng(13)
    Q = rng.standard_normal((B, n, n)).astype(np.float32)
    H = np.einsum('bij,bkj->bik', Q, Q) + np.eye(n, dtype=np.float32)
    Qs = rng.standard_normal((B // 2, n, n // 2)).astype(np.float32)
    H[:B // 2] = np.einsum('bir,bjr->bij', Qs, Qs)
    return dict(H=H, f=rng.standard_normal((B, n)).astype(np.float32),
                A=rng.standard_normal((B, m, n)).astype(np.float32),
                bupper=(4 + 4 * rng.random((B, m))).astype(np.float32),
                blower=-(4 + 4 * rng.random((B, m))).astype(np.float32),
                sense=np.zeros((B, m), np.int32))


@functools.partial(jax.jit, static_argnames=("st",))
def _jax_cold_segment_operands(H, f, A, bu, bl, sense, st):
    """The operands of JAX's first fused segment, as
    solve_batch_prox_pallas_jit builds them (batch.py:752-942)."""
    B, n = H.shape[0], H.shape[-1]
    m = bu.shape[-1]
    Rinv, okl, regl, eps_l = jchol.batched_rinv_regularized(
        H, st, interpret=True)
    ldpd = jax.vmap(lambda H_, f_, A_, bu_, bl_, se_, R_: jtransform.build_ldp(
        H_, f_, A_, bu_, bl_, se_, 0, st, Rinv=R_))(H, f, A, bu, bl, sense,
                                                   Rinv)
    eps = jnp.where(regl, eps_l, 0.0).astype(jnp.float32)
    tst = jnp.asarray(_auto_eta(st), jnp.float32) / jnp.maximum(eps, 1e-30)
    immut = ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32)
    s0 = ps.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                      n_true=n)
    mp, pad_n = s0.dupper.shape[0], s0.u.shape[0] - n

    def rows(x, fill):
        return jnp.pad(x, ((0, 0), (0, mp - m)), constant_values=fill).T

    return (s0, jnp.zeros((n + pad_n, B), jnp.float32),
            okl.astype(jnp.float32)[None], jnp.zeros((1, B), jnp.float32),
            jnp.full((1, B), jnp.inf, jnp.float32),
            jnp.where(okl, 99, -5).astype(jnp.int32)[None],
            jnp.zeros((1, B), jnp.float32),
            jnp.moveaxis(jnp.pad(Rinv, ((0, 0), (0, pad_n), (0, pad_n))),
                         0, -1),
            jnp.pad(f, ((0, 0), (0, pad_n))).T,
            rows(bu * ldpd.scaling, 1e30), rows(bl * ldpd.scaling, -1e30),
            eps[None], tst[None])


def test_segment_twin_matches_jax_kernel():
    d = _semidefinite(128, 10, 24, 6, seed=5)
    st = _as_settings(OVER, jnp.float32)
    ops = _jax_cold_segment_operands(*[jnp.asarray(d[k]) for k in KEYS], st)
    jo = jax.tree_util.tree_map(np.asarray, ps.run_prox_segment(
        *ops, st, 10, P=8, steps=64, interpret=True))
    s = convert.slot_state_from_jax(ops[0])   # JAX-padded: n, K 16
    lanes = [convert.from_lanes_last(
        a, torch.int32 if i == 4 else torch.float32)
        for i, a in enumerate(ops[1:])]
    po = pslot.run_prox_segment_plain(s, *lanes,
                                      convert.settings_from_jax(st), 10,
                                      P=8, steps=64)
    sp = convert.slot_state_to_numpy(po[0])
    x, lr, _, _, lf, tot, failed = (a.numpy() for a in po[1:])
    xj = jo[1].T
    # exit flag, run flag, failed flag and working set agree lane by lane
    agree = (lf == jo[5][0]) & (lr == jo[2][0]) & (failed == jo[7]) \
        & (sp['act_up'] == jo[0].act_up).all(0) \
        & (sp['act_lo'] == jo[0].act_lo).all(0)
    assert agree.sum() >= 127, agree.sum()
    assert not failed.any()
    assert (tot == jo[6][0])[agree].mean() >= 0.95
    # u with the kernel-vs-twin gate of chip_smoke.py's K2 phase: the LDP
    # rows of a rank-deficient H are near-dependent, max|E| reaches ~800,
    # and the f32 gap of u after the cold pass is up to 5.4e-4 (1 + |u|)
    # (median 1.5e-5); x = Rinv (u - v) carries it times ||Rinv||_inf
    uj, up = jo[0].u.T[agree], sp['u'].T[agree]
    uscale = 1.0 + np.abs(uj).max(1)
    assert (np.abs(up - uj).max(1) <= 1e-3 * uscale).all()
    rnorm = np.abs(lanes[6].numpy()).sum(2).max(1)[agree]
    gap = np.abs(x - xj).max(1)[agree]
    assert (gap <= 1e-3 * uscale * rnorm).all(), gap.max()


def _f64_ref(d, lanes):
    return {b: np.asarray(daqp_tpu.quadprog(*(d[k][b].astype(np.float64)
                                              for k in KEYS[:5]), ms=0).x)
            for b in lanes}


def _check(rp, rj, d, lanes):
    """Flags agree with JAX on >= 127 of 128 lanes, and a lane where they
    part is loud in the port; x within 2e-3 of the f64 solver on the
    sampled lanes (test_semidefinite.py's gate), and of JAX's x up to
    JAX's own distance to the f64 answer.

    Why not every flag: the two f32 paths part at ties like K2 and its
    twin (test_torch_slot.py); in the mixed batch one degenerate lane
    cycles and is repaired in every pass, and in the port it cycles twice
    in one pass and exits CYCLE where JAX exits optimal.  Why the
    triangle: JAX's fused x itself sits up to 1.95e-3 from the f64 answer
    on these lanes (the port's 1.1e-3), so the two can be 2.4e-3 apart."""
    fp, fj = rp.exitflag.numpy(), np.asarray(rj.exitflag)
    assert (fp == fj).sum() >= 127, np.unique(fp, return_counts=True)
    assert (fp[fp != fj] != 1).all()
    assert (fj == 1).all()
    xp, xj = rp.x.numpy(), np.asarray(rj.x)
    for b, ref in _f64_ref(d, lanes).items():
        if fp[b] != 1:
            continue
        err_j = np.linalg.norm(xj[b] - ref)
        assert np.linalg.norm(xp[b] - ref) < 2e-3, b
        assert np.linalg.norm(xp[b] - xj[b]) < 2e-3 + err_j, b


@pytest.mark.parametrize("case,fused", [("rank_deficient", True),
                                        ("mixed_pd", False),
                                        ("mixed_pd", True)])
def test_prox_matches_jax(case, fused):
    if case == "rank_deficient":
        d, lanes = _semidefinite(128, 20, 40, 12, seed=11), range(0, 128, 11)
    else:
        d, lanes = _mixed_pd(), range(0, 128, 17)
    rj = jbatch.solve_batch_prox_pallas_jit(
        *[jnp.asarray(d[k]) for k in KEYS], _as_settings(OVER, jnp.float32),
        ms=0, interpret=True, fused="force" if fused else False)
    rp = dt.solve_batch_prox_kernel(*[d[k] for k in KEYS],
                                    dt.as_settings(OVER, torch.float32),
                                    fused=fused, device="cpu")
    _check(rp, rj, d, lanes)
    stat, viol = dt.kkt_residuals(*[d[k] for k in KEYS], rp.x, rp.lam)
    opt = rp.exitflag.numpy() == 1
    assert stat[opt].max() < 1e-3 and viol[opt].max() < 1e-3


def test_failed_lanes_resume_per_lane(monkeypatch):
    # 4 inner steps per pass are too few for the cold first pass: lanes
    # freeze inside B4's twin and resume on the per-pass path (slot_solve
    # rounds of 4 steps), lane by lane
    d = _semidefinite(128, 10, 24, 5, seed=5)
    st = dt.as_settings(OVER, torch.float32)
    args = [d[k] for k in KEYS]
    free = dt.solve_batch_prox_kernel(*args, st, fused=True, device="cpu")
    resumed = []
    run = pslot.run_prox_segment

    def spy(*args, **kw):
        out = run(*args, **kw)
        resumed.append(int((out[-1] > 0).sum()))
        return out

    monkeypatch.setattr(pslot, "run_prox_segment", spy)
    monkeypatch.setattr(pbatch, "PROX_STEPS", 4)
    r = dt.solve_batch_prox_kernel(*args, st, fused=True, device="cpu")
    assert resumed[0] > 0, resumed
    assert (r.exitflag.numpy() == 1).all()
    assert (free.exitflag.numpy() == 1).all()
    xp = r.x.numpy()
    for b, ref in _f64_ref(d, range(0, 128, 11)).items():
        assert np.linalg.norm(xp[b] - ref) < 2e-3, b
        assert np.linalg.norm(xp[b] - free.x[b].numpy()) < 2e-3, b


def _hessians(B=12, n=6, seed=3):
    """Diagonal (one with zero entries), dense PD and dense singular
    lanes, f64."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, n, n))
    H = np.einsum('bij,bkj->bik', Q, Q) + 0.5 * np.eye(n)
    H[:3] = np.eye(n) * rng.random((3, 1, n))             # diagonal PD
    H[3] = np.diag([2.0, 0.0, 1.0, 0.0, 3.0, 1e-14])        # diagonal, singular
    Qs = rng.standard_normal((4, n, n - 3))
    H[4:8] = np.einsum('bir,bjr->bij', Qs, Qs)             # dense singular
    return H


def _close(a, b, kappa):
    """Per lane |a - b| <= 1e-12 kappa (1 + max|b|): the f64 gate of
    test_torch_batch.py scaled by the condition number of the factored
    matrix, the forward-error bound of the Cholesky and triangular
    solve (kappa reaches ~1e5 on the regularized singular lanes, where
    the two LAPACK paths then differ by ~1e-11 relative)."""
    B = a.shape[0]
    gap = (a - b).abs().reshape(B, -1).amax(1)
    scale = 1.0 + b.abs().reshape(B, -1).amax(1)
    return bool((gap <= 1e-12 * kappa * scale).all())


def _kappa(H, eps):
    n = H.shape[-1]
    return torch.as_tensor(np.linalg.cond(H + np.asarray(eps)[:, None, None]
                                          * np.eye(n)))


def test_factorize_hessian_matches_jax():
    H = _hessians()
    st = _as_settings(None, jnp.float64)
    jf = jax.vmap(lambda h: jtransform.factorize_hessian(h, st))(
        jnp.asarray(H))
    pf = ptransform.factorize_hessian(torch.as_tensor(H),
                                      convert.settings_from_jax(st))
    kappa = _kappa(H, jf[3])
    names = ("Rinv", "prox_mask", "n_prox", "eps_used", "error")
    for name, a, b in zip(names, pf, jf):
        b = torch.as_tensor(np.array(b))
        if a.dtype.is_floating_point:
            assert _close(a, b, kappa), name
        else:
            assert torch.equal(a, b.to(a.dtype)), name
    assert (pf[3][4:8] > 0).all() and pf[2][3] == 3


def test_build_ldp_h_branch_and_update_vd_match_jax():
    H = _hessians()
    B, n, m = H.shape[0], H.shape[1], 9
    rng = np.random.default_rng(4)
    A = rng.standard_normal((B, m, n))
    bu, bl = 1 + rng.random((B, m + 2)), -1 - rng.random((B, m + 2))
    f, f2 = rng.standard_normal((2, B, n))
    sense = np.zeros((B, m + 2), np.int32)
    st = _as_settings(None, jnp.float64)
    lj = jax.vmap(functools.partial(jtransform.build_ldp, ms=2, st=st))(
        *map(jnp.asarray, (H, f, A, bu, bl, sense)))
    lj2 = jax.vmap(jtransform.update_vd)(lj, *map(jnp.asarray,
                                                  (f2, 2 * bu, 2 * bl)))
    pst = convert.settings_from_jax(st)
    lp = ptransform.build_ldp(*map(torch.as_tensor, (f, A, bu, bl, sense)),
                              2, pst, H=torch.as_tensor(H))
    lp2 = ptransform.update_vd(lp, *map(torch.as_tensor, (f2, 2 * bu,
                                                           2 * bl)))
    kappa = _kappa(H, lj.eps_used)
    for p, j in ((lp, lj), (lp2, lj2)):
        j = convert.ldp_from_jax(j)
        for name in ('sense', 'error', 'n_prox', 'prox_mask'):
            assert torch.equal(getattr(p, name), getattr(j, name)), name
        for name in ('M', 'dupper', 'dlower', 'scaling', 'v', 'Rinv',
                     'eps_used'):
            assert _close(getattr(p, name), getattr(j, name), kappa), name


def test_auto_eta_matches_jax():
    for over in (None, {"eta_prox": 3e-7}, {"dual_tol": 1e-6},
                 {"dual_tol": 1e-3}):
        js = _as_settings(over, jnp.float64)
        assert pprox.auto_eta(convert.settings_from_jax(js)) \
            == float(_auto_eta(js))
