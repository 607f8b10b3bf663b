"""The port's batched AVI tier (daqp_tpu_torch.batch
``solve_batch_avi_kernel``, kernel B5 ``run_avi_segment``) on its CPU
twins: one B5 segment against the JAX kernel it replaces
(``ops/pallas_slot.py run_avi_segment``, Pallas interpret mode) from one
cold state, the tier against the JAX tier (``batch.py
solve_batch_avi_pallas_jit``, interpret mode) and the constructed
solutions of ``tests/gen.py``, the unconstrained shortcut, two-sided
batches with every lane accounted for, and the exact KKT step's
certificate.

Run as a script (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_avi.py``) it measures the JAX tier's own optimal rate on
configAVI (``bench_extra.py:299-339``), the number behind
``chip_smoke.py``'s ``JAX_AVI_OPT_RATE``."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import batch as jbatch
from daqp_tpu import transform as jtransform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import pallas_slot as ps
from daqp_tpu.types import IMMUTABLE, ACTIVE
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, convert
from daqp_tpu_torch.ops import slot as pslot
from tests.gen import generate_test_avi, generate_test_avi_two_sided

ROOT = Path(__file__).resolve().parents[1]
KEYS = ('H', 'f', 'A', 'bupper', 'blower')


def _one_sided(B=16, n=8, m=20, seed=41):
    """test_batch_avi.py:14-26: upper bounds only."""
    rng = np.random.default_rng(seed)
    probs = [generate_test_avi(n, m, rng) for _ in range(B)]
    d = {k: np.stack([p[i] for p in probs])
         for i, k in enumerate(('x', 'H', 'f', 'A', 'bupper'))}
    d['blower'] = np.full((B, m), -1e30)
    return d


def _two_sided(B, n=20, m=50, seed=83):
    """test_batch_avi.py:70-85: two-sided bounds."""
    rng = np.random.default_rng(seed)
    probs = [generate_test_avi_two_sided(n, m, rng) for _ in range(B)]
    return {k: np.stack([p[i] for p in probs])
            for i, k in enumerate(('x',) + KEYS)}


def _f32(d, keys=KEYS):
    return [d[k].astype(np.float32) for k in keys]


@functools.partial(jax.jit, static_argnames=("st",))
def _jax_cold_operands(H, f, A, bu, bl, sense, st):
    """The operands of the JAX tier's first fused segment, as
    solve_batch_avi_pallas_jit builds them (batch.py:1640-1882)."""
    B, n = H.shape[0], H.shape[-1]
    m = bu.shape[-1]
    f32 = jnp.float32
    Hsym = 0.5 * (H + jnp.swapaxes(H, 1, 2))
    min_diag = jnp.min(jnp.diagonal(Hsym, axis1=1, axis2=2), axis=1)
    max_rs = jnp.max(jnp.sum(jnp.abs(Hsym), axis=2), axis=1)
    fro = jnp.sqrt(jnp.sum(H * H, axis=(1, 2)))
    rho = jnp.where((min_diag > 0) & (max_rs > 0),
                    jnp.sqrt(jnp.maximum(min_diag * max_rs, 1e-30)),
                    fro / 2)
    eyen = jnp.eye(n, dtype=f32)
    Hs_rho = Hsym + rho[:, None, None] * eyen
    H_rho_lu = jax.vmap(jax.scipy.linalg.lu_factor)(
        H + rho[:, None, None] * eyen)
    ldpd = jax.vmap(lambda H_, A_, bu_, bl_, se_: jtransform.build_ldp(
        H_, None, A_, bu_, bl_, se_, 0, st))(Hs_rho, A, bu, bl, sense)
    immut = ((ldpd.sense & IMMUTABLE) > 0).astype(f32)
    s0 = ps.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                      n_true=n)
    mp, pad_n = s0.dupper.shape[0], s0.u.shape[0] - n
    x_unc = jax.vmap(jax.scipy.linalg.lu_solve)(
        jax.vmap(jax.scipy.linalg.lu_factor)(H), -f)
    r_unc = jnp.einsum('bmn,bn->bm', A, x_unc)
    unc_ok = jnp.all((r_unc <= bu + st.primal_tol)
                     & (r_unc >= bl - st.primal_tol), axis=1) \
        & ~jnp.any((ldpd.sense & (ACTIVE | IMMUTABLE)) > 0, axis=1)
    lane_run0 = (ldpd.error >= 0) & ~unc_ok
    flag0 = jnp.where(ldpd.error < 0, ldpd.error,
                      jnp.where(unc_ok, 1, 99)).astype(jnp.int32)

    def padM(Mx):
        return jnp.moveaxis(jnp.pad(Mx, ((0, 0), (0, pad_n), (0, pad_n))),
                            0, -1)

    def rows(x, fill):
        return jnp.pad(x, ((0, 0), (0, mp - m)), constant_values=fill).T

    Hri = jax.vmap(jax.scipy.linalg.lu_solve)(
        H_rho_lu, jnp.broadcast_to(eyen, (B, n, n)))
    mats = (padM(ldpd.Rinv), padM(H - Hs_rho),
            padM(0.5 * Hsym + rho[:, None, None] * eyen),
            padM(H - 0.5 * Hsym), padM(Hri),
            jnp.pad(f, ((0, 0), (0, pad_n))).T,
            rows(bu * ldpd.scaling, 1e30), rows(bl * ldpd.scaling, -1e30))
    zn = jnp.zeros((n + pad_n, B), f32)
    carries = (zn, zn, zn, jnp.full((1, B), 1e30, f32),
               jnp.zeros((1, B), f32), jnp.full((1, B), 5.0, f32),
               lane_run0.astype(f32)[None], flag0[None],
               jnp.zeros((1, B), f32))
    return s0, carries, mats


def test_segment_twin_matches_jax_kernel():
    # 16 lanes, tiled to the JAX kernel's 128-lane tile
    d = _one_sided()
    BP = 16
    tiled = [np.tile(a, (8,) + (1,) * (a.ndim - 1)) for a in _f32(d)]
    st = _as_settings({"iter_limit": 1500}, jnp.float32)
    s0, carries, mats = _jax_cold_operands(
        *map(jnp.asarray, tiled), jnp.zeros((128, 20), jnp.int32), st)
    jo = jax.tree_util.tree_map(np.asarray, ps.run_avi_segment(
        s0, carries, mats, st, 8, P=8, steps=64, interpret=True))
    s = pslot.SlotState(*(x[:BP].contiguous()
                          for x in convert.slot_state_from_jax(s0)))
    lanes = [convert.from_lanes_last(
        a, torch.int32 if i == 7 else torch.float32)[:BP]
        for i, a in enumerate(carries)]
    ops_ = [convert.from_lanes_last(a)[:BP] for a in mats]
    po = pslot.run_avi_segment_plain(s, *lanes, *ops_,
                                     convert.settings_from_jax(st), 8, P=8,
                                     steps=64)
    x, lr, lf = po[1].numpy(), po[7].numpy(), po[8].numpy()
    failed, kkt = po[10].numpy(), po[11].numpy()
    xj, lrj, lfj = jo[1][0].T[:BP], jo[1][6][0, :BP], jo[1][7][0, :BP]
    agree = (lf == lfj) & (lr == lrj) & (failed == jo[2][:BP]) \
        & (kkt == jo[3][:BP])
    assert agree.sum() >= BP - 1, (lf, lfj, lr, lrj, failed, kkt, jo[3])
    gap = np.abs(x - xj).max(1)[agree]
    assert (gap <= 1e-3 * (1.0 + np.abs(xj).max(1)[agree])).all(), gap


@functools.lru_cache(maxsize=None)
def _jax_tier_one_sided():
    d = _one_sided()
    st = _as_settings({"iter_limit": 1500}, jnp.float32)
    rj = jbatch.solve_batch_avi_pallas_jit(
        *map(jnp.asarray, _f32(d)), jnp.zeros((16, 20), jnp.int32), st,
        ms=0, interpret=True)
    return np.asarray(rj.exitflag), np.asarray(rj.x)


@pytest.mark.parametrize("fused", [True, False])
def test_tier_matches_jax_and_constructed_solution(fused):
    d = _one_sided()
    fj, xj = _jax_tier_one_sided()
    rp = dt.solve_batch_avi_kernel(*_f32(d), None,
                                   dt.as_settings({"iter_limit": 1500},
                                                  torch.float32),
                                   fused=fused, device="cpu")
    fp, xp = rp.exitflag.numpy(), rp.x.numpy()
    ok = fp == 1
    assert ok.mean() >= 0.9, np.unique(fp, return_counts=True)
    assert np.abs(xp - d['x']).max(1)[ok].max() < 1e-3
    # the flag class (optimal / loud) agrees with the JAX tier
    assert ((fp == 1) == (fj == 1)).sum() >= 15, (fp, fj)
    assert np.abs(xp - xj).max(1)[ok & (fj == 1)].max() < 2e-3
    # lam is the KKT step's on the optimal lanes: H x + f + A' lam = 0
    g = np.einsum('bij,bj->bi', d['H'], xp) + d['f'] \
        + np.einsum('bmi,bm->bi', d['A'], rp.lam.numpy())
    assert np.abs(g).max(1)[ok].max() < 1e-2 * (1 + np.abs(d['f']).max())


def test_unconstrained_shortcut():
    # test_batch_avi.py:45-67: interior unconstrained points exit at once
    rng = np.random.default_rng(3)
    B, n, m = 8, 5, 10
    Q = rng.standard_normal((B, n, n))
    H = np.einsum('bij,bkj->bik', Q, Q) + 2 * np.eye(n)
    H = H + 0.1 * rng.standard_normal((B, n, n))
    f = 0.01 * rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    bu, bl = np.full((B, m), 50.0), np.full((B, m), -50.0)
    st = dt.default_settings_f32()
    r = dt.solve_batch_avi_kernel(*(a.astype(np.float32)
                                    for a in (H, f, A, bu, bl)),
                                  None, st, device="cpu")
    assert (r.exitflag.numpy() == 1).all()
    res = np.einsum('bij,bj->bi', H, r.x.numpy()) + f
    assert np.abs(res).max() < 1e-3
    assert (r.lam.numpy() == 0).all()


def test_two_sided_every_lane_accounted():
    # test_batch_avi.py:70-103 at B = 32, the port alone: a lane is
    # optimal within 1e-3 of the constructed x, or loud and then solved by
    # the f64 single-instance oracle
    spec = importlib.util.spec_from_file_location("chip_smoke_avi",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    avi_or = cs.oracle_module("avi_numpy")
    d = _two_sided(32)
    r = dt.solve_batch_avi_kernel(*_f32(d), None,
                                  dt.as_settings({"iter_limit": 3000},
                                                 torch.float32),
                                  device="cpu")
    flags, x = r.exitflag.numpy(), r.x.numpy()
    err = np.abs(x - d['x']).max(1)
    for b in range(32):
        if flags[b] == 1:
            assert err[b] < 1e-3, (b, err[b])
        else:
            assert flags[b] < 0, (b, flags[b])
            ref = avi_or.solve_avi(*(d[k][b] for k in KEYS))
            assert ref['exitflag'] == 1
            assert np.abs(ref['x'] - d['x'][b]).max() < 1e-5


def test_segment_passes_compose_and_return_bounds():
    # a segment is its passes: P = 2 equals two P = 1 segments chained,
    # and each pass's bounds are d = b_s + M Rinv'(G1 x + f) from the x it
    # starts from (NaN on a lane that ran no pass), which chip_smoke.py's
    # k5 replays K2 from
    d = _two_sided(8, n=6, m=12, seed=5)
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    a = pbatch.avi_init(*map(torch.as_tensor, _f32(d)), None, st,
                        device="cpu")
    ops_ = pbatch.avi_segment_operands(a)
    carry = pbatch.avi_carries(a)
    two = pslot.run_avi_segment(a.s, *carry, *ops_, st, 6, P=2, bounds=True)
    one = pslot.run_avi_segment(a.s, *carry, *ops_, st, 6, P=1, bounds=True)
    again = pslot.run_avi_segment(one[0], *one[1:10], *ops_, st, 6, P=1,
                                  bounds=True)
    assert (one[10] == 0).all() and (one[11] == 0).all()
    for x, y in zip(two[1:12], again[1:12]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    ran = carry[6] > 0
    assert ran.any() and not ran.all()
    for out, x in ((one, carry[0]), (two, one[1])):
        _, du, dl = pslot.avi_pass_bounds(a.s, x, ops_[0], ops_[1], ops_[5],
                                          ops_[6], ops_[7])
        torch.testing.assert_close(out[12][ran], du[ran], rtol=0, atol=0)
        torch.testing.assert_close(out[13][ran], dl[ran], rtol=0, atol=0)
        assert out[12][~ran].isnan().all() and out[13][~ran].isnan().all()


def test_kkt_step_certifies_only_true_solutions():
    # the exact KKT step on each lane's true working set certifies it;
    # with the row of the largest multiplier dropped from the set, it must
    # not certify the lane
    d = _two_sided(16, n=8, m=20, seed=5)
    st = dt.default_settings_f32()
    a = pbatch.avi_init(*(torch.as_tensor(x) for x in _f32(d)), None, st,
                        device="cpu")
    Ax = np.einsum('bmn,bn->bm', d['A'], d['x'])
    up = torch.as_tensor(np.abs(Ax - d['bupper']) < 1e-9)
    lo = torch.as_tensor(np.abs(Ax - d['blower']) < 1e-9)
    has = (up | lo).any(1)
    assert has.sum() >= 8
    every = torch.ones(16, dtype=torch.bool)
    s_true = pslot.slot_activate(a.s, up, lo, st)
    x, lamK, cert = pbatch.kkt_all(s_true, every, a.prob, st)
    assert cert.all(), cert
    assert np.abs(x.numpy() - d['x']).max() < 1e-3
    # drop the active row with the largest |multiplier| on each lane
    lam_rows = torch.zeros(16, 20).scatter_add_(
        1, s_true.sid.clamp(min=0).long(), lamK * s_true.used)
    drop = torch.nn.functional.one_hot(lam_rows.abs().argmax(1), 20) > 0
    s_drop = pslot.slot_activate(a.s, up & ~drop, lo & ~drop, st)
    _, _, cert_drop = pbatch.kkt_all(s_drop, every, a.prob, st)
    assert not cert_drop[has].any(), cert_drop
    # lanes outside lane_do are never certified
    _, _, none = pbatch.kkt_all(s_true, ~every, a.prob, st)
    assert not none.any()


def jax_config_avi_rate():
    """The JAX tier's optimal rate and accuracy on configAVI (B = 256,
    n = 20, m = 50, seed 29; bench_extra.py:306-318), iter_limit 1000, in
    interpret mode on the CPU."""
    import time
    rng = np.random.default_rng(29)
    probs = [generate_test_avi_two_sided(20, 50, rng) for _ in range(256)]
    d = {k: np.stack([p[i] for p in probs])
         for i, k in enumerate(('x',) + KEYS)}
    st = _as_settings({"iter_limit": 1000}, jnp.float32)
    t0 = time.perf_counter()
    rj = jbatch.solve_batch_avi_pallas_jit(
        *map(jnp.asarray, _f32(d)), jnp.zeros((256, 50), jnp.int32), st,
        ms=0, interpret=True)
    flags = np.asarray(rj.exitflag)
    err = np.abs(np.asarray(rj.x) - d['x']).max(1)
    return dict(optimal_rate=float(np.mean(flags == 1)),
                accurate_optimal=int(np.sum((flags == 1) & (err < 1e-3))),
                flags={int(k): int(v) for k, v in zip(*np.unique(
                    flags, return_counts=True))},
                seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    print(jax_config_avi_rate())
