"""The port's batched LP tier (daqp_tpu_torch.batch
``solve_batch_lp_kernel``, kernel B6 ``run_lp_segment``) on its CPU
twins: the LP branch of ``build_ldp`` and the bordered ``slot_add_row``
against the JAX package's, one B6 segment against the JAX kernel it
replaces (``ops/pallas_slot.py run_lp_segment``, Pallas interpret mode)
from one cold state, the tier on both paths against the JAX tier
(``batch.py solve_batch_lp_pallas_jit``, interpret mode) and the
generator's constructed vertex, an unbounded lane, and an equality row.

The accuracy gate is ``bench_extra.py:270-279``'s: a lane passes when it
is flag 1 with a relative objective gap < 1e-4 and a feasibility
violation < 1e-4 (||x - x_ref|| is ill-posed at degenerate vertices).

Run as a script (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_lp.py``) it prints the JAX tier's census on configLP
(``bench_extra.py:245-296``: B = 256, n = 10, m = 50, seed 17) for both
paths, the numbers behind ``chip_smoke.py``'s ``lp`` gates."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import batch as jbatch
from daqp_tpu import transform as jtransform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import pallas_slot as ps
from daqp_tpu.prox import _auto_eta_static
from daqp_tpu.types import ACTIVE, IMMUTABLE
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, convert
from daqp_tpu_torch import transform as ptransform
from daqp_tpu_torch.ops import slot as pslot
from tests.gen import generate_test_lp

KEYS = ('f', 'A', 'bupper', 'blower')
B, N, M, SEED = 128, 6, 16, 7          # test_fused_tiers.py:52-56
PATHS = {"per_pass": (False, False), "fused": ("force", True)}


def _lp_batch(Bn, n, m, seed):
    rng = np.random.default_rng(seed)
    probs = [generate_test_lp(n, m, 0, rng) for _ in range(Bn)]
    return {k: np.stack([p[i] for p in probs])
            for i, k in enumerate(('x',) + KEYS)}


def _f32(d):
    return [d[k].astype(np.float32) for k in KEYS]


def gate(d, x):
    """bench_extra.py:273-279: (relative objective gap, feasibility
    violation) per lane, in f64 against the constructed vertex."""
    fv_ref = np.einsum('bn,bn->b', d['f'], d['x'])
    gap = np.abs(np.einsum('bn,bn->b', d['f'], x) - fv_ref) \
        / (1.0 + np.abs(fv_ref))
    Ax = np.einsum('bmn,bn->bm', d['A'], x)
    feas = np.maximum((Ax - d['bupper']).max(1), (d['blower'] - Ax).max(1))
    return gap, feas


def stationarity(d, lam):
    return np.abs(d['f'] + np.einsum('bmn,bm->bn', d['A'], lam)).max(1)


def _st():
    return (_as_settings({"iter_limit": 3000}, jnp.float32),
            dt.as_settings({"iter_limit": 3000}, torch.float32))


def _jax_tier(d, sense, fused):
    st = _st()[0]
    r = jbatch.solve_batch_lp_pallas_jit(
        *map(jnp.asarray, _f32(d)), jnp.asarray(sense), st, ms=0,
        interpret=True, fused=fused)
    return {k: np.asarray(getattr(r, k)) for k in
            ('x', 'lam', 'exitflag', 'iterations')}


@pytest.fixture(scope="module")
def lp128():
    return _lp_batch(B, N, M, SEED)


@pytest.fixture(scope="module")
def jax_tier(lp128):
    """The JAX tier on the 128 lanes, each path run once (compiling the
    program that test_batch_lp_equality_row reuses)."""
    sense = np.zeros((B, M), np.int32)
    return functools.lru_cache(maxsize=None)(
        lambda path: _jax_tier(lp128, sense, PATHS[path][0]))


def test_lp_mode_build_ldp_matches_jax():
    # f64, with an equality row (auto-marked ACTIVE | IMMUTABLE) and a zero
    # row (IMMUTABLE) among the generator's rows
    d = _lp_batch(8, 5, 12, 3)
    d['blower'][:, 2] = d['bupper'][:, 2]
    d['A'][:, 4] = 0.0
    d['bupper'][:, 4], d['blower'][:, 4] = 1.0, -1.0
    sense = np.zeros((8, 12), np.int32)
    jst = _as_settings(None, jnp.float64)
    jl = jax.jit(jax.vmap(lambda A_, bu_, bl_, se_: jtransform.build_ldp(
        None, None, A_, bu_, bl_, se_, 0, jst)))(
        *map(jnp.asarray, (d['A'], d['bupper'], d['blower'], sense)))
    pl = ptransform.build_ldp(None, *map(torch.as_tensor, (
        d['A'], d['bupper'], d['blower'], sense)), 0, dt.Settings())
    for name in ('M', 'scaling', 'dupper', 'dlower', 'Rinv', 'v'):
        np.testing.assert_allclose(getattr(pl, name).numpy(),
                                   np.asarray(getattr(jl, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name in ('sense', 'prox_mask', 'n_prox', 'error'):
        np.testing.assert_array_equal(getattr(pl, name).numpy(),
                                      np.asarray(getattr(jl, name)))
    assert pl.prox_mask.all() and (pl.n_prox == 5).all()
    assert ((pl.sense[:, 2] & (ACTIVE | IMMUTABLE)) > 0).all()
    assert ((pl.sense[:, 4] & IMMUTABLE) > 0).all()


def test_slot_add_row_matches_jax():
    # one JAX slot state, rows 0-1 active (rows 0-5 on the full lane),
    # then one bordered add per lane: lanes 0-11 and 15 add row 7 (even
    # lanes on its lower side), lane 12 is masked off, lane 13's table is
    # full (n_true rows), lane 14 adds a copy of its active row 0
    # (dependent: gated)
    Bn, n, m = 16, 6, 16
    d = _lp_batch(Bn, n, m, 11)
    d['A'][14, 9] = d['A'][14, 0]
    A, bu, bl = (d[k].astype(np.float32) for k in ('A', 'bupper', 'blower'))
    jst, pst = _st()
    up = np.zeros((m, Bn), bool)
    up[:2] = True
    up[:n, 13] = True

    @jax.jit
    def jax_state(A, bu, bl, up):
        ldpd = jax.vmap(lambda A_, bu_, bl_: jtransform.build_ldp(
            None, None, A_, bu_, bl_, None, 0, jst))(A, bu, bl)
        immut = ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32)
        s0 = ps.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                          immut, n_true=n)
        return ps.slot_activate(s0, up, jnp.zeros_like(up), jst)

    sj = jax_state(*map(jnp.asarray, (A, bu, bl, up)))
    row = np.full(Bn, 7)
    row[14] = 9
    lo = (np.arange(Bn) % 2 == 0).astype(np.float32)
    mask = np.ones(Bn, np.float32)
    mask[12] = 0.0
    du, dl = np.asarray(sj.dupper), np.asarray(sj.dlower)
    dval = np.where(lo > 0, dl[row, np.arange(Bn)], du[row, np.arange(Bn)])
    oh = (np.arange(m)[:, None] == row[None, :]).astype(np.float32)
    jo = jax.jit(lambda *a: ps.slot_add_row(*a, jst, n))(
        sj, jnp.asarray(oh), jnp.asarray(lo[None]),
        jnp.asarray(dval[None].astype(np.float32)), jnp.asarray(mask[None]))
    sp = convert.slot_state_from_jax(sj)
    po = pslot.slot_add_row(sp, torch.as_tensor(row), torch.as_tensor(lo),
                            torch.as_tensor(dval), torch.as_tensor(mask),
                            pst, n)
    want = convert.slot_state_from_jax(jo)
    for name in pslot.SlotState._fields:
        np.testing.assert_allclose(getattr(po, name).numpy(),
                                   getattr(want, name).numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    added = (po.used.sum(1) - sp.used.sum(1)).numpy()
    assert (added[[12, 13, 14]] == 0).all() and (np.delete(
        added, [12, 13, 14]) == 1).all(), added
    assert (po.act_lo[:12:2, 7] == 1).all() and (po.act_up[1::2, 7][
        [0, 1, 2, 3, 4, 5, 7]] == 1).all()


@functools.partial(jax.jit, static_argnames=("st",))
def _jax_lp_cold(f, A, bu, bl, sense, st):
    """The state, carries and data of the JAX tier's first B6 launch, as
    solve_batch_lp_pallas_jit builds them (batch.py:1050-1267)."""
    Bn, n = f.shape
    m = bu.shape[-1]
    f32 = jnp.float32
    ldpd = jax.vmap(lambda A_, bu_, bl_, se_: jtransform.build_ldp(
        None, None, A_, bu_, bl_, se_, 0, st))(A, bu, bl, sense)
    immut = ((ldpd.sense & IMMUTABLE) > 0).astype(f32)
    s0 = ps.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                      n_true=n)
    mp, npad = s0.dupper.shape[0], s0.u.shape[0]

    def rows(x, fill):
        return jnp.pad(x, ((0, 0), (0, mp - m)), constant_values=fill).T

    data = (jnp.pad(f, ((0, 0), (0, npad - n))).T,
            rows(bu * ldpd.scaling, 1e30), rows(bl * ldpd.scaling, -1e30),
            rows(bu, 1e30), rows(bl, -1e30))
    run0 = ldpd.error >= 0
    flag0 = jnp.where(ldpd.error < 0, ldpd.error, 99).astype(jnp.int32)
    lp_vars = (jnp.zeros((npad, Bn), f32), jnp.ones((1, Bn), f32),
               jnp.zeros((1, Bn), f32), jnp.full((1, Bn), jnp.inf, f32),
               run0.astype(f32)[None], flag0[None], jnp.zeros((1, Bn), f32),
               jnp.zeros((1, Bn), f32))
    return s0._replace(status=jnp.full_like(s0.status, 1)), lp_vars, data


def test_lp_segment_twin_matches_jax(lp128):
    # one cold segment (P = 10, steps = 192) of the JAX kernel against the
    # port's twin from the same state and carries, with the twin in f64 as
    # the referee.  The segment's decisions sit at the f32 noise floor:
    # diff < eta eps (eta = 1e-7) is below f32 resolution, so lanes
    # converge on the stagnation count, and a ray step extrapolates along
    # x_new - x; the f32 twin agrees with its own f64 run on ~78% of the
    # lanes' flags (the JAX kernel with the twin on ~75%), while one pass
    # from the same state agrees on every lane.  So, as chip_smoke.py's
    # k5 / k6: the flags (failed, lane_run, lflag) agree on at least
    # 1 - 2 (1 - the twin's agreement with its f64 run), at most 0.97, of
    # the lanes, and per lane where all three agree the twin is no further
    # from the f64 run than twice the JAX kernel, plus 1e-3 (1 + ||x||).
    jst, pst = _st()
    s0, lp_vars, data = _jax_lp_cold(*map(jnp.asarray, _f32(lp128)),
                                     jnp.zeros((B, M), jnp.int32), jst)
    eta = _auto_eta_static(jst)
    _, v2, failed = jax.tree_util.tree_map(np.asarray, ps.run_lp_segment(
        s0, lp_vars, data, jst, N, eta, P=10, steps=192, interpret=True))

    def twin(cast):
        def c(t):
            return cast(t) if t.is_floating_point() else t
        return pslot.run_lp_segment_plain(
            pslot.SlotState(*map(c, convert.slot_state_from_jax(s0))),
            *map(c, convert.lp_vars_from_jax(lp_vars)),
            *(c(convert.from_lanes_last(a)) for a in data), pst, N, eta,
            P=10, steps=192)

    po, p64 = twin(lambda t: t), twin(torch.Tensor.double)
    jv = convert.lp_vars_from_jax(v2)

    def flags(fail, lr, lf):
        return np.stack([np.asarray(fail, np.float64), lr.numpy(),
                         lf.numpy()], 1)

    fp, f6 = flags(po[9], po[5], po[6]), flags(p64[9], p64[5], p64[6])
    fj = flags(failed, jv[4], jv[5])
    agree = (fp == fj).all(1)
    twin_f64 = (fp == f6).all(1).mean()
    gate_ = min(0.97, 1.0 - 2.0 * (1.0 - twin_f64))
    print("agree", agree.mean(), "gate", gate_, "parted", np.flatnonzero(
        ~agree))
    assert agree.mean() >= gate_, (agree.mean(), gate_)
    all3 = agree & (fp == f6).all(1)
    x64 = p64[1].numpy()
    d_p = np.abs(po[1].numpy() - x64).max(1)
    d_j = np.abs(jv[0].numpy() - x64).max(1)
    far = all3 & (d_p > 2.0 * d_j + 1e-3 * (1.0 + np.abs(x64).max(1)))
    assert not far.any(), (np.flatnonzero(far), d_p[far], d_j[far])
    assert all3.sum() >= B // 2 and (jv[4].numpy() == 0).mean() > 0.5


def test_lp_segment_passes_compose_and_return_bounds():
    # a segment is its passes: P = 2 equals two P = 1 segments chained, and
    # each pass's bounds are d = b_s + M (f eps - x) from the x and eps it
    # starts from (NaN on a lane that ran no pass), which chip_smoke.py's
    # k6 replays K2 from; the outer half equals the twin's pass
    d = _lp_batch(8, 6, 16, 5)
    st = _st()[1]
    p = pbatch.lp_init(*_f32(d), None, st, device="cpu")
    carry = list(pbatch.lp_carries(p))
    carry[4] = carry[4].clone()
    carry[4][3] = 0.0
    s = p.s0._replace(status=torch.full_like(p.s0.status, dt.EXIT_OPTIMAL))
    data = (p.f, p.bu_s, p.bl_s, p.bu_r, p.bl_r)

    def seg(s_, c, P):
        return pslot.run_lp_segment(s_, *c, *data, st, 6, p.eta, P=P,
                                    bounds=True)

    two, one = seg(s, carry, 2), seg(s, carry, 1)
    again = seg(one[0], one[1:9], 1)
    assert (one[9] == 0).all()
    for x, y in zip(tuple(two[0]) + two[1:12], tuple(again[0]) + again[1:12]):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    ran = carry[4] > 0
    for out, c in ((one, carry), (two, one[1:9])):
        _, du, dl = pslot.lp_pass_bounds(s, c[0], c[1], *data[:3])
        torch.testing.assert_close(out[10][ran], du[ran], rtol=0, atol=0)
        torch.testing.assert_close(out[11][ran], dl[ran], rtol=0, atol=0)
        assert out[10][~ran].isnan().all() and out[11][~ran].isnan().all()
    v, du, dl = pslot.lp_pass_bounds(s, carry[0], carry[1], *data[:3])
    inner = pslot.pass_solve(s, du, dl, ran, st, 6, 192)
    s_o, c_o, bad = pslot.lp_pass_outer(inner, tuple(carry), ran, v,
                                        *data[3:], st, 6, p.eta)
    for x, y in zip(c_o, one[1:9]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not bad.any()


@pytest.mark.parametrize("path", ["per_pass", "fused"])
def test_batch_lp_matches_jax(path, lp128, jax_tier):
    d = lp128
    jr = jax_tier(path)
    r = dt.solve_batch_lp_kernel(*_f32(d), None, _st()[1],
                                 fused=PATHS[path][1], device="cpu")
    flags, x, lam = r.exitflag.numpy(), r.x.numpy(), r.lam.numpy()
    fj = jr['exitflag']
    ok, okj = flags == 1, fj == 1
    assert ok.mean() >= 0.9, np.unique(flags, return_counts=True)
    gap, feas = gate(d, x)
    beyond = ok & ((gap >= 1e-4) | (feas >= 1e-4))
    gap_j, feas_j = gate(d, jr['x'])
    beyond_j = okj & ((gap_j >= 1e-4) | (feas_j >= 1e-4))
    stat, stat_j = stationarity(d, lam), stationarity(d, jr['lam'])
    loose, loose_j = ok & (stat >= 5e-4), okj & (stat_j >= 5e-4)
    print(path, "beyond the gate:", np.flatnonzero(beyond), "JAX:",
          np.flatnonzero(beyond_j), "stationarity >= 5e-4:",
          np.flatnonzero(loose), stat[loose], "JAX:", np.flatnonzero(loose_j),
          stat_j[loose_j])
    if path == "per_pass":
        assert not beyond.any() and not loose.any()
    else:
        # the JAX tier's fused path leaves lanes flagged 1 beyond both
        # gates (its certificate's weakness; ROADMAP Queue C): held to its
        # count, plus one for the gap gate as the reference benchmark's
        assert beyond.sum() <= beyond_j.sum() + 1
        assert loose.sum() <= loose_j.sum()

    def cls(fl):
        return np.where(fl == 1, 0, np.where(fl == dt.EXIT_UNBOUNDED, 2, 1))

    assert (cls(flags) == cls(fj)).mean() >= 0.95, (flags, fj)


@pytest.mark.parametrize("fused", [False, True], ids=["per_pass", "fused"])
def test_batch_lp_unbounded_lane(fused):
    # test_batch_lp.py:68-91's batch, the port alone: lane 3 minimizes -x0
    # with only x1 bounded
    d = _lp_batch(8, 6, 20, 9)
    d['f'][3] = 0.0
    d['f'][3, 0] = -1.0
    d['A'][3] = 0.0
    d['A'][3, :, 1] = 1.0
    d['bupper'][3], d['blower'][3] = 1.0, -1.0
    r = dt.solve_batch_lp_kernel(*_f32(d), None,
                                 dt.as_settings({"iter_limit": 2000},
                                                torch.float32),
                                 fused=fused, device="cpu")
    flags = r.exitflag.numpy()
    assert flags[3] == dt.EXIT_UNBOUNDED, flags
    err = np.abs(r.x.numpy() - d['x']).max(1)
    others = np.arange(8) != 3
    assert (((flags == 1) & (err < 1e-4)) | (flags < 0))[others].all(), \
        (flags, err)
    assert (flags[others] == 1).sum() >= 6, flags


def _equality_lanes(d, lanes=8):
    """The first ``lanes`` lanes with one row active at the constructed
    vertex made an equality (bl = bu = a'x_ref)."""
    e = {k: v[:lanes].copy() for k, v in d.items()}
    Ax = np.einsum('bmn,bn->bm', e['A'], e['x'])
    tight = np.minimum(np.abs(Ax - e['bupper']), np.abs(Ax - e['blower']))
    row = np.argmin(tight, axis=1)
    idx = np.arange(lanes)
    e['bupper'][idx, row] = e['blower'][idx, row] = Ax[idx, row]
    return e, row


@pytest.mark.parametrize("path", ["per_pass", "fused"])
def test_batch_lp_equality_row(path, lp128):
    # the warm activation of batch.py:1063-1072: an equality row enters
    # the cold state's working set; the JAX tier runs the lanes tiled to
    # the 128 lanes its program was compiled for
    e, row = _equality_lanes(lp128)
    tiled = {k: np.tile(v, (B // 8,) + (1,) * (v.ndim - 1))
             for k, v in e.items()}
    jr = _jax_tier(tiled, np.zeros((B, M), np.int32), PATHS[path][0])
    p = pbatch.lp_init(*_f32(e), None, _st()[1], device="cpu")
    assert (p.s0.used.sum(1) == 1).all()
    r = dt.solve_batch_lp_kernel(*_f32(e), None, _st()[1],
                                 fused=PATHS[path][1], device="cpu")
    flags, x = r.exitflag.numpy(), r.x.numpy().astype(np.float64)
    ok = flags == 1
    assert ok.sum() >= 7, flags
    resid = np.abs(np.einsum('bn,bn->b', e['A'][np.arange(8), row], x)
                   - e['bupper'][np.arange(8), row])
    assert (resid[ok] < 1e-5).all(), resid
    # against the JAX tier's lanes flagged 1 and within bench_lp's gate
    # (its fused path can flag 1 a lane beyond it)
    gap_j, feas_j = gate(e, jr['x'][:8])
    both = ok & (jr['exitflag'][:8] == 1) & (gap_j < 1e-4) & (feas_j < 1e-4)
    dx = np.abs(x - jr['x'][:8]).max(1) / (1.0 + np.abs(x).max(1))
    print(path, "JAX flags", jr['exitflag'][:8], "port", flags, "dx", dx)
    assert both.sum() >= 6 and (dx[both] < 1e-4).all(), dx


def jax_config_lp_census():
    """The JAX tier on configLP (B = 256, n = 10, m = 50, seed 17,
    iter_limit 3000; bench_extra.py:253-279), per-pass and fused
    ("force"), in interpret mode on the CPU: flags, the accuracy gate's
    pass rate, the lanes flagged 1 that fail it (gap, feasibility,
    ||x - x_ref||_inf), the loud lanes and the median iterations."""
    import time
    d = _lp_batch(256, 10, 50, 17)
    out = {}
    for path, (fused, _) in PATHS.items():
        t0 = time.perf_counter()
        r = _jax_tier(d, np.zeros((256, 50), np.int32), fused)
        fl = r['exitflag']
        gap, feas = gate(d, r['x'])
        ok = (fl == 1) & (gap < 1e-4) & (feas < 1e-4)
        bad = np.flatnonzero((fl == 1) & ~ok)
        err = np.abs(r['x'] - d['x']).max(1)
        out[path] = dict(
            flags={int(k): int(v) for k, v in zip(*np.unique(
                fl, return_counts=True))},
            optimal_rate=float(np.mean(fl == 1)),
            accuracy_pass_rate=float(np.mean(ok)),
            beyond_gate={int(b): (float(gap[b]), float(feas[b]),
                                  float(err[b])) for b in bad},
            loud_lanes=np.flatnonzero(fl != 1).tolist(),
            median_iterations=float(np.median(r['iterations'])),
            seconds=time.perf_counter() - t0)
    return out


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
    for path, v in jax_config_lp_census().items():
        print(path, v)
