"""SOFT_WEIGHTS on the port's dense-mask tier (B7's SOFT_WEIGHTS variant,
its plain twin on the CPU): one round against the JAX kernel it replaces
(``ops/pallas_batch.py run_kernel_round`` on a ``dense_init(sw_b=...)``
state, Pallas interpret mode) from one state, whole solves against the
lifted slack QP in f64 (``tests/test_soft_weights.py:41``), the
degenerate weights against the plain soft path, the stream against the
per-call path, the state conversion, and the soundness of
``chip_smoke.py``'s ``sw`` gates for the JAX package itself.  Data:
``tests/test_pallas_sw.py:22-49``."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import batch as jbatch
from daqp_tpu import transform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import pallas_batch as pb
from daqp_tpu.types import IMMUTABLE, SOFT, SoftWeights as JSW
import daqp_tpu_torch as dt
from daqp_tpu_torch import convert
from daqp_tpu_torch.ops import dense
from tests.test_pallas_sw import _make_batch
from tests.test_torch_dense import BP, _jax_np
from tests.test_soft_weights import _lift_and_solve

ROOT = Path(__file__).resolve().parents[1]
KEYS = ('H', 'f', 'A', 'bupper', 'blower')
SW_KEYS = ('d_ls', 'd_us', 'rho_ls', 'rho_us')
# (seed, d_scale, rho_lo): FREE and FIXED slacks mixed; mostly FIXED, so
# transitions and re-adds dominate (test_pallas_sw.py:59-114)
REGIMES = {"mixed": (57, 0.4, 0.5), "fixed": (91, 1.5, 2.0)}
SOFT_ROWS = [0, 3, 7, 11]


def _sw(raw):
    return dt.SoftWeights(*(torch.as_tensor(raw[k]) for k in SW_KEYS))


@functools.lru_cache(maxsize=None)
def _cold(regime, steps=192):
    """The JAX SOFT_WEIGHTS dense state of a regime (B = 128, n = 6,
    m = 14), normalized as batch.py:551-570 does, and the JAX round from
    it."""
    seed, d_scale, rho_lo = REGIMES[regime]
    Hs, fs, As, bus, bls, sense, sw, _ = _make_batch(
        128, 6, 14, SOFT_ROWS, seed, d_scale, rho_lo)
    st = _as_settings({"iter_limit": 500}, jnp.float32)
    ldpd = jax.vmap(functools.partial(transform.build_ldp, ms=0, st=st))(
        *map(jnp.asarray, (Hs, fs, As, bus, bls, sense)))
    soft_m = (ldpd.sense & SOFT) > 0
    sc = ldpd.scaling
    sw_n = JSW(*(jnp.where(soft_m, x * sc ** p, 0.0)
                 for x, p in zip(sw, (-1, -1, 2, 2))))
    s = pb.dense_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                      ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32),
                      soft_m.astype(jnp.float32), sw_b=sw_n)
    return s, pb.run_kernel_round(s, st, 6, steps=steps, interpret=True), st


def _port(sj):
    return dense.map_state(lambda x: x[:BP].contiguous(),
                           convert.dense_state_from_jax(sj, 14, 6))


def _exact_gap(sj, s):
    """Per lane, ||u - u_exact||_inf of the lanes-last state ``s``: u_exact
    = -M_W' lam*, lam* = -(M_W M_W' + D)^-1 d_W in f64 on the working set
    W of ``s``, with the per-side weight on FREE soft slacks in D and
    their bound shift in d_W (the CSP of pallas_batch.py:313-326)."""
    M = sj['M'].astype(np.float64)
    out = []
    for b in range(s['u'].shape[-1]):
        up, lo = s['act_up'][:, b] > 0, s['act_lo'][:, b] > 0
        W = np.nonzero(up | lo)[0]
        free = sj['soft'][W, b] * (1.0 - s['sfix'][W, b])
        rho = np.where(lo[W], sj['sw_rls'][W, b], sj['sw_rus'][W, b])
        d = np.where(up, sj['dupper'][:, b], sj['dlower'][:, b])[W] \
            + free * np.where(lo[W], sj['sw_rls'][W, b] * sj['sw_dls'][W, b],
                              -sj['sw_rus'][W, b] * sj['sw_dus'][W, b])
        Mw = M[W, :, b]
        u = Mw.T @ np.linalg.solve(Mw @ Mw.T + np.diag(free * rho), d) \
            if len(W) else np.zeros(M.shape[1])
        out.append(np.abs(s['u'][:, b] - u).max())
    return np.asarray(out)


def _np(sj):
    return _jax_np(sj, 14, 6)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_round_matches_jax_kernel(regime):
    s0, s1, st = _cold(regime)
    sj = _np(s1)
    sp = convert.dense_state_to_numpy(dense.run_kernel_round(
        _port(s0), convert.settings_from_jax(st), 6, steps=192))
    np.testing.assert_array_equal(sp['status'], sj['status'])
    agree = (sp['act_up'] == sj['act_up']).all(0) \
        & (sp['act_lo'] == sj['act_lo']).all(0) \
        & (sp['sfix'] == sj['sfix']).all(0)
    assert agree.sum() >= BP - 1, agree.sum()
    # u by its scale, as test_torch_dense.py's round test: 1e-4 (1 +
    # ||u||), or past that within twice JAX's distance to the exact u on
    # the working set plus K2's pre-polish drift 1e-3 (1 + ||u||): a lane
    # whose slacks switch FIXED/FREE several times ends up to ~2e-4
    # (1 + ||u||) from JAX's u after ~20 rank-one updates in another sum
    # order
    scale = 1.0 + np.abs(sj['u'][:, agree]).max(0)
    gap = np.abs(sp['u'] - sj['u'])[:, agree].max(0)
    s0n = _np(s0)
    ex_p = _exact_gap(s0n, sp)[agree]
    ex_j = _exact_gap(s0n, sj)[agree]
    ok = (gap <= 1e-4 * scale) | (ex_p <= 2.0 * ex_j + 1e-3 * scale)
    assert ok.all(), (gap / scale, ex_p, ex_j)


def test_state_conversion_round_trip():
    s0, _, st = _cold("fixed")
    s5 = pb.run_kernel_round(s0, st, 6, steps=5, interpret=True)
    sp = _port(s5)
    assert sp.sfix.shape == (BP, 14) and sp.pfix.shape == (BP,)
    assert sp.sw_rls.shape == (BP, 14)
    back = convert.dense_state_to_numpy(sp)
    ref = _np(s5)
    assert set(back) == set(ref)
    for name, a in back.items():
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    # a plain soft state keeps its SOFT_WEIGHTS fields None
    plain = convert.dense_state_from_jax(s0._replace(
        sw_dls=None, sw_dus=None, sw_rls=None, sw_rus=None, sfix=None,
        pfix=None), 14, 6)
    assert plain.sw_dls is None and plain.sfix is None and plain.pfix is None


def _lifted(d, raw, soft_rows, b):
    return _lift_and_solve(*(np.float64(d[k][b]) for k in KEYS), soft_rows,
                           *(np.float64(raw[k][b]) for k in SW_KEYS))


@pytest.mark.parametrize("case", ["mixed", "fixed", "equality"])
def test_solve_matches_lifted_qp(case):
    if case == "equality":
        # test_pallas_sw.py:179-205: an equality row (bulk activation)
        # beside the SOFT_WEIGHTS rows
        B, soft_rows = 24, [2, 6, 9]
        Hs, fs, As, bus, bls, sense, _, raw = _make_batch(
            B, 5, 12, soft_rows, seed=11)
        bls[:, 0] = bus[:, 0]
        sense = sense.copy()
        sense[:, 0] = 1 | 4
        lanes = range(0, B, 7)
    elif case == "mixed":
        # test_pallas_sw.py:59-80: one full tile, a sample of its lanes
        B, soft_rows = 128, SOFT_ROWS
        Hs, fs, As, bus, bls, sense, _, raw = _make_batch(
            B, 6, 14, soft_rows, *REGIMES[case])
        lanes = range(0, B, 9)
    else:
        # test_pallas_sw.py:94-114: mostly FIXED slacks, every lane
        B, soft_rows = 24, [0, 2, 5, 8, 10]
        Hs, fs, As, bus, bls, sense, _, raw = _make_batch(
            B, 5, 12, soft_rows, *REGIMES[case])
        lanes = range(B)
    d = dict(zip(KEYS, (Hs, fs, As, bus, bls)))
    r = dt.solve_batch_kernel(Hs, fs, As, bus, bls, sense,
                              dt.as_settings({"iter_limit": 500},
                                             torch.float32),
                              sw=_sw(raw), device="cpu")
    flags, x = r.exitflag.numpy(), r.x.numpy()
    assert (flags > 0).all(), np.unique(flags, return_counts=True)
    err = [np.abs(x[b] - _lifted(d, raw, soft_rows, b)).max()
           for b in lanes]
    assert max(err) < 5e-4, max(err)
    if case == "equality":
        assert np.abs(np.einsum('bn,bn->b', As[:, 0], x)
                      - bus[:, 0]).max() < 5e-4


def test_degenerate_weights_match_plain_soft():
    # test_pallas_sw.py:117-156: d = 0 and rho = rho_soft per side is the
    # plain soft path (every slack FREE at its first add); rows unit-norm
    # in u-space, where SOFT_WEIGHTS' scaling^2 matches rho_soft
    B, n, m = BP, 6, 14
    Hs, fs, As, bus, bls, sense, _, _ = _make_batch(B, n, m, SOFT_ROWS,
                                                    seed=3)
    for b in range(B):
        R = np.linalg.cholesky(np.float64(Hs[b])).T
        nrm = np.linalg.norm(np.float64(As[b]) @ np.linalg.inv(R), axis=1)
        As[b], bus[b], bls[b] = As[b] / nrm[:, None], bus[b] / nrm, \
            bls[b] / nrm
    st = dt.as_settings({"iter_limit": 500, "rho_soft": 1.0}, torch.float32)
    z = torch.zeros(B, m)
    r_sw = dt.solve_batch_kernel(Hs, fs, As, bus, bls, sense, st,
                                 sw=dt.SoftWeights(z, z, z + 1.0, z + 1.0),
                                 device="cpu")
    r_pl = dt.solve_batch_kernel(Hs, fs, As, bus, bls, sense, st,
                                 has_soft=True, device="cpu")
    assert (r_sw.exitflag.numpy() > 0).all()
    assert (r_pl.exitflag.numpy() > 0).all()
    assert (r_sw.x - r_pl.x).abs().max() < 1e-5
    assert (r_sw.soft_slack - r_pl.soft_slack).abs().max() < 1e-5


def test_f64_inputs_run_the_dense_tier_in_f64():
    # f64 data keeps the dense tier in f64 on the CPU (chip_smoke.py's sw
    # witness): the mostly-FIXED regime then meets the lifted QP to 1e-8
    B, soft_rows = 24, [0, 2, 5, 8, 10]
    Hs, fs, As, bus, bls, sense, _, raw = _make_batch(
        B, 5, 12, soft_rows, *REGIMES["fixed"])
    d = dict(zip(KEYS, (Hs, fs, As, bus, bls)))
    r = dt.solve_batch_kernel(
        *(torch.as_tensor(np.float64(x)) for x in (Hs, fs, As, bus, bls)),
        sense, dt.as_settings({"iter_limit": 500}, torch.float64),
        sw=dt.SoftWeights(*(torch.as_tensor(np.float64(raw[k]))
                            for k in SW_KEYS)), device="cpu")
    assert r.x.dtype == torch.float64
    assert (r.exitflag > 0).all(), r.exitflag
    err = [np.abs(r.x[b].numpy() - _lifted(d, raw, soft_rows, b)).max()
           for b in range(B)]
    assert max(err) < 1e-8, max(err)


def test_stream_matches_per_call():
    # test_pallas_sw.py:159-176: the stream (chunks of 16, difficulty
    # sort) gives each lane the per-call result
    Hs, fs, As, bus, bls, sense, _, raw = _make_batch(
        24, 5, 12, [0, 2, 5, 8, 10], seed=91, d_scale=1.5, rho_lo=2.0)
    st = dt.as_settings({"iter_limit": 500}, torch.float32)
    args = [torch.as_tensor(a) for a in (Hs, fs, As, bus, bls, sense)]
    one = dt.solve_batch_kernel(*args, st, sw=_sw(raw))
    stream = dt.solve_batch_kernel_stream(*args, st, chunk=16, sw=_sw(raw),
                                          sort_stream=True)
    np.testing.assert_array_equal(stream.exitflag.numpy(),
                                  one.exitflag.numpy())
    assert (one.exitflag.numpy() > 0).all()
    for name in ('x', 'lam', 'fval', 'soft_slack'):
        np.testing.assert_allclose(getattr(stream, name).numpy(),
                                   getattr(one, name).numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_sw",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def config2_sw_sample(cs, lanes):
    """``lanes`` of chip_smoke.py's sw data: config 2 with rows 0-19 SOFT
    and its SOFT_WEIGHTS data; (data, sense, raw weights, full data)."""
    from tests.gen import generate_test_qp_batch
    d = generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT, cs.KAPPA,
                               rng=cs.SEED, dtype=np.float32)
    sw_np = cs.sw_weights(cs.B, cs.M_ROWS)
    sense = d['sense'][lanes].copy()
    sense[:, :cs.SOFT_ROWS] |= SOFT
    return [d[k][lanes] for k in KEYS], sense, sw_np, d


def jax_config2_sw(cs, lanes):
    """The JAX package on ``lanes`` of the sw data (interpret mode, iter
    limit 1000) against the lifted slack QP in f64: (flags, errors)."""
    data, sense, sw_np, d = config2_sw_sample(cs, lanes)
    rj = jbatch.solve_batch_pallas_jit(
        *map(jnp.asarray, data), jnp.asarray(sense),
        _as_settings({"iter_limit": 1000}, jnp.float32), ms=0,
        interpret=True, sw=JSW(*(jnp.asarray(sw_np[k][lanes])
                                 for k in SW_KEYS)))
    oracle = cs.oracle_module("daqp_numpy")
    err = np.array([np.abs(np.asarray(rj.x)[i]
                           - cs.lifted_reference(oracle, d, sw_np, b)[0]).max()
                    for i, b in enumerate(lanes)])
    return np.asarray(rj.exitflag), err


def test_config2_sw_gates_hold_for_jax():
    # chip_smoke.py's sw phase holds the port to ||x - x_ref||_inf <=
    # SW_TOL on the lanes flagged optimal, and to at most twice the JAX
    # package's share of loud lanes on its 256-lane sample.  On another
    # 128-lane sample of the same data (every 80th lane, alternating
    # parity: both slack regimes) the JAX package meets the accuracy gate
    # and its loud share is at most the one the limit is built from
    cs = _chip_smoke()
    lanes = np.arange(0, cs.B, 80) + np.arange(128) % 2
    flags, err = jax_config2_sw(cs, lanes)
    assert err[flags > 0].max() <= cs.SW_TOL, err[flags > 0].max()
    assert (flags <= 0).mean() <= cs.JAX_SW_LOUD / 256, np.unique(flags)


def port_config2_sw(cs, lanes):
    """The port's twins on ``lanes`` of the sw data, f32 as on the card:
    (flags, errors against the lifted slack QP)."""
    data, sense, sw_np, d = config2_sw_sample(cs, lanes)
    r = dt.solve_batch_kernel_stream(
        *map(torch.as_tensor, data), torch.as_tensor(sense),
        dt.as_settings({"iter_limit": 1000}, torch.float32), chunk=256,
        has_soft=True, sort_stream=True, device="cpu",
        sw=dt.SoftWeights(*(torch.as_tensor(sw_np[k][lanes])
                            for k in SW_KEYS)))
    oracle = cs.oracle_module("daqp_numpy")
    err = np.array([np.abs(r.x[i].numpy()
                           - cs.lifted_reference(oracle, d, sw_np, b)[0]).max()
                    for i, b in enumerate(lanes)])
    return r.exitflag.numpy(), err


def round_cycles(cs, B=128):
    """One cold 192-step SOFT_WEIGHTS round on the first B lanes of
    chip_smoke.py's k7 SOFT_WEIGHTS case, from one state: the lanes that
    exit CYCLE for the JAX kernel (interpret mode), the port's twin in f32
    and the same twin in f64."""
    data, sense, sw_np, _ = config2_sw_sample(cs, np.arange(B))
    from daqp_tpu.ops import chol as jchol
    st = _as_settings({"iter_limit": 1000}, jnp.float32)
    args = [jnp.asarray(x) for x in data] + [jnp.asarray(sense)]
    Rinv = jchol.batched_rinv_regularized(args[0], st, interpret=True)[0]
    ldpd = jax.vmap(lambda H_, f_, A_, bu_, bl_, se_, R_: transform.build_ldp(
        H_, f_, A_, bu_, bl_, se_, 0, st, Rinv=R_))(*args, Rinv)
    soft_m = (ldpd.sense & SOFT) > 0
    sc = ldpd.scaling
    sw_n = JSW(*(jnp.where(soft_m, jnp.asarray(sw_np[k][:B]) * sc ** p, 0.0)
                 for k, p in zip(SW_KEYS, (-1, -1, 2, 2))))
    s0 = pb.dense_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                       ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32),
                       soft_m.astype(jnp.float32), sw_b=sw_n)
    m, n = cs.M_ROWS, cs.N
    sj = pb.run_kernel_round(s0, st, n, steps=192, interpret=True)
    sp0 = dense.map_state(lambda x: x[:B].contiguous(),
                          convert.dense_state_from_jax(s0, m, n))
    stp = convert.settings_from_jax(st)
    s32 = dense.run_kernel_round(sp0, stp, n, steps=192)
    s64 = dense.run_kernel_round(dense.map_state(
        lambda x: x.double() if x.is_floating_point() else x, sp0), stp, n,
        steps=192)
    cyc = {"jax": set(np.flatnonzero(
        np.asarray(sj.status).reshape(-1)[:B] == -2).tolist())}
    for name, s in (("twin_f32", s32), ("twin_f64", s64)):
        cyc[name] = set(torch.nonzero(s.status == -2)[:, 0].tolist())
    return cyc


if __name__ == "__main__":
    # the numbers behind chip_smoke.py's JAX_SW_LOUD_LANES: the loud lanes
    # of the JAX package and of the port's twins (f32, and f64 on the
    # union) on the sw phase's own 256-lane oracle sample, and the CYCLE
    # lanes of one SOFT_WEIGHTS round on 128 lanes of its k7 case
    cs_ = _chip_smoke()
    lanes_ = np.arange(0, cs_.B, cs_.SW_STRIDE) + np.arange(256) % 2
    f_, e_ = jax_config2_sw(cs_, lanes_)
    fp, ep = port_config2_sw(cs_, lanes_)
    loud = sorted(set(lanes_[f_ <= 0]) | set(lanes_[fp <= 0]))
    _, _, sw_np_, d_ = config2_sw_sample(cs_, lanes_)
    f64_flags, f64_err = cs_.sw_f64(cs_.oracle_module("daqp_numpy"), d_,
                                    sw_np_, np.asarray(loud, int))
    print({"lanes": len(lanes_), "loud": int((f_ <= 0).sum()),
           "flags": {int(k): int(v) for k, v in zip(*np.unique(
               f_, return_counts=True))},
           "max_err_positive": float(e_[f_ > 0].max()),
           "jax_loud": {int(b): int(f) for b, f in zip(lanes_, f_) if f <= 0},
           "twin_f32_loud": {int(b): int(f) for b, f in zip(lanes_, fp)
                             if f <= 0},
           "twin_f32_max_err_positive": float(ep[fp > 0].max()),
           "f64_on_loud": {int(b): (int(f), float(e)) for b, f, e in zip(
               loud, f64_flags, f64_err)}})
    cyc_ = round_cycles(cs_)
    print({"round_cycle": {k: len(v) for k, v in cyc_.items()},
           "jax_and_twin_f32": len(cyc_["jax"] & cyc_["twin_f32"]),
           "jax_and_twin_f64": len(cyc_["jax"] & cyc_["twin_f64"]),
           "twin_f32_and_f64": len(cyc_["twin_f32"] & cyc_["twin_f64"])})
