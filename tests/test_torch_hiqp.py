"""The port's batched hierarchical walk (``solve_batch_hiqp_kernel``, on
B7's twin) against the JAX tier it replaces (``batch.py:1999
solve_batch_hiqp_pallas_jit``, interpret mode) and against the f64
hierarchical oracle (``oracle/hiqp_numpy.py``), and the JAX tier's own
counts on config 4b that ``chip_smoke.py``'s ``hiqp`` gates build on."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from daqp_tpu import batch as batch_mod
from daqp_tpu.api import _as_settings
import daqp_tpu_torch as dt
from tests.test_batch_hiqp import _rand_hier

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _jax(H, f, A, bu, bl, sense, st, bp):
    r = batch_mod.solve_batch_hiqp_pallas_jit(
        H, jnp.asarray(f, jnp.float32), jnp.asarray(A, jnp.float32),
        jnp.asarray(bu, jnp.float32), jnp.asarray(bl, jnp.float32),
        jnp.asarray(sense), st, ms=0, break_points=bp, interpret=True)
    return np.asarray(r.exitflag), np.asarray(r.x), np.asarray(r.lam)


def _port(f, A, bu, bl, sense, over, bp):
    st = dt.as_settings(over, torch.float32)
    return dt.solve_batch_hiqp_kernel(
        None, np.asarray(f, np.float32), np.asarray(A, np.float32),
        np.asarray(bu, np.float32), np.asarray(bl, np.float32), sense, st,
        break_points=bp, device="cpu")


def test_hiqp_matches_jax():
    # test_batch_hiqp.py:27-41
    rng = np.random.default_rng(77)
    B, n = 16, 8
    bp = (0, 6, 12, 18)
    m = bp[-1]
    A = np.empty((B, m, n))
    bu = np.empty((B, m))
    bl = np.empty((B, m))
    for b in range(B):
        A[b], bu[b], bl[b] = _rand_hier(rng, n, bp)
    f = np.zeros((B, n))
    sense = np.zeros((B, m), np.int32)
    fj, xj, lj = _jax(None, f, A, bu, bl, sense,
                      _as_settings({"iter_limit": 2000}, jnp.float32), bp)
    r = _port(f, A, bu, bl, sense, {"iter_limit": 2000}, bp)
    fp, xp, lp = r.exitflag.numpy(), r.x.numpy(), r.lam.numpy()
    agree = fp == fj
    assert agree.sum() >= B - 1, (fp, fj)
    assert np.abs(xp - xj)[agree].max() <= 5e-4
    # duals on lanes that finished the walk: an exit-3 lane's duals are
    # those of its failed level's solve, which the f64 walk does not
    # record at all (hiqp_numpy.py:87-90)
    opt = agree & (fp == 1)
    assert np.abs(lp - lj)[opt].max() <= 5e-4
    assert r.x.shape == (B, n) and r.lam.shape == (B, m)
    assert (r.iterations.numpy() >= 1).all()


def test_hiqp_infeasible_level_vs_oracle():
    # test_batch_hiqp.py:68-91: level 1 holds one row twice with disjoint
    # bands, so its slacks are nonzero; lower levels still solve
    rng = np.random.default_rng(5)
    B, n = 8, 6
    bp = (0, 4, 8)
    m = bp[-1]
    A = rng.standard_normal((B, m, n))
    x0 = rng.standard_normal((B, n))
    b0 = np.einsum('bmn,bn->bm', A, x0)
    bu, bl = b0 + 0.5, b0 - 0.5
    A[:, 1] = A[:, 0]
    bu[:, 0], bl[:, 0] = b0[:, 0] - 1.0, b0[:, 0] - 2.0
    bl[:, 1], bu[:, 1] = b0[:, 1] + 1.0, b0[:, 1] + 2.0
    sense = np.zeros((B, m), np.int32)
    r = _port(np.zeros((B, n)), A, bu, bl, sense, {"iter_limit": 2000}, bp)
    flags, x, lam = r.exitflag.numpy(), r.x.numpy(), r.lam.numpy()
    assert (flags > 0).all(), flags
    assert (np.abs(lam[:, :2]).max(axis=1) > 1e-6).all()
    hq = CS.oracle_module("hiqp_numpy")
    st = dt.as_settings({"iter_limit": 2000}, torch.float32)
    for b in range(B):
        ref = hq.hiqp(None, np.zeros(n), A[b], bu[b], bl[b], sense[b], 0, bp,
                      {"rho_soft": CS.HIQP_RHO,
                       "primal_tol": float(st.primal_tol)})
        assert ref['exitflag'] > 0
        assert np.abs(x[b] - ref['x']).max() < 5e-4, b
        # the pair's slack duals (the oracle offsets each by 1e-14)
        assert np.abs(lam[b, :2] - ref['lam'][:2]).max() < 5e-4, b


def test_config4b_jax_reference_counts():
    # The JAX tier on config 4b (bench_extra.py:144-168) against the f64
    # oracle: chip_smoke.py's hiqp gates allow the port the JAX tier's own
    # mismatches plus HIQP_SLACK and twice its class differences.  This
    # measures them; the port's twin must meet the same gates here.
    d = CS.config4b()
    st = _as_settings({"iter_limit": 1000}, jnp.float32)
    fj, xj, _ = _jax(None, d['f'], d['A'], d['bupper'], d['blower'],
                     d['sense'], st, CS.BP4B)
    stp = dt.as_settings({"iter_limit": 1000}, torch.float32)
    ref_flags, ref_x = CS.hiqp_reference(d, stp)
    diffs, mism, legal, _ = CS.hiqp_counts(fj, xj, ref_flags, ref_x)
    assert legal
    assert (diffs, mism) == (CS.JAX_HIQP_CLASS_DIFFS,
                             CS.JAX_HIQP_MISMATCHES)
    r = dt.solve_batch_hiqp_kernel(None, *(d[k] for k in (
        'f', 'A', 'bupper', 'blower', 'sense')), stp,
        break_points=CS.BP4B, device="cpu")
    diffs, mism, legal, _ = CS.hiqp_counts(
        r.exitflag.numpy(), r.x.numpy(), ref_flags, ref_x)
    assert legal
    assert diffs <= CS.HIQP_CLASS_LIMIT, diffs
    assert mism <= CS.JAX_HIQP_MISMATCHES + CS.HIQP_SLACK, mism
