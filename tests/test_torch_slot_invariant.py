"""The slot step's precondition: E is exactly zero off used x used and W
is zero on every unused row.

The CUDA slot step (``ops/csrc/slot_step.cuh``, run by K2 and B3-B6)
walks a list of the used slots: it leaves every other entry of E as it
came in, and writes the added row into a free slot's row of W as if that
row were zero.  So each producer of a slot state must keep both zeros.
This holds every host-side producer (``slot_init``, ``slot_activate``
with an over-capacity warm start, ``exact_repair``, ``newton_refresh``,
``polish``, ``solve_retry`` and its cold retry, ``slot_add_row``,
``lp_grad_step``, ``slot_refresh_bounds``, ``reset_control``,
``select_lanes``, ``convert.slot_state_from_jax``) and the twins of K2
and B3-B6 to it, exactly, on seeded ``tests/gen.py`` data with removals
in the walk and on a slot-permuted state (f32 CPU tensors, as the
kernels take the state).
``chip_smoke.py``'s ``k2`` holds the kernel's own round to it on the
card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daqp_tpu_torch as dt
from daqp_tpu import transform as jtransform
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import pallas_slot as ps
from daqp_tpu.types import IMMUTABLE
from daqp_tpu_torch import convert, transform
from daqp_tpu_torch.ops import slot
from tests.gen import (generate_test_avi_two_sided, generate_test_lp,
                       generate_test_qp, generate_test_qp_batch)

B, N, M = 32, 8, 20
KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
F32 = torch.float32
# every host-side function that returns a slot state, and the twins
PRODUCERS = ("slot_init", "slot_activate", "exact_repair", "newton_refresh",
             "polish", "solve_retry", "slot_add_row", "lp_grad_step",
             "slot_refresh_bounds", "reset_control", "select_lanes",
             "run_slot_round_plain", "run_mpc_segment_plain",
             "run_prox_segment_plain", "run_avi_segment_plain",
             "run_lp_segment_plain")


def _bad_lanes(s):
    off = (s.used[:, :, None] * s.used[:, None, :]) == 0
    e_bad = ((s.E != 0) & off).flatten(1).any(1)
    w_bad = ((s.W != 0) & (s.used == 0)[:, :, None]).flatten(1).any(1)
    return torch.nonzero(e_bad | w_bad).flatten().tolist()


def _assert_block(s, what):
    bad = _bad_lanes(s)
    assert not bad, f"{what}: E nonzero off used x used or W nonzero on " \
        f"an unused row, lanes {bad}"


def _st():
    return dt.as_settings({"iter_limit": 1000}, F32)


def _cold(Bn=B, n=N, m=M, seed=3):
    d = generate_test_qp_batch(Bn, n, m, 0, n // 2, 1e2, rng=seed,
                               dtype=np.float32)
    args = [torch.as_tensor(d[k]) for k in KEYS]
    st = _st()
    Rinv = torch.linalg.inv(torch.linalg.cholesky(args[0])).transpose(1, 2)
    ldpd = transform.build_ldp(*args[1:], 0, st, Rinv=Rinv)
    immut = ((ldpd.sense & dt.IMMUTABLE) > 0).to(F32)
    return slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                          immut, n_true=n), st


def _permuted(s, seed):
    """Each lane's slots relabelled by a seeded permutation (W's rows, E's
    rows and columns and every per-slot vector together), as chip_smoke's
    k2 case w: free slots then lie between used ones."""
    Bn, K = s.used.shape
    perm = torch.as_tensor(np.argsort(np.random.default_rng(seed).random(
        (Bn, K)), axis=1))
    E = s.E.gather(1, perm[:, :, None].expand(-1, -1, K)).gather(
        2, perm[:, None, :].expand(-1, K, -1))
    W = s.W.gather(1, perm[:, :, None].expand(-1, -1, s.W.shape[2]))
    vec = {k: getattr(s, k).gather(1, perm)
           for k in ("sid", "slo", "dsl", "used", "simm", "lam",
                     "lam_star")}
    return s._replace(E=E, W=W, **vec)


def test_producers_keep_the_used_block():
    s, st = _cold()
    _assert_block(s, "slot_init")
    K = s.E.shape[1]

    # a warm start of random rows on random sides: most are wrong, so the
    # round removes slots; every fourth lane gets more rows than slots
    # (over capacity: the extra rows leave the table, the lane is parked)
    g = np.random.default_rng(5)
    up = np.zeros((B, M), bool)
    lo = np.zeros((B, M), bool)
    for b in range(B):
        rows = g.choice(M, K + 2 if b % 4 == 0 else 4, replace=False)
        side = g.random(rows.size) < 0.5
        up[b, rows[~side]] = True
        lo[b, rows[side]] = True
    s = slot.slot_activate(s, torch.as_tensor(up), torch.as_tensor(lo), st)
    _assert_block(s, "slot_activate")
    assert bool((s.status == dt.EXIT_REFACTOR)[::4].all())
    s = slot.exact_repair(s, st)
    _assert_block(s, "exact_repair")
    warm = s.sid.clone()

    s = slot.run_slot_round_plain(s, st, N, steps=12)
    _assert_block(s, "run_slot_round_plain, 12 steps")
    # the walk removed slots: warm-start rows no longer in the table
    left = [(set(warm[b][warm[b] >= 0].tolist())
             - set(s.sid[b][s.sid[b] >= 0].tolist())) for b in range(B)]
    assert sum(bool(x) for x in left) >= B // 4
    s = slot.newton_refresh(s)
    _assert_block(s, "newton_refresh")
    s = slot.slot_solve(s, st, N)
    _assert_block(s, "slot_solve (rounds, repair, polish)")
    s = slot.polish(s, st)
    _assert_block(s, "polish")
    # the over-capacity lanes keep every slot used (parked, then loud)
    used = s.used.sum(1)
    assert bool((used > 0).all()) and bool((used[1::4] < K).all())
    assert bool((used[::4] == K).all())

    # a slot-permuted state and a round of the twin from it
    sp = _permuted(s._replace(status=torch.full_like(
        s.status, dt.EXIT_RUNNING)), seed=11)
    _assert_block(sp, "the permuted state")
    last = torch.where(sp.used > 0, torch.arange(K), -1).amax(1)
    assert int((last + 1 > sp.used.sum(1)).sum()) > 0      # holes
    sp = slot.run_slot_round_plain(slot.slot_refresh_bounds(
        sp, sp.dupper + 0.05, sp.dlower - 0.05), st, N, steps=20)
    _assert_block(sp, "run_slot_round_plain from scattered slots")

    # a bordered add of the lowest row some lanes leave inactive, and the
    # LP tier's gradient step along a random ray
    free = (s.act_up + s.act_lo) == 0
    i = int(torch.nonzero(free.any(0))[0])
    mask = free[:, i].to(F32)
    s2 = slot.slot_add_row(s, torch.full((B,), i), torch.zeros(B),
                           s.dupper[:, i], mask, st, N)
    assert bool((s2.used.sum(1) > s.used.sum(1)).any())
    _assert_block(s2, "slot_add_row")
    x0 = torch.as_tensor(g.standard_normal((B, N)), dtype=F32)
    bu = s.dupper / s.scaling
    bl = s.dlower / s.scaling
    s3, _, found = slot.lp_grad_step(s, x0 + 0.1, x0,
                                     torch.ones(B, dtype=bool), bu, bl, st, N)
    assert bool(found.any())
    _assert_block(s3, "lp_grad_step")

    s4 = slot.slot_refresh_bounds(s3, s.dupper - 0.1, s.dlower + 0.1)
    _assert_block(s4, "slot_refresh_bounds")
    s4 = slot.reset_control(s4)
    _assert_block(s4, "reset_control")
    s5 = slot.select_lanes(torch.arange(B) % 2 == 0, s4, s2)
    _assert_block(s5, "select_lanes")

    # the segment kernels' warm solve with its cold retry: lanes parked
    # CYCLE by a one-step round take the retry
    s6 = slot.solve_retry(s5, st, N, steps=1)
    _assert_block(s6, "solve_retry")
    s6 = slot.solve_retry(s6._replace(status=torch.full_like(
        s6.status, dt.EXIT_CYCLE)), st, N, steps=0,
        round_fn=lambda s_, *a: s_)
    _assert_block(s6, "solve_retry's cold retry")
    assert bool((s6.used == 0).all())


def test_state_from_jax_keeps_the_used_block():
    # a JAX state after a few steps of the TPU kernel (interpret mode),
    # padded shapes and all, carried over by convert
    Bn, n, m = 128, 6, 14             # the TPU kernel tiles 128 lanes
    d = generate_test_qp_batch(Bn, n, m, 0, 3, 1e2, rng=21,
                               dtype=np.float32)
    st = _as_settings({"iter_limit": 500}, jnp.float32)
    ldpd = jax.vmap(lambda *a: jtransform.build_ldp(*a, 0, st))(
        *[jnp.asarray(d[k]) for k in KEYS])
    immut = ((ldpd.sense & IMMUTABLE) > 0).astype(jnp.float32)
    s = ps.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                     n_true=n)
    s = ps.run_slot_round(s, st, n, steps=8, interpret=True)
    sp = convert.slot_state_from_jax(s)
    assert bool((sp.used.sum(1) > 0).any())
    _assert_block(sp, "convert.slot_state_from_jax")


@pytest.fixture
def spied(monkeypatch):
    """Every producer wrapped: each slot state it returns is held to the
    block; ``calls`` counts the calls by name."""
    calls = {}

    def check(out, name):
        for x in (out,) if isinstance(out, slot.SlotState) else (
                out if isinstance(out, tuple) else ()):
            if isinstance(x, slot.SlotState):
                _assert_block(x, name)

    for name in PRODUCERS:
        def wrap(*a, _fn=getattr(slot, name), _name=name, **k):
            out = _fn(*a, **k)
            check(out, _name)
            calls[_name] = calls.get(_name, 0) + 1
            return out
        monkeypatch.setattr(slot, name, wrap)
    return calls


def _t(x):
    x = torch.as_tensor(x)
    return x.to(F32) if x.is_floating_point() else x


def _mpc():
    rng = np.random.default_rng(55)
    _, H, f, A, bu, bl, _ = generate_test_qp(N, M, 0, 4, 1e2, rng)
    S, T = 8, 4
    df = 0.03 * rng.standard_normal((S, T, N))
    db = 0.03 * rng.standard_normal((S, T, M))
    args = (H, A, np.cumsum(df, 1) + f, np.cumsum(np.abs(db), 1) + bu,
            bl - np.cumsum(np.abs(db), 1))
    return lambda st: dt.solve_mpc_scan_kernel_fused(
        *(torch.as_tensor(a, dtype=F32) for a in args), st, seg=2,
        steps=64)


def _prox():
    rng = np.random.default_rng(13)
    Q = rng.standard_normal((12, N, N // 2))
    d = dict(H=np.einsum('bir,bjr->bij', Q, Q),
             f=rng.standard_normal((12, N)),
             A=rng.standard_normal((12, M, N)),
             bupper=4 + 4 * rng.random((12, M)),
             blower=-(4 + 4 * rng.random((12, M))),
             sense=np.zeros((12, M), np.int32))
    return lambda st: dt.solve_batch_prox_kernel(
        *[_t(d[k]) for k in KEYS], st)


def _avi():
    rng = np.random.default_rng(83)
    probs = [generate_test_avi_two_sided(6, 14, rng) for _ in range(12)]
    d = {k: np.stack([p[i] for p in probs])
         for i, k in enumerate(('x', 'H', 'f', 'A', 'bupper', 'blower'))}
    d['sense'] = np.zeros((12, 14), np.int32)
    return lambda st: dt.solve_batch_avi_kernel(
        *[_t(d[k]) for k in KEYS], st, fused=True)


def _lp():
    rng = np.random.default_rng(7)
    probs = [generate_test_lp(6, 16, 0, rng) for _ in range(16)]
    d = {k: np.stack([p[i] for p in probs])
         for i, k in enumerate(('x', 'f', 'A', 'bupper', 'blower'))}
    sense = torch.zeros((16, 16), dtype=torch.int32)
    return lambda st: dt.solve_batch_lp_kernel(
        *[_t(d[k]) for k in ('f', 'A', 'bupper', 'blower')],
        sense, st, fused=True)


def _qp():
    d = generate_test_qp_batch(16, N, M, 0, 4, 1e2, rng=9)
    return lambda st: dt.solve_batch_kernel(
        *[_t(d[k]) for k in KEYS], st)


# tier: (its solve on f64 CPU tensors, the producers it must reach)
TIERS = {
    "qp": (_qp, ("slot_init", "run_slot_round_plain", "polish")),
    "mpc": (_mpc, ("run_mpc_segment_plain", "slot_refresh_bounds",
                   "reset_control")),
    "prox": (_prox, ("run_prox_segment_plain",)),
    "avi": (_avi, ("run_avi_segment_plain",)),
    "lp": (_lp, ("run_lp_segment_plain", "run_slot_round_plain")),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_tiers_keep_the_used_block(tier, spied):
    # every slot state any producer returns during a whole solve of the
    # tier (the segment twins' states among them)
    make, needed = TIERS[tier]
    make()(_st())
    missing = [name for name in needed if not spied.get(name)]
    assert not missing, (missing, spied)
