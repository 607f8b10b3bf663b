"""B7's precondition: E is exactly zero off the active block.

The CUDA dense-mask round (``ops/csrc/dense_round.cu``) walks a list of
the active rows and leaves every other entry of E as it came in, so each
producer of a dense state must leave E zero outside act act'.  This holds
every producer (``dense_init``, ``dense_activate``, the twin round
``run_kernel_round_plain``, ``exact_repair``, ``newton_refresh``,
``polish``, ``dense_add_row``, ``dense_reactivate`` and ``dense_solve``)
to it, exactly, on small soft, SOFT_WEIGHTS and config-4b-like batches
(seeded numpy data, CPU tensors).  ``chip_smoke.py``'s ``k7`` holds the
kernel's own round to it on the card."""
import numpy as np
import pytest
import torch

import daqp_tpu_torch as dt
from daqp_tpu_torch.ops import dense

B = 32
# variant: (m, n, soft rows, first IMMUTABLE row, rho_soft, SOFT_WEIGHTS)
VARIANTS = {
    "soft": (20, 8, range(0, 4), None, None, False),
    "sw": (20, 8, range(0, 4), None, None, True),
    # config 4b's first level: rows 8-15 soft, the later rows IMMUTABLE,
    # rho floored at 3e-2, no factorization (identity metric)
    "4b": (24, 12, range(8, 16), 16, 3e-2, False),
}


def _state(variant):
    m, n, soft_rows, imm_from, rho, has_sw = VARIANTS[variant]
    g = np.random.default_rng(7 + m + int(has_sw))
    M = g.standard_normal((B, m, n)) / np.sqrt(n)
    b0 = np.einsum("bmn,bn->bm", M, 0.5 * g.standard_normal((B, n)))
    du = b0 + 0.2 + 0.8 * g.random((B, m))
    dl = b0 - 0.2 - 0.8 * g.random((B, m))
    soft = np.zeros((B, m))
    soft[:, list(soft_rows)] = 1.0
    immut = np.zeros((B, m))
    if imm_from is not None:
        immut[:, imm_from:] = 1.0
    sw = None
    if has_sw:
        # tests/test_pallas_sw.py:40-43's draw on the soft rows: even
        # lanes mostly FREE slacks, odd lanes mostly FIXED
        even = (np.arange(B) % 2 == 0)[:, None]
        fields = []
        for key in ("d_ls", "d_us", "rho_ls", "rho_us"):
            u = g.random((B, m))
            val = np.where(even, 0.4, 1.5) * u if key.startswith("d") \
                else np.where(even, 0.5, 2.0) + u
            rest = 0.0 if key.startswith("d") else 1.0
            fields.append(torch.as_tensor(np.where(soft > 0, val, rest),
                                          dtype=torch.float32))
        sw = dt.SoftWeights(*fields)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32)

    st = dt.default_settings_f32()
    if rho is not None:
        st = st._replace(rho_soft=rho)
    s = dense.dense_init(t(M), t(du), t(dl), torch.ones(B, m), t(immut),
                         t(soft), sw=sw)
    return s, st, n, g


def _assert_zero_off_block(s, what):
    act = s.act_up + s.act_lo
    off = (act[:, :, None] * act[:, None, :]) == 0
    bad = (s.E != 0) & off
    assert not bool(bad.any()), \
        f"{what}: E nonzero off the active block on lanes " \
        f"{torch.nonzero(bad.any(2).any(1)).flatten().tolist()}"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_producers_keep_e_zero_off_active_block(variant):
    s, st, n, g = _state(variant)
    m = s.M.shape[1]
    _assert_zero_off_block(s, "dense_init")

    # a warm start of three hard rows per lane, random sides
    hard = np.flatnonzero(s.soft[0].numpy() == 0)
    pick = np.stack([g.choice(hard, 3, replace=False) for _ in range(B)])
    up = np.zeros((B, m), bool)
    lo = np.zeros((B, m), bool)
    side = g.random((B, 3)) < 0.5
    np.put_along_axis(up, pick, ~side, 1)
    np.put_along_axis(lo, pick, side, 1)
    s = dense.dense_activate(s, torch.as_tensor(up), torch.as_tensor(lo), st)
    _assert_zero_off_block(s, "dense_activate")

    s = dense.run_kernel_round_plain(s, st, n, steps=6)
    _assert_zero_off_block(s, "run_kernel_round_plain, 6 steps")
    running = s.status == dt.EXIT_RUNNING
    assert bool(running.any())

    # park every other running lane for an exact refactorization
    park = running & (torch.arange(B) % 2 == 0)
    s = s._replace(status=torch.where(park, dt.EXIT_REFACTOR, s.status)
                   .to(torch.int32))
    s = dense.exact_repair(s, st)
    _assert_zero_off_block(s, "exact_repair")

    s = dense.run_kernel_round_plain(s, st, n)
    _assert_zero_off_block(s, "run_kernel_round_plain, a full round")
    act = s.act_up + s.act_lo
    # the check has entries on both sides of the block
    assert int((act.sum(1) > 1).sum()) >= B // 2
    assert bool((act.sum(1) < m).all())

    s = dense.newton_refresh(s, st)
    _assert_zero_off_block(s, "newton_refresh")
    s = dense.polish(s, st)
    _assert_zero_off_block(s, "polish")

    # a bordered add of the lowest row some lanes leave inactive
    free = act == 0
    i = int(torch.nonzero(free.any(0))[0])
    s, ok = dense.dense_add_row(s, i, torch.zeros(B), torch.zeros(B),
                                free[:, i].float(), st, n)
    assert bool(ok.any())
    _assert_zero_off_block(s, "dense_add_row")

    s, _ = dense.dense_reactivate(s, st, n, start=0)
    _assert_zero_off_block(s, "dense_reactivate")

    s = s._replace(status=torch.full_like(s.status, dt.EXIT_RUNNING))
    s = dense.dense_solve(s, st, n, max_rounds=2)
    _assert_zero_off_block(s, "dense_solve")
