"""The frozen count functions against the chip smoke test's at fixed
shapes."""
import importlib.util
from types import SimpleNamespace as NS

import pytest
import torch

from harness import counts, manifest


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "qpbench_test_chip_smoke", manifest.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPES = [(100, 50, 51), (100, 50, 20.5), (40, 20, 21), (893, 50, 51)]


def test_peaks(cs):
    assert (counts.PEAK_F32, counts.PEAK_BYTES) == (cs.PEAK_F32,
                                                   cs.PEAK_BYTES)


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_step_counts(cs, m, n, k):
    assert counts.step_flops(m, n, k) == cs.step_flops(m, n, k)
    assert counts.prefix_flops(n, k) == cs.prefix_flops(n, k)
    assert counts.dense_step_flops(k, m, n) == cs.dense_step_flops(k, m, n)
    assert counts.sw_step_flops(k, m, n) == cs.sw_step_flops(k, m, n)


@pytest.mark.parametrize("nb,fl", [(1e6, 1e9), (1e9, 1e6), (0, 0)])
def test_bound(cs, nb, fl):
    assert counts.bound(nb, fl) == cs.bound(nb, fl)


@pytest.mark.parametrize("B,n", [(10240, 50), (256, 50), (64, 100)])
def test_factorization(cs, B, n):
    mine = counts.bound(counts.factor_bytes(B, n), counts.factor_flops(B, n))
    theirs = cs.bound(4 * B * (n * (n + 1) // 2 + n * n), B * 2 * n ** 3 / 3)
    assert mine == theirs


def _slot(g, B, K):
    return NS(used=(torch.rand(B, K, generator=g) < 0.6).float(),
              iterations=torch.randint(0, 50, (B,), generator=g).float(),
              status=torch.where(torch.rand(B, generator=g) < 0.8, 99, 1)
              .to(torch.int32))


def test_round_counts(cs):
    g = torch.Generator().manual_seed(3)
    s0, sk = _slot(g, 64, 51), _slot(g, 64, 51)
    sk.iterations = s0.iterations + 30
    assert counts.slot_round_flops(s0, sk, 100, 50) == \
        cs.slot_round_flops(s0, sk, 100, 50)
    d0 = NS(act_up=(torch.rand(64, 100, generator=g) < .2).float(),
            act_lo=(torch.rand(64, 100, generator=g) < .2).float(),
            iterations=torch.zeros(64), M=torch.zeros(64, 100, 50),
            sw_dls=None)
    dk = NS(act_up=d0.act_lo, act_lo=d0.act_up,
            iterations=torch.full((64,), 17.0), M=d0.M, sw_dls=None)
    assert counts.dense_round_flops(d0, dk, 50) == \
        cs.dense_round_flops(d0, dk, 50)
    d0.sw_dls = torch.zeros(1)
    assert counts.dense_round_flops(d0, dk, 50, sw=True) == \
        cs.dense_round_flops(d0, dk, 50)


def test_lane_states_are_the_ports():
    import daqp_tpu_torch as dt
    assert (counts.RUNNING, counts.CYCLE, counts.REFACTOR) == \
        (dt.EXIT_RUNNING, dt.EXIT_CYCLE, dt.EXIT_REFACTOR)


def test_state_bytes():
    s = NS(a=torch.zeros(3, 4), b=torch.zeros(5, dtype=torch.int32), c=None)
    s._asdict = lambda: {"a": s.a, "b": s.b, "c": s.c}
    assert counts.state_bytes(s) == 3 * 4 * 4 + 5 * 4
    assert counts.state_bytes(s, ("a",)) == 20
