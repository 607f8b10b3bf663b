#!/usr/bin/env python3
"""The lanes that decide chip_smoke.py's per-lane slot-step gates.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/slot_gate_lanes.py

``k4`` holds B4's x after one 8-pass segment within 1e-3 (1 + ||x||) of
its twin, and ``k5`` (b) holds B5's x after one pass within 1e-3
(1 + ||x||) of its twin or within twice the twin's own distance to the
twin in f64.  Both decide on single lanes whose discrete choices (an
extra inner step, a near-tie at the primal tolerance) sit at the f32
noise floor.  This prints, as JSON lines: k4's worst lane pass by pass
(the inner iterations so far and the distances of kernel, twin and f64
twin), and every k5 (b) lane beyond the first leg with both legs.
Without a CUDA device it exits 2.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import daqp_tpu_torch as dt  # noqa: E402
from daqp_tpu_torch import batch as pbatch  # noqa: E402
from daqp_tpu_torch.ops import slot  # noqa: E402

KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')


def k4_lanes(st, dev):
    d = cs.config4()
    args = [torch.as_tensor(d[k], device=dev) for k in KEYS]
    Rinv, okl, _, eps, tst, s0, bu_s, bl_s = pbatch.prox_init(*args, st)
    Bk, n = args[1].shape
    carry = (torch.zeros((Bk, n), device=dev), okl.float(),
             torch.zeros(Bk, device=dev),
             torch.full((Bk,), float("inf"), device=dev),
             torch.where(okl, dt.EXIT_RUNNING, -5).to(torch.int32),
             torch.zeros(Bk, device=dev))
    ops_ = (Rinv, args[1], bu_s, bl_s, eps, tst)
    passes = []
    for P in range(1, pbatch.PSEG + 1):
        kw = dict(P=P, steps=pbatch.PROX_STEPS)
        ko = slot.run_prox_segment(s0, *carry, *ops_, st, n, **kw)
        po = slot.run_prox_segment_plain(s0, *carry, *ops_, st, n, **kw)
        p64 = slot.run_prox_segment_plain(
            slot.SlotState(*map(cs.f64, s0)), *map(cs.f64, carry),
            *map(cs.f64, ops_), st, n, **kw)
        sc = 1.0 + po[1].abs().amax(1)
        passes.append(dict(
            kernel_vs_twin=(ko[1] - po[1]).abs().amax(1) / sc,
            kernel_vs_f64=(cs.f64(ko[1]) - p64[1]).abs().amax(1) / sc,
            twin_vs_f64=(cs.f64(po[1]) - p64[1]).abs().amax(1) / sc,
            iters_kernel=ko[6], iters_twin=po[6], iters_f64=p64[6]))
    lane = int(torch.argmax(passes[-1]["kernel_vs_twin"]))
    return dict(gate="k4", tol=cs.K2_DU, worst_lane=lane, passes=[
        {k: float(v[lane]) for k, v in p.items()} for p in passes])


def k5_lanes(st, dev):
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d = cs.config_avi(gen)
    args = [torch.as_tensor(d[k], device=dev) for k in KEYS]
    a = pbatch.avi_init(*args, st)
    ops_ = pbatch.avi_segment_operands(a)
    carry = pbatch.avi_carries(a)
    kw = dict(P=1, steps=pbatch.AVI_STEPS)
    k1 = slot.run_avi_segment(a.s, *carry, *ops_, st, cs.N_AVI, **kw)

    def plain(cast):
        return slot.run_avi_segment_plain(
            slot.SlotState(*map(cast, a.s)), *map(cast, carry),
            *map(cast, ops_), st, cs.N_AVI, **kw)

    p1, p64 = plain(lambda x: x), plain(cs.f64)
    both = cs.avi_flags_agree(k1, p1) & cs.avi_flags_agree(p1, p64)
    sc = 1.0 + p1[1].abs().amax(1)
    gap = (k1[1] - p1[1]).abs().amax(1) / sc
    exk = (cs.f64(k1[1]) - p64[1]).abs().amax(1) / sc
    exp = (cs.f64(p1[1]) - p64[1]).abs().amax(1) / sc
    lanes = torch.nonzero(both & (gap > cs.K2_DU)).flatten().tolist()
    return dict(gate="k5b", tol=cs.K2_DU, lanes=[
        dict(lane=i, kernel_vs_twin=float(gap[i]),
             kernel_vs_f64=float(exk[i]), twin_vs_f64=float(exp[i]),
             holds=bool(exk[i] <= 2.0 * exp[i])) for i in lanes])


def main():
    if not torch.cuda.is_available():
        print("slot_gate_lanes: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    print(json.dumps(k4_lanes(st, dev)), flush=True)
    print(json.dumps(k5_lanes(st, dev)), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
