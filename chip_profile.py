#!/usr/bin/env python3
"""Where the time goes: one profiled call of each of the port's cells on
one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_profile.py

For BASELINE config 2 (``solve_batch_kernel_stream``, chunk 256), its
soft variant (rows 0-19 SOFT, ``has_soft=True``), its SOFT_WEIGHTS
variant (``sw=``), config 3 (``solve_mpc_scan_kernel_fused``, seg 10),
config 4 (``solve_batch_prox_kernel``), config 4b
(``solve_batch_hiqp_kernel``), configAVI (``solve_batch_avi_kernel``)
and configLP (``solve_batch_lp_kernel``, per-pass and fused), at the data
of ``chip_smoke.py``, it runs
one warm-up call and then one call under ``torch.profiler`` (CPU and
CUDA activities), and prints one JSON line per cell: the host wall of the
profiled call, the device time summed over kernels, the device's busy and
idle shares of the wall, the host syncs, and the kernels that took most
device time with their launch counts.  The Chrome traces go to
``chiprun_out/profile_<cell>.json.gz``.  Without a CUDA device it exits 2.

    python3 chip_profile.py --probe k2

instead builds an instrumented copy of the kernels' sources under
``build/probe_k2`` (K2 alone, compiled with ``-DSLOT_PROBE``; the normal
library is not touched), runs one K2 round on ``chip_smoke.py``'s k2 case
e (the first 256-lane chunk of the sorted config-2 stream) and prints the
SM cycles per step of each phase of the slot step (``slot_step.cuh``,
``SLOT_PROBE_MARK``), the prefix's cycles per lane, and the probe's cost:
the instrumented round's time beside the normal kernel's.

    python3 chip_profile.py --probe k5
    python3 chip_profile.py --probe k6

build an instrumented copy of B5 (``avi_segment.cu``) or B6
(``lp_segment.cu``) alone under ``build/probe_k5`` / ``build/probe_k6``
(``-DSLOT_PROBE``: the step's marks and the segment's, ``segment.cuh``)
and print, for each launch probed, the SM cycles per pass of the
segment's prologue (v and the bounds), inner solve (split into the slot
step's phases per step) and epilogue (the outer half), the loads and
stores of a block that ran a pass, a stopped block's whole time, and the
instrumented launch's time beside the normal kernel's.  ``k5`` probes
``chip_smoke.py``'s cold k5 segment (configAVI, B = 256) and the last B5
launch of one configAVI solve (its tail: the lanes still running after
the others finished); ``k6`` probes k6's cold configLP segment.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch, ops
from daqp_tpu_torch.ops import _build, slot

OUT = Path(__file__).resolve().parent / "chiprun_out"
BUILD = Path(__file__).resolve().parent / "build"
# the phases of slot_steps between SLOT_PROBE_MARKs, in order
PROBE_PHASES = ("prefix", "ratio_test_and_u", "pricing_and_reduce",
                "gram_column_and_reduce", "schur_vector_removal_and_reduce",
                "pending_column_bookkeeping_and_e_update")
# the segment kernels' phases (segment.cuh SEG_PROBE_MARK), in order
SEG_PHASES = ("load", "prologue", "solve", "epilogue", "store", "stopped")


def device_us(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profiled(cell, fn, card):
    fn()
    torch.cuda.synchronize()
    ops.host_syncs = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = ops.host_syncs
    kernels = [e for e in prof.key_averages()
               if e.device_type is not None
               and str(e.device_type).endswith("CUDA")]
    dev_ms = sum(device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    OUT.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT / f"profile_{cell}.json.gz"))
    print(json.dumps({
        "cell": cell, "wall_ms": 1e3 * wall, "device_ms": dev_ms,
        "device_busy_share": dev_ms / (1e3 * wall),
        "device_idle_share": 1.0 - dev_ms / (1e3 * wall),
        "host_syncs": syncs,
        "top_kernels": [{"name": e.key[:80], "ms": device_us(e) / 1e3,
                         "count": e.count} for e in top],
        "card": card}), flush=True)


def probe_library(case, source, entry):
    """The kernel of ``source`` built alone from a copy of ``csrc/`` with
    the cycle probe compiled in, under ``build/probe_<case>``, bound by
    ctypes."""
    src = BUILD / f"probe_{case}" / "csrc"
    shutil.copytree(_build._CSRC, src, dirs_exist_ok=True)
    so = src.parent / f"lib{case}_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DSLOT_PROBE",
                    "-shared", "-o", str(so), str(src / source)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
    getattr(lib, entry).restype = ctypes.c_int
    return lib


def probe_round(lib, s, st, n_true, steps):
    """One instrumented K2 round from ``s`` (the pointer table of
    ``slot.run_slot_round``)."""
    B, m, n = s.M.shape
    outs = [torch.empty_like(getattr(s, k)) for k in slot.STATE]
    ptrs = [getattr(s, k).data_ptr() for k in slot.CONST + slot.STATE] \
        + [x.data_ptr() for x in outs]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    rc = lib.slot_round_f32(
        ctypes.addressof(table), B, m, n, s.E.shape[1], n_true, steps,
        st.dual_tol, st.primal_tol, st.pivot_tol, st.sing_tol,
        st.progress_tol, st.cycle_tol, 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "slot_round_f32 (probe)")


def probe_k2(dev, card):
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d = gen.generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT,
                                   cs.KAPPA, rng=cs.SEED, dtype=np.float32)
    full = [torch.as_tensor(d[k], device=dev)
            for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    lanes = cs.first_chunk(full, st)
    s0 = cs.slot_state([a[lanes] for a in full], st)
    lib = probe_library("k2", "slot_round.cu", "slot_round_f32")
    for fn in (lib.slot_probe_read, lib.slot_probe_reset):
        fn.restype = ctypes.c_int
    lib.slot_probe_read.argtypes = [ctypes.c_void_p]
    probe_round(lib, s0, st, cs.N, cs.STEPS)            # warm-up
    torch.cuda.synchronize()
    _build.check(lib.slot_probe_reset(), "slot_probe_reset")
    probe_round(lib, s0, st, cs.N, cs.STEPS)
    torch.cuda.synchronize()
    words = (ctypes.c_ulonglong * (len(PROBE_PHASES) + 1))()
    _build.check(lib.slot_probe_read(ctypes.addressof(words)),
                 "slot_probe_read")
    steps, ran = words[-1], int((s0.status == dt.EXIT_RUNNING).sum())
    per_step = {ph: words[i] / steps for i, ph in enumerate(PROBE_PHASES)
                if i > 0}
    total = sum(per_step.values())
    print(json.dumps({
        "probe": "k2", "case": "chunk256", "B": len(lanes), "steps": steps,
        "prefix_cycles_per_lane": words[0] / ran,
        "cycles_per_step": per_step, "cycles_per_step_total": total,
        "share": {ph: v / total for ph, v in per_step.items()},
        "ms_probe": cs.cuda_ms(lambda: probe_round(lib, s0, st, cs.N,
                                                   cs.STEPS), 5),
        "ms_kernel": cs.cuda_ms(lambda: slot.run_slot_round(
            s0, st, cs.N, cs.STEPS), 5),
        "card": card}), flush=True)


def probe_segment(case, source, entry, launch, name, B, card):
    """One instrumented launch of a segment kernel: ``launch`` is the
    wrapper's call, run once on the normal library and on the probe's
    (swapped in as the wrapper's library); prints the cycles per pass of
    each segment phase, of each step phase per step, and the times."""
    lib = probe_library(case, source, entry)
    for fn in (lib.seg_probe_read, lib.seg_probe_reset):
        fn.restype = ctypes.c_int
    lib.seg_probe_read.argtypes = [ctypes.c_void_p]
    normal = _build.library()

    def probed():
        _build._lib = lib
        try:
            return launch()
        finally:
            _build._lib = normal

    probed()                                            # warm-up
    torch.cuda.synchronize()
    _build.check(lib.seg_probe_reset(), "seg_probe_reset")
    probed()
    torch.cuda.synchronize()
    nstep = len(PROBE_PHASES) + 1
    words = (ctypes.c_ulonglong * (nstep + len(SEG_PHASES) + 2))()
    _build.check(lib.seg_probe_read(ctypes.addressof(words)),
                 "seg_probe_read")
    step, seg = list(words[:nstep]), list(words[nstep:])
    passes, ran = seg[-2], seg[-1]
    steps = step[-1]
    per_pass = {ph: seg[i] / max(passes, 1)
                for i, ph in enumerate(SEG_PHASES) if 1 <= i <= 3}
    pass_total = sum(per_pass.values())
    per_step = {ph: step[i] / max(steps, 1)
                for i, ph in enumerate(PROBE_PHASES) if i > 0}
    print(json.dumps({
        "probe": case, "case": name, "B": B, "blocks_ran": ran,
        "passes": passes, "steps": steps,
        "steps_per_pass": steps / max(passes, 1),
        "cycles_per_pass": per_pass, "cycles_per_pass_total": pass_total,
        "share_of_pass": {ph: v / max(pass_total, 1)
                          for ph, v in per_pass.items()},
        "step_prefix_cycles_per_pass": step[0] / max(passes, 1),
        "step_cycles_per_step": per_step,
        "step_cycles_per_step_total": sum(per_step.values()),
        "load_cycles_per_block_ran": seg[0] / max(ran, 1),
        "store_cycles_per_block_ran": seg[4] / max(ran, 1),
        "cycles_per_stopped_block": seg[5] / max(B - ran, 1),
        "ms_probe": cs.cuda_ms(probed, 5),
        "ms_kernel": cs.cuda_ms(launch, 5),
        "card": card}), flush=True)


def probe_k5(dev, card):
    """B5 at k5's cold segment and at the last launch of one configAVI
    solve."""
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d = cs.config_avi(gen)
    args = [torch.as_tensor(d[k], device=dev)
            for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    a = pbatch.avi_init(*args, st)
    ops_ = pbatch.avi_segment_operands(a)
    cases = (("cold", a.s, pbatch.avi_carries(a)),
             ("tail", *cs.main_path_segments(args, st)[-1]))
    for name, s, carry in cases:
        probe_segment("k5", "avi_segment.cu", "avi_segment_f32",
                      lambda: slot.run_avi_segment(
                          s, *carry, *ops_, st, cs.N_AVI, P=pbatch.PSEG,
                          steps=pbatch.AVI_STEPS),
                      f"{name} (live lanes {int((carry[6] > 0).sum())})",
                      cs.B_AVI, card)


def probe_k6(dev, card):
    """B6 at k6's cold configLP segment."""
    st = dt.as_settings({"iter_limit": 3000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d = cs.config_lp(gen)
    args = [torch.as_tensor(d[k], device=dev)
            for k in ('f', 'A', 'bupper', 'blower', 'sense')]
    p = pbatch.lp_init(*args, st)
    carry = pbatch.lp_carries(p)
    s = p.s0._replace(status=torch.full_like(p.s0.status, dt.EXIT_OPTIMAL))
    data = (p.f, p.bu_s, p.bl_s, p.bu_r, p.bl_r)
    probe_segment("k6", "lp_segment.cu", "lp_segment_f32",
                  lambda: slot.run_lp_segment(
                      s, *carry, *data, st, cs.N_LP, p.eta, P=pbatch.LP_PSEG,
                      steps=pbatch.LP_SEG_STEPS),
                  "cold", cs.B_LP, card)


def main():
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    probes = {"k2": probe_k2, "k5": probe_k5, "k6": probe_k6}
    if sys.argv[1:2] == ["--probe"] and sys.argv[2:] \
            and set(sys.argv[2:]) <= set(probes):
        for case in sys.argv[2:]:
            probes[case](dev, card)
        print(card, flush=True)
        return 0
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')

    d = gen.generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT,
                                   cs.KAPPA, rng=cs.SEED, dtype=np.float32)
    full = [torch.as_tensor(d[k], device=dev) for k in keys]
    profiled("config2", lambda: dt.solve_batch_kernel_stream(
        *full, st=st, chunk=256, sort_stream=True), card)
    soft = full[:5] + [cs.soft_sense(full[5])]
    profiled("config2_soft", lambda: dt.solve_batch_kernel_stream(
        *soft, st=st, chunk=256, has_soft=True, sort_stream=True), card)
    sw = cs.sw_tensors(cs.sw_weights(cs.B, cs.M_ROWS), dev)
    profiled("config2_sw", lambda: dt.solve_batch_kernel_stream(
        *soft, st=st, chunk=256, has_soft=True, sort_stream=True, sw=sw),
        card)
    del full, soft, sw

    d3 = cs.config3(gen)
    args3 = [torch.as_tensor(d3[k], device=dev)
             for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
    profiled("config3", lambda: dt.solve_mpc_scan_kernel_fused(
        *args3, st, seg=cs.SEG3), card)

    d4 = cs.config4()
    args4 = [torch.as_tensor(d4[k], device=dev) for k in keys]
    profiled("config4", lambda: dt.solve_batch_prox_kernel(*args4, st),
             card)

    d4b = cs.config4b()
    args4b = [torch.as_tensor(d4b[k], device=dev)
              for k in ('f', 'A', 'bupper', 'blower', 'sense')]
    profiled("config4b", lambda: dt.solve_batch_hiqp_kernel(
        None, *args4b, st, break_points=cs.BP4B), card)

    d_avi = cs.config_avi(gen)
    args_avi = [torch.as_tensor(d_avi[k], device=dev) for k in keys]
    profiled("configAVI", lambda: dt.solve_batch_avi_kernel(*args_avi, st),
             card)

    d_lp = cs.config_lp(gen)
    args_lp = [torch.as_tensor(d_lp[k], device=dev)
               for k in ('f', 'A', 'bupper', 'blower', 'sense')]
    st_lp = dt.as_settings({"iter_limit": 3000}, torch.float32)
    for fused in (False, True):
        profiled("configLP_fused" if fused else "configLP",
                 lambda: dt.solve_batch_lp_kernel(*args_lp, st_lp,
                                                  fused=fused), card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
