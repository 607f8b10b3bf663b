#!/usr/bin/env python3
"""Where the time goes: one profiled call of each of the port's cells on
one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_profile.py

For BASELINE config 2 (``solve_batch_kernel_stream``, chunk 256), its
soft variant (rows 0-19 SOFT, ``has_soft=True``), its SOFT_WEIGHTS
variant (``sw=``), config 3 (``solve_mpc_scan_kernel_fused``, seg 10),
config 4 (``solve_batch_prox_kernel``), config 4b
(``solve_batch_hiqp_kernel``), configAVI (``solve_batch_avi_kernel``),
configLP (``solve_batch_lp_kernel``, per-pass and fused), the backstop
(``backstop_resolve`` of ``chip_smoke.py``'s forced failures, on the
first 256 lanes), config
1 (16 single-instance ``quadprog`` solves, f64 and f32), config 5
(``solve_batch_miqp_kernel``: node waves on K1 and K2) and the flat tier
(``flat``: ``solve_batch_flat_jit`` on config 2's first 2048 lanes;
``flat_grid100``: ``solve_batch`` on the reference grid's n = 100 batch
of 64), at the data of ``chip_smoke.py``, it runs
one warm-up call and then one call under ``torch.profiler`` (CPU and
CUDA activities), and prints one JSON line per cell: the host wall of the
profiled call, the device time summed over kernels, the device's busy and
idle shares of the wall, the host syncs, and the kernels that took most
device time with their launch counts.  The Chrome traces go to
``chiprun_out/profile_<cell>.json.gz``.  Without a CUDA device it exits 2.
``python3 chip_profile.py --cells config5 config1_float64`` profiles the
named cells alone.

    python3 chip_profile.py --probe k2

instead builds an instrumented copy of the kernels' sources under
``build/probe_k2`` (K2 alone, compiled with ``-DSLOT_PROBE``; the normal
library is not touched), runs one K2 round on ``chip_smoke.py``'s k2 case
e (the first 256-lane chunk of the sorted config-2 stream) and prints the
SM cycles per step of each phase of the slot step (``slot_step.cuh``,
``SLOT_PROBE_MARK``), the prefix's cycles per lane, and the probe's cost:
the instrumented round's time beside the normal kernel's.

    python3 chip_profile.py --probe k3 k4
    python3 chip_profile.py --probe k5 k6

build an instrumented copy of B3 (``mpc_segment.cu``), B4
(``prox_segment.cu``), B5 (``avi_segment.cu``) or B6 (``lp_segment.cu``)
alone under ``build/probe_k3`` ... ``build/probe_k6`` (``-DSLOT_PROBE``:
the step's marks and the segment's, ``segment.cuh``) and print, for each
launch probed, the SM cycles per pass (B3: per horizon step) of the
segment's prologue (v and the bounds), inner solve (split into the slot
step's phases per step) and epilogue (the outer half), the loads and
stores of a block that ran a pass, a stopped block's whole time, the
slot steps per pass, the in-kernel cold retries, the slowest block
against the mean (its lane, cycles, steps and retries), the blocks'
spread on the global timer, the registers and spills ptxas gave the
probed and the normal kernel, the normal kernel's resident blocks per
SM (the occupancy calculator; B3 and B4) and waves, and the
instrumented launch's time beside the normal kernel's, and the slowest
block's own SM cycles per step of each phase.  ``k3`` probes
``chip_smoke.py``'s k3 segment (config 3's one B3 launch, warm segment
1) on the horizon body and on the 128-thread body (the horizon body's
probe build without its 4-blocks cap: under it the counters spill); ``k4`` the cold config-4 segment of k4 and the last B4 launch of one
config-4 solve; ``k5`` the cold k5 segment (configAVI, B = 256) and the
last B5 launch of one configAVI solve (its tail: the lanes still running
after the others finished); ``k6`` k6's cold configLP segment.  Each
probe also prints the SASS size of every kernel of the normal library
(``cuobjdump -sass``: instructions and a hash of their text).

    python3 chip_profile.py --probe k1 k9

builds K1 (``chol_rinv.cu``) or B9 (``chol_dense.cu``) alone under
``build/probe_k1`` / ``build/probe_k9`` with ``-DCHOL_PROBE`` (the marks
of ``chol_probe.cuh``), runs it through its wrapper on config 2's
Hessians (K1 also on the first 256, config 4's retry shape, and on the
flat grid's n = 100 and 200 batches of 64 and 16) and prints
the SM cycles per unit (the matrix's lead thread: a block or warp) of the
load, phase 1, phase 2 and the store, the slowest unit against the mean,
the units' spread over SMs and time, resident blocks per SM (a copy built
with ``-DCHOL_OCCUPANCY``) and waves, registers and spills, and both
times; ``k9`` also times the normal B9 in turns with one built at ptxas's
default register usage level (the normal build sets level 0).

    python3 chip_profile.py --sass

prints only that SASS line.

    python3 chip_profile.py --tail 200

repeats B5's tail launch (the last B5 launch of one configAVI solve, one
live lane) 200 times in one process, in turns on the normal library and
on an instrumented copy (``build/probe_k5``), each call timed alone by
CUDA events, and prints the distributions of the times, of the live
block's SM cycles and global-timer span and of their ratio, the SM clock
the block ran at, so that a slow call shows whether it took more cycles
or ran at a lower clock; every call's numbers go to
``chiprun_out/tail_repeat.json``.

    python3 chip_profile.py --k3-wide 7 11

runs k3's case (B3 over the warm segment 1 of config 3's horizon, against
its twin) at config 3's width and at a second one past it (config 3's
generator at n = 80, m = 160, 64 rows active at the optimum, S = 64; the
128-thread body, K = 81), for each data seed named (7 is config 3's),
and runs the twin a second time in f64 on the same f32 warm state with
the same settings, so that a disagreement of kernel and twin shows
whether the kernel or f32 arithmetic moves the lanes: per case the
rates at which kernel and f32 twin, kernel and f64 twin, and f32 and f64
twin agree on every step's exit flag and on ``failed`` (k3's
``flags_agree_rate``), and the f32 sides' largest distance from the f64
twin's u on the lanes where all three agree and are optimal.  It also
runs on the CPU (``--cpu``; the kernel's wrapper then runs its twin).
With ``--refresh`` every side runs one horizon step a launch, each after
a Newton refresh of E (``slot.newton_refresh``), so that the f32 drift
of E's rank-one updates over the segment is taken out of the comparison.
"""
import ctypes
import hashlib
import json
import re
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
from daqp_tpu_torch.ops import _build, chol, slot, smem

OUT = Path(__file__).resolve().parent / "chiprun_out"
BUILD = Path(__file__).resolve().parent / "build"
# the phases of slot_steps between SLOT_PROBE_MARKs, in order
PROBE_PHASES = ("prefix", "ratio_test_and_u", "pricing_and_reduce",
                "gram_column_and_reduce", "schur_vector_removal_and_reduce",
                "pending_column_bookkeeping_and_e_update")
# the segment kernels' phases (segment.cuh SEG_PROBE_MARK), in order
SEG_PHASES = ("load", "prologue", "solve", "epilogue", "store", "stopped")
PROBE_BLOCKS = 1024     # slot_step.cuh kProbeBlocks
BLOCK_WORDS = 5         # segment.cuh kBlockWords: cycles, steps, SM, start,
                        # end (global timer, ns)
TAIL_SPIN = 2_000_000   # cycles of spin before a call timed alone (~1 ms)
# the factorization kernels' phases (chol_probe.cuh CHOL_PROBE_MARK)
CHOL_PHASES = ("load", "phase1", "phase2", "store")
CHOL_UNITS = 16384      # chol_probe.cuh kProbeUnits
UNIT_WORDS = 4          # chol_probe.cuh kUnitWords: cycles, SM, start, end
# the kernels of the library, by the name of their __global__ function
KERNELS = ("chol_rinv", "chol_lanes", "chol_dense", "chol_blk",
           "slot_round", "mpc_segment", "prox_segment", "avi_segment",
           "lp_segment", "dense_round", "lp_segment_warp",
           "avi_segment_warp", "mpc_segment_horizon")


def device_us(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


CELLS = None      # --cells: the cells to profile (None: every cell)


def profiled(cell, fn, card):
    if CELLS is not None and cell not in CELLS:
        return
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


def ptxas(log, kernel):
    """Registers and spill bytes that ptxas's -v output ``log`` gives the
    __global__ function named ``<kernel>_kernel``."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            continue
        if cur is None or f"{kernel}_kernel" not in cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out["registers"] = int(m.group(1))
            cur = None          # the lines after it are other functions'
    return out


def sass_sizes(so):
    """Per kernel of the shared library ``so`` (``cuobjdump -sass``): its
    SASS instructions and a hash of their text (addresses and encodings
    left out), so that two builds compare; K1's and B9's instances keyed
    ``chol_rinv<G,P>``, the others' ``name``, ``name#2``, ... in order."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            cur = next((k for k in KERNELS if f"{k}_kernel" in m.group(1)),
                       m.group(1))
            # K1's and B9's instances by their template <G, P>
            gp = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
            if cur in ("chol_rinv", "chol_dense") and gp:
                cur = f"{cur}<{gp.group(1)},{gp.group(2)}>"
            # a template's instantiations: name, name#2, ...
            base, i = cur, 1
            while cur in funcs:
                i += 1
                cur = f"{base}#{i}"
            funcs[cur] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if m and cur is not None:
            funcs[cur].append(m.group(1))
    return {k: dict(instructions=len(v), sha=hashlib.sha256(
        "\n".join(v).encode()).hexdigest()[:16]) for k, v in funcs.items()}


def print_sass(card):
    lib = _build.library()
    print(json.dumps({"sass": sass_sizes(lib._name), "card": card}),
          flush=True)


def build_alone(case, source, variants):
    """``source`` built alone from a copy of ``csrc/`` under
    ``build/probe_<case>``, once per variant ({name: nvcc flags}), in
    parallel: {name: (the library, ptxas's -v output)}."""
    src = BUILD / f"probe_{case}" / "csrc"
    shutil.copytree(_build._CSRC, src, dirs_exist_ok=True)
    sos = {v: src.parent / f"lib{case}_{v}.so" for v in variants}
    procs = {v: subprocess.Popen([_build._nvcc(), *flags, "-shared", "-o",
                                  str(sos[v]), str(src / source)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for v, flags in variants.items()}
    logs = {v: proc.communicate()[0] for v, proc in procs.items()}
    if any(proc.returncode for proc in procs.values()):
        raise RuntimeError("nvcc failed:\n" + "".join(logs.values())[-4000:])
    return {v: (ctypes.CDLL(str(so)), logs[v]) for v, so in sos.items()}


def bind(lib, entry):
    getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
    getattr(lib, entry).restype = ctypes.c_int


_probe_libs = {}


def probe_library(case, source, entry, occupancy=False):
    """The kernel of ``source`` built alone with the cycle probe compiled
    in (``-DSLOT_PROBE``), bound by ctypes; also returns ptxas's -v output
    and, with ``occupancy``, a second library built in parallel from the
    same source without the probe's marks (``-DSEG_OCCUPANCY``), whose
    ``<kernel>_occupancy`` entry reads the normal kernel's resident blocks
    per SM (else None).  Built once a process."""
    if (case, occupancy) in _probe_libs:
        return _probe_libs[case, occupancy]
    variants = {"probe": [*_build.NVCC_FLAGS, "-DSLOT_PROBE"]}
    if occupancy:
        variants["occupancy"] = [*_build.NVCC_FLAGS, "-DSEG_OCCUPANCY"]
    libs = build_alone(case, source, variants)
    lib, log = libs["probe"]
    bind(lib, entry)
    out = lib, log, libs["occupancy"][0] if occupancy else None
    _probe_libs[case, occupancy] = out
    return out


def swapped(lib, fn):
    """``fn`` run with ``lib`` as the kernels' library: the wrappers call
    ``_build.library()``."""
    def call():
        normal = _build.library()
        _build._lib = lib
        try:
            return fn()
        finally:
            _build._lib = normal
    return call


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
    lib, _, _ = probe_library("k2", "slot_round.cu", "slot_round_f32")
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


def occupancy(lib, kernel, shape):
    """Resident blocks per SM of ``kernel`` (B3 or B4) at ``shape`` (m, n,
    K; B3 also its body, as its C entry takes it), by the occupancy
    calculator, from ``probe_library``'s occupancy library ``lib``."""
    fn = getattr(lib, f"{kernel}_occupancy")
    fn.argtypes = [ctypes.c_int] * len(shape) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(*shape, ctypes.addressof(blocks)), f"{kernel}_occupancy")
    return blocks.value


def block_fields(blocks, retries, B):
    """The slowest block against the mean, the retries and the blocks'
    spread over SMs and the global timer, from the probe's per-block
    words (the first min(B, PROBE_BLOCKS) blocks)."""
    nb = min(B, PROBE_BLOCKS)
    w = np.asarray(blocks[:nb * BLOCK_WORDS], dtype=np.float64).reshape(
        nb, BLOCK_WORDS)
    r = np.asarray(retries[:nb], dtype=np.int64)
    cyc, steps, sm = w[:, 0], w[:, 1], w[:, 2].astype(np.int64)
    start, end = w[:, 3], w[:, 4]
    slow = int(np.argmax(cyc))
    order = np.argsort(-cyc)[:5]
    per_sm = np.bincount(sm)
    return dict(
        block_cycles_mean=float(cyc.mean()),
        block_cycles_median=float(np.median(cyc)),
        slowest=dict(lane=slow, cycles=float(cyc[slow]),
                     over_mean=float(cyc[slow] / cyc.mean()),
                     steps=float(steps[slow]), retries=int(r[slow]),
                     sm=int(sm[slow])),
        slowest5=[dict(lane=int(i), cycles=float(cyc[i]),
                       steps=float(steps[i]), retries=int(r[i]))
                  for i in order],
        steps_per_block_mean=float(steps.mean()),
        steps_per_block_max=float(steps.max()),
        retries=int(r.sum()), lanes_with_retries=np.nonzero(r)[0].tolist(),
        sms_used=int((per_sm > 0).sum()),
        blocks_per_sm_max=int(per_sm.max()),
        start_spread_us=float(start.max() - start.min()) / 1e3,
        launch_span_us=float(end.max() - start.min()) / 1e3,
        slowest_block_us=float(end[slow] - start[slow]) / 1e3)


def seg_probe_words():
    """The buffer of ``seg_probe_read`` (segment.cuh): the step's words,
    the segment's, each block's, each block's retries, each block's step
    words (cycles per phase, then its steps)."""
    nstep, nseg = len(PROBE_PHASES) + 1, len(SEG_PHASES) + 2
    return (ctypes.c_ulonglong * (nstep + nseg + PROBE_BLOCKS * (
        BLOCK_WORDS + 1 + nstep)))()


def probe_segment(case, source, entry, launch, name, B, card,
                  kernel=None, shape=None, body=None):
    """One instrumented launch of a segment kernel: ``launch`` is the
    wrapper's call, run once on the normal library and on the probe's
    (swapped in as the wrapper's library); prints the cycles per pass of
    each segment phase, of each step phase per step, the blocks'
    spread, ptxas's registers (B5, B6: of both bodies; B3: of ``body``'s
    kernel, ``mpc_segment_<body>`` past the 128-thread one) and, for B3 /
    B4 (``kernel`` at ``shape`` (m, n, K[, body])), resident blocks per
    SM, and the times."""
    lib, log, occ = probe_library(case, source, entry, kernel is not None)
    for fn in (lib.seg_probe_read, lib.seg_probe_reset):
        fn.restype = ctypes.c_int
    lib.seg_probe_read.argtypes = [ctypes.c_void_p]
    probed = swapped(lib, launch)
    probed()                                            # warm-up
    torch.cuda.synchronize()
    _build.check(lib.seg_probe_reset(), "seg_probe_reset")
    probed()
    torch.cuda.synchronize()
    nstep = len(PROBE_PHASES) + 1
    nseg = len(SEG_PHASES) + 2
    words = seg_probe_words()
    _build.check(lib.seg_probe_read(ctypes.addressof(words)),
                 "seg_probe_read")
    step, seg = list(words[:nstep]), list(words[nstep:nstep + nseg])
    at = nstep + nseg + PROBE_BLOCKS * BLOCK_WORDS
    blocks = words[nstep + nseg:at]
    retries = words[at:at + PROBE_BLOCKS]
    block_steps = np.asarray(words[at + PROBE_BLOCKS:], np.float64).reshape(
        PROBE_BLOCKS, nstep)
    kern = source[:-3] + (f"_{body}" if body not in (None, "block") else "")
    nlog = _build.BUILD_DIR / "nvcc.log"
    normal_log = nlog.read_text() if nlog.exists() else ""
    resident = {}
    if kernel is not None:
        per_sm = occupancy(occ, kernel, shape)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        resident = dict(resident_blocks_per_sm=per_sm, sms=sms,
                        waves=-(-B // (per_sm * sms)) if per_sm else None)
    passes, ran = seg[-2], seg[-1]
    steps = step[-1]
    per_pass = {ph: seg[i] / max(passes, 1)
                for i, ph in enumerate(SEG_PHASES) if 1 <= i <= 3}
    pass_total = sum(per_pass.values())
    per_step = {ph: step[i] / max(steps, 1)
                for i, ph in enumerate(PROBE_PHASES) if i > 0}
    # the slowest block's own steps (the tail lane's, where one sets the
    # launch)
    bf = block_fields(blocks, retries, B)
    tail = block_steps[bf["slowest"]["lane"]]
    tail_step = {ph: tail[i] / max(tail[-1], 1)
                 for i, ph in enumerate(PROBE_PHASES) if i > 0}
    print(json.dumps({
        "probe": case, "case": name, **({"body": body} if body else {}),
        "B": B, "blocks_ran": ran,
        "passes": passes, "steps": steps,
        "steps_per_pass": steps / max(passes, 1),
        "cycles_per_pass": per_pass, "cycles_per_pass_total": pass_total,
        "share_of_pass": {ph: v / max(pass_total, 1)
                          for ph, v in per_pass.items()},
        "step_prefix_cycles_per_pass": step[0] / max(passes, 1),
        "step_cycles_per_step": per_step,
        "step_cycles_per_step_total": sum(per_step.values()),
        "slowest_step_cycles_per_step": tail_step,
        "slowest_step_cycles_per_step_total": sum(tail_step.values()),
        "load_cycles_per_block_ran": seg[0] / max(ran, 1),
        "store_cycles_per_block_ran": seg[4] / max(ran, 1),
        "cycles_stopped_total": seg[5],
        "cycles_per_stopped_block": seg[5] / max(B - ran, 1),
        **bf, **resident,
        "ptxas": ptxas(normal_log, kern),
        "ptxas_probe": ptxas(log, kern),
        **({"ptxas_warp": ptxas(normal_log, kern + "_warp"),
            "ptxas_probe_warp": ptxas(log, kern + "_warp")}
           if kern in ("avi_segment", "lp_segment") else {}),
        "ms_probe": cs.cuda_ms(probed, 5),
        "ms_kernel": cs.cuda_ms(launch, cs.SEG_REPS),
        "card": card}), flush=True)


def probe_k3(dev, card):
    """B3 at k3's warm segment 1 of config 3, its one launch per call, on
    the horizon body (config 3's) and on the 128-thread body."""
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d3 = cs.config3(gen)
    args = [torch.as_tensor(d3[k], device=dev)
            for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
    s1, duq, dlq = cs.mpc_warm_segment(args, st)
    for body in ("horizon", "block"):
        probe_segment("k3", "mpc_segment.cu", "mpc_segment_f32",
                      lambda: slot.run_mpc_segment(s1, duq, dlq, st, cs.N,
                                                   steps=cs.STEPS,
                                                   body=body),
                      "warm segment 1", cs.S3, card, "mpc_segment",
                      (cs.M_ROWS, cs.N, cs.N + 1, slot.MPC_BODIES[body]),
                      body)


def probe_k4(dev, card):
    """B4 at k4's cold config-4 segment and at the last B4 launch of one
    config-4 solve."""
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    d4 = cs.config4()
    args = [torch.as_tensor(d4[k], device=dev)
            for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    segs = cs.prox_main_path_segments(args, st)
    cases = (("cold", *cs.prox_cold_segment(args, st)),
             (f"last of {len(segs)}", *segs[-1]))
    for name, s, carry, ops_ in cases:
        probe_segment("k4", "prox_segment.cu", "prox_segment_f32",
                      lambda: slot.run_prox_segment(
                          s, *carry, *ops_, st, cs.N, P=pbatch.PSEG,
                          steps=pbatch.PROX_STEPS),
                      f"{name} (live lanes {int((carry[1] > 0).sum())})",
                      cs.B4, card, "prox_segment",
                      (cs.M_ROWS, cs.N, cs.N + 1))


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


def ptxas_entries(log, kernel):
    """Registers and spill bytes of every __global__ function of ptxas's
    -v output ``log`` whose name holds ``<kernel>_kernel`` (a template's
    instantiations one by one): [{entry, registers, spill_stores,
    spill_loads}]."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append(dict(entry=m.group(1)))
            continue
        if not out or f"{kernel}_kernel" not in out[-1]["entry"]:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return [e for e in out if f"{kernel}_kernel" in e["entry"]]


def unit_fields(words, units):
    """The slowest unit (K1 block, B9 warp) against the mean and the
    units' spread over SMs and the global timer, from the probe's per-unit
    words (the first min(units, CHOL_UNITS))."""
    nu = min(units, CHOL_UNITS)
    w = np.asarray(words[:nu * UNIT_WORDS], dtype=np.float64).reshape(
        nu, UNIT_WORDS)
    cyc, sm, start, end = w.T
    slow = int(np.argmax(cyc))
    per_sm = np.bincount(sm.astype(np.int64))
    return dict(
        unit_cycles_mean=float(cyc.mean()),
        unit_cycles_median=float(np.median(cyc)),
        slowest=dict(unit=slow, cycles=float(cyc[slow]),
                     over_mean=float(cyc[slow] / cyc.mean()),
                     sm=int(sm[slow])),
        sms_used=int((per_sm > 0).sum()), units_per_sm_max=int(per_sm.max()),
        start_spread_us=float(start.max() - start.min()) / 1e3,
        launch_span_us=float(end.max() - start.min()) / 1e3,
        slowest_unit_us=float(end[slow] - start[slow]) / 1e3)


def chol_shape(B, n, dev):
    """(matrices a block, warps a matrix) that the wrappers of K1 and B9
    pick."""
    return chol.warp_shape(B, n, smem.available(dev), smem.sms(dev))


def probe_chol(case, dev, card):
    """K1 (``k1``: at B = 10240 and at config 4's retry shape B = 256 of
    config 2's Hessians, n = 50, and on the flat grid's batches at n = 100
    and 200, B = 64 and 16) or B9 (``k9``: at B = 10240): SM cycles
    per unit (K1 block, B9 warp) of the load, phase 1, phase 2 and the
    store, the slowest unit, resident blocks per SM and waves, registers,
    spills and both times; for B9 also the normal kernel against one built
    at ptxas's default register usage level, timed in turns."""
    kernel = "chol_rinv" if case == "k1" else "chol_dense"
    wrapper = chol.chol_rinv if case == "k1" else chol.chol_rinv_dense
    entry = f"{kernel}_f32"
    variants = {"probe": [*_build.NVCC_FLAGS, "-DCHOL_PROBE"],
                "occupancy": [*_build.NVCC_FLAGS, "-DCHOL_OCCUPANCY"]}
    if case == "k9":
        # the normal flags less ptxas's register usage level (its default)
        i = _build.NVCC_FLAGS.index("--register-usage-level=0")
        default = _build.NVCC_FLAGS[:i - 1] + _build.NVCC_FLAGS[i + 1:]
        variants["level_default"] = default
    libs = build_alone(case, f"{kernel}.cu", variants)
    for lib, _ in libs.values():
        if hasattr(lib, entry):
            bind(lib, entry)
    lib, log = libs["probe"]
    for fn in (lib.chol_probe_read, lib.chol_probe_reset):
        fn.restype = ctypes.c_int
    lib.chol_probe_read.argtypes = [ctypes.c_void_p]
    occ = getattr(libs["occupancy"][0], f"{kernel}_occupancy")
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    nlog = _build.BUILD_DIR / "nvcc.log"
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d = gen.generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT,
                                   cs.KAPPA, rng=cs.SEED, dtype=np.float32)
    H = torch.as_tensor(d['H'], device=dev)
    cases = [H]
    if case == "k1":
        # config 4's retry shape, then the flat grid's batches that K1
        # factors (n = 100, B = 64; n = 200, B = 16)
        cases += [H[:cs.B4].contiguous()] + [
            cs.grid_batch(gen, *g)[1][0] for g in cs.FLAT_GRID[:2]]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for Hc in cases:
        B, n = Hc.shape[0], Hc.shape[1]
        probed = swapped(lib, lambda: wrapper(Hc))
        probed()                                        # warm-up
        torch.cuda.synchronize()
        _build.check(lib.chol_probe_reset(), "chol_probe_reset")
        probed()
        torch.cuda.synchronize()
        words = (ctypes.c_ulonglong * (len(CHOL_PHASES) + 1
                                       + CHOL_UNITS * UNIT_WORDS))()
        _build.check(lib.chol_probe_read(ctypes.addressof(words)),
                     "chol_probe_read")
        units = words[len(CHOL_PHASES)]
        per_unit = {ph: words[i] / max(units, 1)
                    for i, ph in enumerate(CHOL_PHASES)}
        total = sum(per_unit.values())
        per_block, P = chol_shape(B, n, dev)
        resident = ctypes.c_int(0)
        _build.check(occ(n, per_block, P, ctypes.addressof(resident)),
                     f"{kernel}_occupancy")
        blocks = -(-B // per_block)
        print(json.dumps({
            "probe": case, "B": B, "n": n, "units": units,
            "matrices_per_block": per_block, "warps_per_matrix": P,
            "blocks": blocks,
            "cycles_per_unit": per_unit, "cycles_per_unit_total": total,
            "share": {ph: v / max(total, 1) for ph, v in per_unit.items()},
            **unit_fields(words[len(CHOL_PHASES) + 1:], units),
            "resident_blocks_per_sm": resident.value, "sms": sms,
            "waves": blocks / (resident.value * sms) if resident.value
            else None,
            "ptxas": ptxas_entries(nlog.read_text() if nlog.exists() else "",
                                   kernel),
            "ptxas_probe": ptxas_entries(log, kernel),
            "ms_probe": cs.cuda_ms(probed, 5),
            "ms_kernel": cs.cuda_ms(lambda: wrapper(Hc), 20),
            "card": card}), flush=True)
    if case == "k9":
        dlib, dlog = libs["level_default"]
        t = cs.in_turns(lambda: wrapper(H), swapped(dlib, lambda: wrapper(H)),
                        20)
        so = BUILD / f"probe_{case}" / f"lib{case}_level_default.so"
        print(json.dumps({
            "probe": case, "register_usage_level": {
                "level0_ms": t["first"], "default_ms": t["second"],
                "level0_ptxas": ptxas_entries(
                    nlog.read_text() if nlog.exists() else "", kernel),
                "default_ptxas": ptxas_entries(dlog, kernel),
                "default_sass": {k: v for k, v in sass_sizes(so).items()
                                 if k.startswith(kernel)},
                "default_flags": default}, "card": card}), flush=True)


def one_call_ms(fn):
    """Device time of one call of ``fn`` in ms, bracketed by CUDA events
    behind a short spin kernel (~1 ms), so that the host's enqueue does
    not show."""
    torch.cuda.synchronize()
    torch.cuda._sleep(TAIL_SPIN)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def quantiles(v):
    v = np.asarray(v, dtype=np.float64)
    return dict(min=float(v.min()), p10=float(np.quantile(v, 0.1)),
                median=float(np.median(v)), p90=float(np.quantile(v, 0.9)),
                max=float(v.max()), mean=float(v.mean()))


def tail_repeat(dev, card, reps):
    """B5's tail launch (the last B5 launch of one configAVI solve: one
    live lane) ``reps`` times in turns on the normal library (its event
    time) and on the probe's (its event time, and the live block's SM
    cycles and global-timer span, whose ratio is the SM clock it ran
    at).  Prints the distributions and, for the calls slower than 1.05x
    the median, each one's numbers; every call's go to
    ``chiprun_out/tail_repeat.json``."""
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d = cs.config_avi(gen)
    args = [torch.as_tensor(d[k], device=dev)
            for k in ('H', 'f', 'A', 'bupper', 'blower', 'sense')]
    a = pbatch.avi_init(*args, st)
    ops_ = pbatch.avi_segment_operands(a)
    s, carry = cs.main_path_segments(args, st)[-1]
    B = carry[0].shape[0]

    def launch():
        return slot.run_avi_segment(s, *carry, *ops_, st, cs.N_AVI,
                                    P=pbatch.PSEG, steps=pbatch.AVI_STEPS)

    lib, _, _ = probe_library("k5", "avi_segment.cu", "avi_segment_f32")
    for fn in (lib.seg_probe_read, lib.seg_probe_reset):
        fn.restype = ctypes.c_int
    lib.seg_probe_read.argtypes = [ctypes.c_void_p]
    probed = swapped(lib, launch)
    launch()
    probed()
    nstep, nseg = len(PROBE_PHASES) + 1, len(SEG_PHASES) + 2
    words = seg_probe_words()
    calls = []
    for _ in range(reps):
        ms = one_call_ms(launch)
        _build.check(lib.seg_probe_reset(), "seg_probe_reset")
        ms_probe = one_call_ms(probed)
        _build.check(lib.seg_probe_read(ctypes.addressof(words)),
                     "seg_probe_read")
        w = np.asarray(words[nstep + nseg:nstep + nseg + B * BLOCK_WORDS],
                       dtype=np.float64).reshape(B, BLOCK_WORDS)
        live = int(np.argmax(w[:, 0]))
        span = w[live, 4] - w[live, 3]
        calls.append(dict(ms=ms, ms_probe=ms_probe, lane=live,
                          cycles=w[live, 0], steps=w[live, 1],
                          sm=int(w[live, 2]), span_us=span / 1e3,
                          mhz=1e3 * w[live, 0] / span if span else None,
                          launch_span_us=float(w[:, 4].max()
                                               - w[:, 3].min()) / 1e3))
    med = float(np.median([c["ms"] for c in calls]))
    med_p = float(np.median([c["ms_probe"] for c in calls]))
    OUT.mkdir(exist_ok=True)
    (OUT / "tail_repeat.json").write_text(json.dumps(calls))
    print(json.dumps({
        "tail_repeat": reps, "B": B,
        "live_lanes": int((carry[6] > 0).sum()),
        "ms": quantiles([c["ms"] for c in calls]),
        "ms_probe": quantiles([c["ms_probe"] for c in calls]),
        "cycles": quantiles([c["cycles"] for c in calls]),
        "span_us": quantiles([c["span_us"] for c in calls]),
        "mhz": quantiles([c["mhz"] for c in calls]),
        "steps": sorted({c["steps"] for c in calls}),
        "sms": sorted({c["sm"] for c in calls}),
        "slow": [dict(i=i, **c) for i, c in enumerate(calls)
                 if c["ms"] > 1.05 * med or c["ms_probe"] > 1.05 * med_p],
        "card": card}), flush=True)


# k3's second width (--k3-wide): S, n, m and the rows active at the
# optimum of config 3's generator
K3_WIDE = (64, 80, 160, 64)


def refreshed(fn):
    """``fn`` (B3's wrapper or its twin) run one horizon step a launch,
    each after a Newton refresh of E: the segment's outputs stacked as
    one launch gives them, ``failed`` the lanes that ended any step in
    trouble (a lane that failed runs its later steps too)."""
    def run(s, duq, dlq, st, n, steps):
        outs = []
        for p in range(duq.shape[1]):
            s, *o = fn(slot.newton_refresh(s), duq[:, p:p + 1].contiguous(),
                       dlq[:, p:p + 1].contiguous(), st, n, steps=steps)
            outs.append(o)
        u, fv, it, stt, failed = zip(*outs)
        return (s, torch.cat(u, 1), torch.cat(fv, 1), torch.cat(it, 1),
                torch.cat(stt, 1), torch.stack(failed).amax(0))
    return run


def k3_wide(dev, card, seeds, refresh=False):
    """k3's case at config 3's width and at K3_WIDE for each data seed,
    kernel and f32 twin against the twin in f64 (module docstring); with
    ``refresh``, every side one horizon step a launch after a Newton
    refresh of E."""
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    kernel_fn, twin_fn = slot.run_mpc_segment, slot.run_mpc_segment_plain
    if refresh:
        kernel_fn, twin_fn = refreshed(kernel_fn), refreshed(twin_fn)

    def rate(a, b):
        return ((a[4] == b[4]).all(1) & (a[5] == b[5])).float().mean().item()

    for seed in seeds:
        for S, n, m, nact in ((cs.S3, cs.N, cs.M_ROWS, 40), K3_WIDE):
            d = cs.config3(gen, S, n, m, nact, seed)
            args = [torch.as_tensor(d[k], device=dev)
                    for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
            s1, duq, dlq = cs.mpc_warm_segment(args, st)
            K = s1.E.shape[1]
            kern = kernel_fn(s1, duq, dlq, st, n, steps=cs.STEPS)
            twin = twin_fn(s1, duq, dlq, st, n, steps=cs.STEPS)
            s64 = type(s1)(*(v.double() if v.is_floating_point() else v
                             for v in s1))
            ref = twin_fn(s64, duq.double(), dlq.double(), st, n,
                          steps=cs.STEPS)
            all3 = ((kern[4] == ref[4]).all(1) & (twin[4] == ref[4]).all(1)
                    & (ref[4] == dt.EXIT_OPTIMAL).all(1))

            def du(x):
                return cs.gmax((x[1].double() - ref[1]).abs().amax((1, 2))[
                    all3].cpu().numpy())
            print(json.dumps({
                "k3_wide": seed, "refresh": refresh, "S": S, "n": n,
                "m": m, "K": K,
                "body": cs.BLOCK_BODY,
                "kernel_vs_twin": rate(kern, twin),
                "kernel_vs_f64": rate(kern, ref),
                "twin_vs_f64": rate(twin, ref),
                "all_three_optimal": int(all3.sum()),
                "kernel_du_vs_f64": du(kern), "twin_du_vs_f64": du(twin),
                "failed": [int((x[5] > 0).sum()) for x in (kern, twin, ref)],
                "out_digest": cs.digest(*kern[0], *kern[1:]),
                "card": card}), flush=True)


def main():
    if sys.argv[1:2] == ["--k3-wide"]:
        seeds = [int(v) for v in sys.argv[2:] if not v.startswith("--")]
        refresh = "--refresh" in sys.argv
    if sys.argv[1:2] == ["--k3-wide"] and "--cpu" in sys.argv:
        k3_wide(torch.device("cpu"), "cpu", seeds, refresh)
        return 0
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    probes = {"k2": probe_k2, "k3": probe_k3, "k4": probe_k4,
              "k5": probe_k5, "k6": probe_k6,
              "k1": lambda dev, card: probe_chol("k1", dev, card),
              "k9": lambda dev, card: probe_chol("k9", dev, card)}
    if sys.argv[1:2] == ["--probe"] and sys.argv[2:] \
            and set(sys.argv[2:]) <= set(probes):
        for case in sys.argv[2:]:
            probes[case](dev, card)
        print_sass(card)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--sass"]:
        print_sass(card)
        print(card, flush=True)
        return 0
    if sys.argv[1:2] == ["--k3-wide"]:
        k3_wide(dev, card, seeds, refresh)
        print(card, flush=True)
        return 0
    if sys.argv[1:2] == ["--tail"]:
        tail_repeat(dev, card, int(sys.argv[2]))
        print(card, flush=True)
        return 0
    if "--cells" in sys.argv:
        global CELLS
        CELLS = set(sys.argv[sys.argv.index("--cells") + 1:])
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    d5 = cs.config5()
    args5 = [torch.as_tensor(d5[k], device=dev) for k in (
        'H', 'f', 'A', 'bupper', 'blower', 'sense')]
    profiled("config5", lambda: dt.solve_batch_miqp_kernel(*args5, st),
             card)
    keys = ('H', 'f', 'A', 'bupper', 'blower', 'sense')

    d = gen.generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT,
                                   cs.KAPPA, rng=cs.SEED, dtype=np.float32)
    full = [torch.as_tensor(d[k], device=dev) for k in keys]
    head = [a[:cs.FLAT_LANES] for a in full]
    profiled("flat", lambda: pbatch.solve_batch_flat_jit(*head, st), card)
    n, m, ms, nact, Bn = cs.FLAT_GRID[0]
    _, grid = cs.grid_batch(gen, n, m, ms, nact, Bn)
    profiled("flat_grid100", lambda: dt.solve_batch(*grid, ms=ms), card)
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

    # the backstop on chip_smoke.py's forced failures of the first 256
    # lanes (each re-solved lane takes ~0.2 s of host-driven loop on the
    # card)
    full = [torch.as_tensor(d[k][:cs.B_BACK], device=dev) for k in keys]
    failed, _ = cs.force_failures(dt.solve_batch_kernel_stream(
        *full, st=st, chunk=256))
    profiled("backstop", lambda: dt.backstop_resolve(failed, *full, ms=0),
             card)
    probs = cs.config1(gen)[:16]
    for dtype, st1 in ((torch.float64, None),
                       (torch.float32, dt.default_settings_f32())):
        profiled(f"config1_{str(dtype)[6:]}", lambda: [
            dt.quadprog(H, f, A, bu, bl, sense, ms=cs.MS1, dtype=dtype,
                        settings=st1, device="cuda")
            for _, H, f, A, bu, bl, sense in probs], card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
