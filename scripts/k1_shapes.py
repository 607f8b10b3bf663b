#!/usr/bin/env python3
"""K1's launch shapes and the factorization route, measured on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/k1_shapes.py                 # every shape, bits and ms
    python3 scripts/k1_shapes.py --probe         # + SM cycles a phase, each P
    python3 scripts/k1_shapes.py --route         # K1, B10, library in turns
    python3 scripts/k1_shapes.py --parent DIR    # K1 against DIR's K1
    python3 scripts/k1_shapes.py --b3 DIR        # B3 built from DIR's sources

Default: at the flat grid's two K1 batches (``chip_smoke.grid_batch``:
n = 100, B = 64; n = 200, B = 16), config 2's first 256 and 1024 Hessians
and A A' + n I at n = 50-256, B = 16-1024, K1 through its C entry at one
warp a matrix (``chol.warp_tile`` matrices a block) and at each P of
``chol.WARP_P`` warps a matrix, each bit for bit the first, with B10 and
the library (``cholesky_ex`` + ``solve_triangular``) beside, the best of
two rounds of 10 calls each (CUDA events, ``chip_smoke.cuda_ms``).
``--probe`` also builds K1 with ``-DCHOL_PROBE`` (``chol_probe.cuh``) and
prints the SM cycles a matrix of the load, phase 1, phase 2 and the store
at each P on the first three shapes.  ``--route``: K1 (at
``chol.warp_shape``'s pick), B10 and the library timed in turns, three
rounds, at n = 100-256, B = 16-1024, and which of them leads in every
pairing (``chol.factor_route``'s measurement).  ``--parent DIR``: K1 of
this tree against the K1 built from DIR (a ``git archive`` of another
commit, its own ``_build.py``), both at their own wrappers' shapes
(``--parent-shape`` overrides the parent's, default (1, 4) for a batch
of at most 1320 and (8, 1) past it), in turns with B10 and the library,
on the grid's batches and config 2's first 256 and all 10240 Hessians:
Rinv bit for bit, and the SASS of both libraries.  ``--b3 DIR``: on
``chip_smoke``'s k3 segment, in turns, three rounds: B3 built from this
tree's ``csrc`` with DIR's files laid over it (a parent's ``csrc``; its C
entry with or without the body argument), and this tree's horizon and
128-thread bodies; every output's digest and the parent's registers and
spills.  To time a variant of the horizon body, lay its files over a
copy of this tree's ``csrc`` and pass that as DIR.
Each line is one JSON object; the last names the card.
"""
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_profile as cp  # noqa: E402
import chip_smoke as cs  # noqa: E402
import daqp_tpu_torch as dt  # noqa: E402
from daqp_tpu_torch.ops import _build, chol, slot, smem  # noqa: E402

SWEEP = [(B, n) for n in (64, 80, 100, 150, 200, 256)
         for B in (16, 64, 256, 1024)] + [(128, 20), (256, 240), (512, 50),
                                          (64, 50), (16, 50)]
ROUTE = [(B, n) for n in (100, 128, 150, 176, 200, 224, 256)
         for B in (16, 64, 256, 1024)]


def launch(lib, H, per_block, P, out):
    _build.check(lib.chol_rinv_f32(
        H.data_ptr(), out.data_ptr(), H.shape[0], H.shape[1], per_block, P,
        chol.TINY, torch.cuda.current_stream().cuda_stream), "chol_rinv_f32")
    return out


def cases(dev, gen):
    """(name, H): the grid's batches, config 2's first 256 and 1024
    Hessians, then SWEEP's A A' + n I."""
    d = gen.generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT,
                                   cs.KAPPA, rng=cs.SEED, dtype=np.float32)
    H2 = torch.as_tensor(d['H'], device=dev)
    out = [(f"grid{g[4]}x{g[0]}", cs.grid_batch(gen, *g)[1][0])
           for g in cs.FLAT_GRID[:2]]
    out += [(f"config2_{b}", H2[:b].contiguous()) for b in (256, 1024)]
    return out + [(f"spd{B}x{n}", cs.spd_batch(B, n, 7 + n, dev))
                  for B, n in SWEEP]


def sweep(dev, gen, probe):
    lib = _build.library()
    limit, n_sm = smem.available(dev), smem.sms(dev)
    shapes = cases(dev, gen)
    for name, H in shapes:
        B, n = H.shape[0], H.shape[1]
        w = chol.warp_tile(B, n, limit, n_sm)
        R1 = launch(lib, H, w, 1, torch.empty_like(H))
        fns = {"p1": lambda: launch(lib, H, w, 1, R1)}
        equal = {}
        for P in chol.WARP_P:
            RP = launch(lib, H, 1, P, torch.empty_like(H))
            equal[P] = torch.equal(RP, R1)
            fns[f"p{P}"] = (lambda P=P, RP=RP: launch(lib, H, 1, P, RP))
        fns["b10"] = lambda: chol.chol_rinv_blk(H)
        fns["library"] = lambda: cs.library_rinv(H)
        ms = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                ms[k].append(cs.cuda_ms(fns[k], 10))
        print(json.dumps(dict(case=name, B=B, n=n, tile=w, equal=equal,
                              ms={k: min(v) for k, v in ms.items()})),
              flush=True)
    if not probe:
        return
    plib, log = cp.build_alone("k1_shapes", "chol_rinv.cu", {
        "probe": [*_build.NVCC_FLAGS, "-DCHOL_PROBE"]})["probe"]
    cp.bind(plib, "chol_rinv_f32")
    for fn in (plib.chol_probe_read, plib.chol_probe_reset):
        fn.restype = ctypes.c_int
    plib.chol_probe_read.argtypes = [ctypes.c_void_p]
    nw = len(cp.CHOL_PHASES) + 1 + cp.CHOL_UNITS * cp.UNIT_WORDS
    for name, H in shapes[:3]:
        for P in chol.WARP_P:
            R = torch.empty_like(H)
            launch(plib, H, 1, P, R)
            torch.cuda.synchronize()
            _build.check(plib.chol_probe_reset(), "chol_probe_reset")
            launch(plib, H, 1, P, R)
            torch.cuda.synchronize()
            words = (ctypes.c_ulonglong * nw)()
            _build.check(plib.chol_probe_read(ctypes.addressof(words)),
                         "chol_probe_read")
            units = max(words[len(cp.CHOL_PHASES)], 1)
            print(json.dumps(dict(probe=name, P=P, cycles={
                ph: words[i] / units for i, ph in enumerate(cp.CHOL_PHASES)},
                ptxas=cp.ptxas_entries(log, "chol_rinv"))), flush=True)


def route(dev):
    limit, n_sm = smem.available(dev), smem.sms(dev)
    for B, n in ROUTE:
        H = cs.spd_batch(B, n, 7 + n, dev)
        t = cs.turns({"library": lambda: cs.library_rinv(H),
                      "k1": lambda: chol.chol_rinv(H),
                      "b10": lambda: chol.chol_rinv_blk(H)}, 20, rounds=3)
        print(json.dumps(dict(
            B=B, n=n, pick=chol.warp_shape(B, n, limit, n_sm),
            route=chol.factor_route(n, limit),
            **{k: [min(v), max(v)] for k, v in t.items()},
            b10_every=max(t["b10"]) < min(t["k1"]),
            k1_every=max(t["k1"]) < min(t["b10"]),
            library_beats_k1=max(t["library"]) < min(t["k1"]))),
            flush=True)
        del H


def parent(dev, gen, tree, shape):
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(tree) / "daqp_tpu_torch" / "ops" / "_build.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    plib, lib = pb.library(), _build.library()
    sp, sc = cp.sass_sizes(plib._name), cp.sass_sizes(lib._name)
    print(json.dumps({
        "sass_parent": {k: v["sha"] for k, v in sp.items()},
        "sass": {k: v["sha"] for k, v in sc.items()},
        "differ": sorted(k for k in sp if k in sc and sp[k] != sc[k])}),
        flush=True)
    d = gen.generate_test_qp_batch(cs.B, cs.N, cs.M_ROWS, 0, cs.N_ACT,
                                   cs.KAPPA, rng=cs.SEED, dtype=np.float32)
    H2 = torch.as_tensor(d['H'], device=dev)
    for name, H in [(f"grid{g[4]}x{g[0]}", cs.grid_batch(gen, *g)[1][0])
                    for g in cs.FLAT_GRID[:2]] + [
            ("config4_256", H2[:cs.B4].contiguous()), ("config2", H2)]:
        pshape = shape or ((1, 4) if H.shape[0] <= 1320 else (8, 1))
        Rp = torch.empty_like(H)
        Rk = chol.chol_rinv(H)
        t = cs.turns({"parent": lambda: launch(plib, H, *pshape, Rp),
                      "change": lambda: chol.chol_rinv(H),
                      "b10": lambda: chol.chol_rinv_blk(H),
                      "library": lambda: cs.library_rinv(H)}, 20, rounds=3)
        print(json.dumps(dict(
            case=name, B=H.shape[0], n=H.shape[1], parent_shape=pshape,
            shape=chol.warp_shape(H.shape[0], H.shape[1],
                                  smem.available(dev), smem.sms(dev)),
            equal_parent=torch.equal(Rk, Rp), ms=t,
            beats_parent_every=max(t["change"]) < min(t["parent"]),
            beats_library_every=max(t["change"]) < min(t["library"]),
            beats_b10_every=max(t["change"]) < min(t["b10"]))), flush=True)


class _NoBody:
    """A B3 library whose C entry takes no body argument (before the
    horizon body), called as this tree's wrapper calls it."""

    def __init__(self, lib):
        self.lib = lib

    def mpc_segment_f32(self, *args):
        return self.lib.mpc_segment_f32(*args[:-2], args[-1])


def b3_build(tree):
    """B3 (``mpc_segment.cu``) built alone from a copy of this tree's
    ``csrc`` under ``build/b3_parent``, with the ``.cu`` / ``.cuh`` files of
    ``tree`` laid over it: (the library's path, nvcc's output)."""
    src = cp.BUILD / "b3_parent" / "csrc"
    shutil.copytree(_build._CSRC, src, dirs_exist_ok=True)
    for f in Path(tree).iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, src / f.name)
    so = src.parent / "libb3.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(src / "mpc_segment.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError("nvcc failed:\n" + (out.stdout + out.stderr)[-4000:])
    return so, out.stdout + out.stderr


def b3(dev, gen, tree):
    st = dt.as_settings({"iter_limit": 1000}, torch.float32)
    d3 = cs.config3(gen)
    args = [torch.as_tensor(d3[k], device=dev)
            for k in ('H', 'A', 'f_seq', 'bu_seq', 'bl_seq')]
    s1, duq, dlq = cs.mpc_warm_segment(args, st)

    def run(body=None):
        return lambda: slot.run_mpc_segment(s1, duq, dlq, st, cs.N,
                                            steps=cs.STEPS, body=body)
    so, log = b3_build(tree)
    lib = ctypes.CDLL(str(so))
    cp.bind(lib, "mpc_segment_f32")
    if "int bland, int body" not in (so.parent / "csrc" /
                                     "mpc_segment.cu").read_text():
        lib.mpc_segment_f32.argtypes = [
            a for i, a in enumerate(_build._SIGNATURES["mpc_segment_f32"])
            if i != 15]
        lib = _NoBody(lib)
    fns = {"parent": cp.swapped(lib, run()), "horizon": run("horizon"),
           "block": run("block")}
    digests = {}
    for name, fn in fns.items():
        o = fn()
        digests[name] = cs.digest(*o[0], *o[1:])
    t = cs.turns(fns, cs.SEG_REPS, rounds=3)
    print(json.dumps(dict(
        case="b3", ms=t, digests=digests,
        all_equal=len(set(digests.values())) == 1,
        beats_parent_every={k: max(v) < min(t["parent"])
                            for k, v in t.items() if k != "parent"},
        ptxas_parent=cp.ptxas(log, "mpc_segment"))), flush=True)


def main():
    if not torch.cuda.is_available():
        print("k1_shapes: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = cs.load("daqp_test_gen", "tests/gen.py")
    args = sys.argv[1:]
    if "--parent" in args:
        shape = None
        if "--parent-shape" in args:
            i = args.index("--parent-shape")
            shape = (int(args[i + 1]), int(args[i + 2]))
        parent(dev, gen, args[args.index("--parent") + 1], shape)
    elif "--b3" in args:
        b3(dev, gen, args[args.index("--b3") + 1])
    elif "--route" in args:
        route(dev)
    else:
        sweep(dev, gen, "--probe" in args)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
