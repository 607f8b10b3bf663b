"""K1, B8, B9 and B10 (daqp_tpu_torch.ops.chol): each plain twin against the
JAX kernel it replaces (Pallas interpret mode) and the f64 inverse; the
XLA-only formulations against their JAX functions; the shared-memory
formulas at the edges of an H100 block; the CPU route of each wrapper;
and the factorization stage end to end: config-2-like batches solved on
each twin's factor against the JAX package's solve."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daqp_tpu import batch as batch_mod
from daqp_tpu.api import _as_settings
from daqp_tpu.ops import chol
import daqp_tpu_torch as dt
from daqp_tpu_torch import batch as pbatch
from daqp_tpu_torch.ops import chol as pchol, smem
from tests.gen import generate_test_qp_batch

H100_SMEM = 232448          # bytes one block may opt in to on an H100

JAX_KERNELS = {
    "B8": (lambda h: chol.batched_chol_rinv_pallas(h, interpret=True),
           pchol.chol_rinv_lanes_plain),
    "B9": (lambda h: chol.batched_chol_rinv_dense(h, interpret=True),
           pchol.chol_rinv_dense_plain),
    "B10": (lambda h: chol.batched_chol_rinv_blk(h, interpret=True),
            pchol.chol_rinv_blk_plain),
}


def _spd_batch(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    return np.einsum('bij,bkj->bik', A, A) + np.eye(n)


def _f64_rinv(H):
    return np.stack([np.linalg.inv(np.linalg.cholesky(
        h.astype(np.float64)).T) for h in H])


# The twins run their TPU kernel's per-element arithmetic; only sums are
# taken in another order (and XLA may fuse a multiply-add).  f64 leaves
# ~1e-14 relative, f32 ~1e-6; the gates are test_torch_chol.py's.
# B10 at n = 13 and 20 has a ragged last panel, at 16 an exact one.
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-4)])
@pytest.mark.parametrize("kernel,n", [("B8", 12), ("B8", 13), ("B9", 12),
                                      ("B9", 13), ("B10", 13), ("B10", 16),
                                      ("B10", 20)])
def test_twin_matches_jax_kernel(kernel, n, dtype, rtol):
    jax_fn, twin = JAX_KERNELS[kernel]
    H = _spd_batch(128, n, seed=n).astype(dtype)
    Rj = np.asarray(jax.jit(jax_fn)(jnp.asarray(H)))
    Rp = twin(torch.as_tensor(H)).numpy()
    assert Rp.dtype == dtype
    assert np.abs(np.tril(Rp, -1)).max() == 0.0          # upper triangular
    assert np.abs(Rp - Rj).max() <= rtol * np.abs(Rj).max()
    # and the f64 inverse, as tests/test_chol_ops.py:26-33 holds B8
    assert np.abs(Rp - _f64_rinv(H)).max() < 1e-4


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-4)])
def test_blk_twin_at_n100(dtype, rtol):
    # thirteen panels, the last of 4 columns; no JAX needed
    H = _spd_batch(4, 100, seed=100).astype(dtype)
    R = pchol.chol_rinv_blk_plain(torch.as_tensor(H)).numpy()
    ref = _f64_rinv(H)
    assert np.abs(R - ref).max() <= rtol * np.abs(ref).max()


# B10's premise: every element takes its terms in the same ascending
# order at any panel width, so the twin at pb = 16, 32, 64 (the kernel's
# 32 and 64 among them) is bit for bit the twin at pb = 8, the JAX
# kernel's order; n = 20 and 50 end on ragged panels at every width.
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [20, 50, 100])
def test_blk_twin_order_does_not_depend_on_panel_width(n, dtype):
    H = torch.as_tensor(_spd_batch(3, n, seed=n + 1).astype(dtype))
    R8 = pchol.chol_rinv_blk_plain(H)
    for pb in (16, 32, 64):
        assert torch.equal(pchol.chol_rinv_blk_plain(H, pb=pb), R8), pb


# The XLA formulations in f64 (conftest enables x64): the same products
# and steps on both sides, so rounding-level agreement; Newton-Schulz's
# 14 coupled products amplify it a little.
@pytest.mark.parametrize("name,B,n,rtol", [
    ("batched_chol_rinv", 4, 10, 1e-10),
    ("batched_invsqrt", 8, 16, 1e-8),
    ("batched_chol_rinv_mxu", 16, 13, 1e-10)])
def test_xla_formulations_match_jax(name, B, n, rtol):
    H = _spd_batch(B, n, seed=B + n)
    Rj = np.asarray(jax.jit(getattr(chol, name))(jnp.asarray(H)))
    Rp = getattr(pchol, name)(torch.as_tensor(H)).numpy()
    assert np.abs(Rp - Rj).max() <= rtol * np.abs(Rj).max()
    if name != "batched_invsqrt":
        assert np.abs(Rp - _f64_rinv(H)).max() <= 1e-10


# Each kernel's shared memory per block (the allocators of csrc/) against
# an H100's 232,448 bytes: K1 and B9 (one body) fit every block their
# wrappers pick: one matrix at n = 256 (their column limit; n = 257
# raises before any block is sized), 8 warps up to n = 53, 4 up to 73 and
# 2 up to 98 (their 48 KB tiles, test_warp_tile_fits_...); K2 fits config 2
# (n = 50, m = 100, K = 51) and at n = 50 up to m = 893, not 894, nor
# BASELINE "medium" (n = 100, m = 500, ~306 KB); B7 at n = 50 fits
# m = 209, not 210, and its SOFT_WEIGHTS variant m = 205, not 206.
# B8 fits n = 333 at one lane, not 334, at 8 lanes (the wrapper's tile
# at n = 50) n = 116, not 117, and at 32 lanes n = 56, not 57; B10 n =
# 1581 (n = 1000 is twice BASELINE's largest), not 1582.  B5 (K = n + 1)
# at n = 50 fits m = 645, not 646, and at m = 100 n = 81, not 82; B6 at
# n = 50 fits m = 832, not 833, and at m = 100 n = 139, not 140; B4 at
# n = 50 fits m = 817, not 818, and at m = 100 n = 117, not 118.  B5 at
# n = 20 (configAVI) fits m = 1817, not 1818, and at n = 31 m = 1258, not
# 1259.  B6 runs its warp body up to K = 32 (n = 31; K = 33 takes the
# 128-thread one) where that block fits, at n = 10 (configLP) up to m =
# 2608 and at n = 31 up to m = 1311; past them the 128-thread body fits
# m = 2609-2616 at n = 10, not 2617, and 1312-1314 at n = 31, not 1315.
# B5 runs its warp body at the same switch (K = 32, n = 31, its warp
# body; K = 33 its 128-thread one), at n = 20 (configAVI) up to m = 1812
# and at n = 31 up to 1255; past them its 128-thread body fits m =
# 1813-1817 at n = 20 and 1256-1258 at n = 31.
@pytest.mark.parametrize("kernel,floats,fits", [
    ("B5", smem.avi_floats(50, 20, 21), True),
    ("B5", smem.avi_floats(1812, 20, 21), True),
    ("B5", smem.avi_floats(1255, 31, 32), True),
    ("B5", smem.avi_floats(1256, 31, 32), True),
    ("B5", smem.avi_floats(100, 31, 32), True),
    ("B5", smem.avi_floats(100, 32, 33), True),
    ("B4", smem.prox_floats(817, 50, 51), True),
    ("B4", smem.prox_floats(818, 50, 51), False),
    ("B4", smem.prox_floats(100, 117, 118), True),
    ("B4", smem.prox_floats(100, 118, 119), False),
    ("B5", smem.avi_floats(645, 50, 51), True),
    ("B5", smem.avi_floats(646, 50, 51), False),
    ("B5", smem.avi_floats(100, 81, 82), True),
    ("B5", smem.avi_floats(100, 82, 83), False),
    ("B6", smem.lp_floats(832, 50, 51), True),
    ("B6", smem.lp_floats(833, 50, 51), False),
    ("B6", smem.lp_floats(100, 139, 140), True),
    ("B6", smem.lp_floats(100, 140, 141), False),
    ("B5", smem.avi_floats(1813, 20, 21), True),
    ("B5", smem.avi_floats(1817, 20, 21), True),
    ("B5", smem.avi_floats(1818, 20, 21), False),
    ("B5", smem.avi_floats(1258, 31, 32), True),
    ("B5", smem.avi_floats(1259, 31, 32), False),
    ("B6", smem.lp_floats(100, 31, 32), True),
    ("B6", smem.lp_floats(100, 32, 33), True),
    ("B6", smem.lp_floats(2608, 10, 11), True),
    ("B6", smem.lp_floats(2609, 10, 11), True),
    ("B6", smem.lp_floats(2616, 10, 11), True),
    ("B6", smem.lp_floats(2617, 10, 11), False),
    ("B6", smem.lp_floats(1311, 31, 32), True),
    ("B6", smem.lp_floats(1312, 31, 32), True),
    ("B6", smem.lp_floats(1314, 31, 32), True),
    ("B6", smem.lp_floats(1315, 31, 32), False),
    ("B8", smem.chol_lanes_floats(333, 1), True),
    ("B8", smem.chol_lanes_floats(334, 1), False),
    ("B8", smem.chol_lanes_floats(116, 8), True),
    ("B8", smem.chol_lanes_floats(117, 8), False),
    ("B8", smem.chol_lanes_floats(56, 32), True),
    ("B8", smem.chol_lanes_floats(57, 32), False),
    ("B10", smem.chol_blk_floats(1000), True),
    ("B10", smem.chol_blk_floats(1581), True),
    ("B10", smem.chol_blk_floats(1582), False),
    ("K1", smem.chol_warp_floats(256, 1), True),
    ("K1", smem.chol_warp_floats(53, 8), True),
    ("K1", smem.chol_wide_floats(200), True),
    ("K1", smem.chol_wide_floats(256), True),
    ("K1", smem.chol_wide_floats(340), True),
    ("K1", smem.chol_wide_floats(341), False),
    ("B9", smem.chol_warp_floats(73, 4), True),
    ("B9", smem.chol_warp_floats(98, 2), True),
    ("K2", smem.slot_floats(100, 50, 51), True),
    ("K2", smem.slot_floats(893, 50, 51), True),
    ("K2", smem.slot_floats(894, 50, 51), False),
    ("K2", smem.slot_floats(500, 100, 101), False),
    # B3: both bodies take slot_floats; the horizon body within K, n = 64
    # and m = 128 (config 3: m = 100, n = 50, K = 51), both sides of each
    ("B3 horizon m=100 n=50 K=51", smem.slot_floats(100, 50, 51), True),
    ("B3 horizon m=128 n=64 K=64", smem.slot_floats(128, 64, 64), True),
    ("B3 block m=129 n=64 K=64", smem.slot_floats(129, 64, 64), True),
    ("B3 block m=128 n=65 K=64", smem.slot_floats(128, 65, 64), True),
    ("B3 block m=128 n=63 K=65", smem.slot_floats(128, 63, 65), True),
    ("B3 block m=893 n=50 K=51", smem.slot_floats(893, 50, 51), True),
    ("B3 block m=894 n=50 K=51", smem.slot_floats(894, 50, 51), False),
    ("B7", smem.dense_floats(209, 50, False), True),
    ("B7", smem.dense_floats(210, 50, False), False),
    ("B7-sw", smem.dense_floats(205, 50, True), True),
    ("B7-sw", smem.dense_floats(206, 50, True), False)])
def test_shared_memory_edges(kernel, floats, fits):
    if fits:
        smem.check(kernel, {}, floats, limit=H100_SMEM)
    else:
        with pytest.raises(ValueError, match=f"{4 * floats} bytes"):
            smem.check(kernel, {}, floats, limit=H100_SMEM)
    if kernel == "K2" and not fits and floats > smem.slot_floats(894, 50, 51):
        assert 4 * floats == 305864
    if kernel.startswith("B3"):
        m, n, K = map(int, re.findall(r"=(\d+)", kernel))
        assert floats == smem.slot_floats(m, n, K)
        assert smem.mpc_horizon(m, n, K) == kernel.startswith("B3 horizon")


def test_dense_mirror_reads_kernel_constants():
    # ops/smem.py's B7 constants are the ones dense_round.cu compiles with,
    # and its formula is the allocator's own (kernel source text, no nvcc)
    src = (Path(pchol.__file__).parent / "csrc" / "dense_round.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kDenseThreads") == smem.DENSE_THREADS
    assert const("kDenseRed") == smem.DENSE_RED
    assert smem.DENSE_WARPS == smem.DENSE_THREADS // 32
    body = re.search(r"dense_smem_floats\(int m, int n,\s*bool has_sw\) \{"
                     r"(.*?)\}", src, re.S).group(1)
    expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1",
                  body.replace("return", "").replace(";", ""))
    expr = "(" + re.sub(r"\(has_sw \? (.*?) : 0\)",
                        r"((\1) if has_sw else 0)", expr, flags=re.S) + ")"
    for m, n, sw in [(100, 50, False), (100, 50, True), (24, 12, False),
                     (209, 50, False), (205, 50, True)]:
        assert eval(expr, {"kDenseWarps": smem.DENSE_WARPS,
                           "kDenseRed": smem.DENSE_RED},
                    dict(m=m, n=n, has_sw=sw)) == smem.dense_floats(m, n, sw)


def test_slot_mirror_reads_kernel_constants():
    # ops/smem.py's K2 constants are the ones slot_step.cuh compiles with
    # (the block size, the reduction words per warp) and its slot_floats
    # is the allocator's own formula (kernel source text, no nvcc)
    src = (Path(pchol.__file__).parent / "csrc" / "slot_step.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") // 32 == smem.K_WARPS
    assert re.search(r"constexpr int kWarps = kThreads / 32;", src)
    assert const("kRedStride") == smem.RED_STRIDE
    body = re.search(r"slot_smem_floats\(int m, int n, int K\) \{(.*?)\n\}",
                     src, re.S).group(1)
    decls = re.search(r"const int (.*?);", body).group(1).split(",")
    expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1",
                  re.search(r"return (.*?);", body, re.S).group(1))
    for m, n, K in [(100, 50, 51), (50, 20, 21), (50, 10, 11), (893, 50, 51),
                    (500, 100, 101), (14, 6, 8)]:
        env = dict(m=m, n=n, K=K, kWarps=smem.K_WARPS,
                   kRedStride=smem.RED_STRIDE)
        for d in decls:
            name, value = d.split("=")
            env[name.strip()] = eval(value, {}, env)
        assert eval(f"({expr})", {}, env) == smem.slot_floats(m, n, K)


@pytest.mark.parametrize("kernel,source,fn,mirror", [
    ("B3", "mpc_segment.cu", "slot_smem_floats", smem.slot_floats),
    ("B4", "prox_segment.cu", "prox_smem_floats", smem.prox_floats),
    ("B5", "avi_segment.cu", "avi_smem_floats", smem.avi_floats),
    ("B6", "lp_segment.cu", "lp_smem_floats", smem.lp_floats)])
def test_segment_mirrors_read_kernel_constants(kernel, source, fn, mirror):
    # ops/smem.py's prox_floats, avi_floats and lp_floats are the segment
    # kernels' own allocators: the K2 layout (slot_floats, held against
    # slot_step.cuh above) plus the kernel's arrays; for B5 and B6 up to
    # kWarpMaxK slots and columns, where the block fits an H100's opt-in,
    # the warp body's (slot_warp.cuh slot_warp_smem_floats plus the same
    # arrays), the switch read from each C entry (kernel source text, no
    # nvcc), at configAVI, configLP, config 2 and both sides of each bound
    csrc = Path(pchol.__file__).parent / "csrc"
    src = (csrc / source).read_text()
    warp = (csrc / "slot_warp.cuh").read_text()
    if kernel == "B3":
        _mpc_mirror(src)
        return

    def formula(text, name):
        body = re.search(
            rf"size_t {name}\(int m, int n, int K\) \{{(.*?)\n\}}", text,
            re.S).group(1)
        decls = re.search(r"const int (.*?);", body)
        expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1",
                      re.search(r"return (.*?);", body, re.S).group(1))

        def f(m, n, K, **env):
            env = dict(env, m=m, n=n, K=K)
            for d in decls.group(1).split(",") if decls else ():
                name, value = d.split("=")
                env[name.strip()] = eval(value, {}, env)
            return eval(f"({expr})", {}, env)
        return f

    consts = _consts(warp)
    max_k = consts["kWarpMaxK"]
    assert (max_k, consts["kPosArrays"]) == (smem.WARP_MAX_K, smem.WARP_POS)
    block = formula(src, fn)
    warp_fn = fn.replace("_smem_floats", "_warp_smem_floats")
    has_warp = f"size_t {warp_fn}(" in src
    assert has_warp == (kernel in ("B5", "B6"))
    if has_warp:
        own = {"B5": smem.avi_own, "B6": smem.lp_own}[kernel]
        lane = formula(src, warp_fn)
        slot_warp = formula(warp, "slot_warp_smem_floats")
        entry = src[src.index('extern "C"'):]
        assert re.search(rf"const size_t warp = {warp_fn}\(m, n, K\) \* "
                         r"sizeof\(float\);", entry)
        assert re.search(r"cudaDeviceGetAttribute\(&optin,\s*"
                         r"cudaDevAttrMaxSharedMemoryPerBlockOptin,", entry)
        assert re.search(r"if \(K <= kWarpMaxK && n <= kWarpMaxK && "
                         r"warp <= static_cast<size_t>\(optin\)\)\s*"
                         r"return seg_launch\(\w+_segment_warp_kernel, B, "
                         r"32, warp,", entry)
        assert re.search(rf"return seg_launch\({source[:-3]}_kernel, B, "
                         rf"kThreads,\s*{fn}\(m, n, K\) \* sizeof\(float\)",
                         entry)
    for m, n, K in [(50, 20, 21), (50, 10, 11), (100, 50, 51),
                    (100, 31, 32), (100, 32, 33), (100, 33, 21), (14, 6, 8),
                    (2608, 10, 11), (2609, 10, 11), (1311, 31, 32),
                    (1312, 31, 32), (1812, 20, 21), (1813, 20, 21),
                    (1255, 31, 32), (1256, 31, 32)]:
        want = block(m, n, K, slot_smem_floats=smem.slot_floats)
        body = False
        if has_warp and K <= max_k and n <= max_k:
            floats = lane(m, n, K, slot_warp_smem_floats=lambda *a:
                          slot_warp(*a, **consts))
            if 4 * floats <= H100_SMEM:
                want, body = floats, True
            assert smem.warp_body(m, n, K, own, 4 * floats)
            assert not smem.warp_body(m, n, K, own, 4 * floats - 1)
        if has_warp:
            assert smem.warp_body(m, n, K, own) == body
        assert want == mirror(m, n, K)


def _mpc_mirror(src):
    # B3's two bodies share slot_smem_floats (held against slot_step.cuh
    # above); smem.mpc_horizon is mpc_body's switch, its ceilings and its
    # comparison read from the source, and both the C entry and the
    # occupancy entry launch mpc_body's pick at slot_smem_floats
    consts = _consts(src)
    ceil = (consts["kHorizonK"], consts["kHorizonN"], consts["kHorizonM"])
    assert ceil == (smem.HORIZON_K, smem.HORIZON_N, smem.HORIZON_M)
    # the horizon body's step runs at those ceilings, loads-first
    assert re.search(r"using HorizonStep =\s*StepCfg<kHorizonK, kHorizonN, "
                     r"kHorizonM, true>;", src)
    fits = re.search(r"const bool fits = (.*?);", src).group(1)
    assert re.search(r"if \(body < 0\) body = fits \? 1 : 0;", src)
    assert re.search(r"if \(body == 0\) return mpc_segment_kernel;", src)
    assert re.search(r"return body == 1 && fits \? "
                     r"mpc_segment_horizon_kernel : nullptr;", src)
    for entry in ("mpc_segment_f32(", "mpc_segment_occupancy("):
        body = src[src.index(f'extern "C" int {entry}'):]
        assert re.search(r"const MpcKernel kernel = mpc_body\(m, n, K, "
                         r"body\);\s*if \(kernel == nullptr\)", body)
        assert re.search(r"const size_t smem = slot_smem_floats\(m, n, K\) "
                         r"\* sizeof\(float\);", body)
    expr = fits.replace("&&", "and")
    kK, kN, kM = ceil
    for m, n, K in [(100, 50, 51), (50, 20, 21), (128, 64, 64),
                    (129, 64, 64), (128, 65, 64), (128, 63, 65), (893, 50, 51),
                    (24, 10, 11), (160, 80, 81), (127, 63, 63)]:
        want = eval(expr, dict(kHorizonK=kK, kHorizonN=kN, kHorizonM=kM,
                               m=m, n=n, K=K))
        assert smem.mpc_horizon(m, n, K) == want


def _consts(src):
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_lanes_mirror_reads_kernel_constants():
    # smem.chol_lanes_floats is chol_lanes.cu's Lanes<LB>::floats, with
    # the pad shift kLogG = log2(32 / LB) of every tile the wrapper may
    # pick (kernel source text, no nvcc)
    src = (Path(pchol.__file__).parent / "csrc" / "chol_lanes.cu").read_text()
    logg = re.search(r"kLogG = (.*?);", src, re.S).group(1)
    tiles = [int(v) for v in re.findall(r"case (\d+): return launch", src)]
    assert tuple(tiles) == pchol.LANE_TILES
    body = re.search(r"static size_t floats\(int n\) \{(.*?)\}", src,
                     re.S).group(1)
    e_expr = re.search(r"const size_t e = (.*?);", body, re.S).group(1)
    ret = re.search(r"return (.*?);", body, re.S).group(1)

    def py(expr):
        expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", expr)
        return expr.replace("/", "//")

    for lb in tiles:
        g = eval(re.sub(r"LB == (\d+) \? (\d+) :", r"\2 if LB == \1 else",
                        re.sub(r"\s+", " ", logg)), {}, {"LB": lb})
        assert 2 ** g == 32 // lb
        for n in (1, 10, 12, 20, 50, 56, 100, 240, 333):
            e = eval(py(e_expr), {}, {"n": n})
            assert eval(py(ret), {}, {"e": e, "LB": lb, "kLogG": g}) == \
                smem.chol_lanes_floats(n, lb)


def test_warp_mirror_reads_kernel_constants():
    # smem.chol_warp_floats is chol_warp.cuh's warp_floats, the block of K1
    # and B9 at one warp a matrix, and smem.chol_wide_floats its
    # wide_floats, their one matrix a block of P warps; the wrappers'
    # column limit is its kMaxGroups groups of 32, their matrices a block
    # and warps a matrix (chol.WARP_P, its kWarpsP) the ones its shape_ok
    # takes and its kernel_for dispatches; kernel_for picks 1, 2, 4, 8
    # column groups up to n = 32, 64, 128, 256, and each kernel's C entry
    # launches through it with that kernel's instances (kernel source
    # text, no nvcc)
    csrc = Path(pchol.__file__).parent / "csrc"
    src = (csrc / "chol_warp.cuh").read_text()
    c = _consts(src)
    assert 32 * c["kMaxGroups"] == pchol.WARP_MAX_N
    assert c["kMaxWarps"] == max(pchol.WARP_TILES)
    warps_p = re.search(r"constexpr int kWarpsP\[\] = \{(.*?)\};", src)
    assert tuple(int(v) for v in warps_p.group(1).split(",")) == \
        pchol.WARP_P
    assert re.findall(r"P == (\d+)\s*\? kernel_for<K, \1>\(n\)", src) == \
        ["1"] + [str(p) for p in pchol.WARP_P[:-1]]
    assert re.search(r": kernel_for<K, (\d+)>\(n\);", src).group(1) == \
        str(pchol.WARP_P[-1])
    assert re.findall(r"n <= (\d+)\s*\? K::template at<(\d+), P>\(\)", src) \
        == [("32", "1"), ("64", "2"), ("128", "4")]
    assert re.search(r": K::template at<(\d+), P>\(\);", src).group(1) == \
        str(c["kMaxGroups"])
    assert "n <= 32 * kMaxGroups && per_block >= 1 && per_block <= kMaxWarps" \
        in src
    assert "(P == 1 || (wide && per_block == 1))" in src
    assert "return P == 1 ? warp_floats(n, per_block) : wide_floats(n);" \
        in src
    wide = re.search(r"size_t wide_floats\(int n\) \{\s*return (.*?);", src,
                     re.S).group(1)
    for n in (1, 10, 12, 20, 50, 99, 100, 150, 200, 240, 256, 340):
        assert eval(re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", wide)
                    .replace("/", "//"), {}, {"n": n}) == \
            smem.chol_wide_floats(n)
    for kernel, name, entry in (("chol_rinv.cu", "chol_rinv_kernel", "K1"),
                                ("chol_dense.cu", "chol_dense_kernel", "B9")):
        ksrc = (csrc / kernel).read_text()
        assert '#include "chol_warp.cuh"' in ksrc
        assert f"static WarpKernel at() {{ return &{name}<G, P>; }}" in ksrc
        assert f"return launch_warp<{entry}Kernel>(" in ksrc
    body = re.search(r"size_t warp_floats\(int n, int per_block\) \{(.*?)"
                     r"\n\}", src, re.S).group(1)
    t_expr = re.search(r"const size_t T = (.*?);", body, re.S).group(1)
    ret = re.search(r"return (.*?);", body, re.S).group(1)

    def py(expr):
        expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", expr)
        return expr.replace("/", "//")

    for n in (1, 10, 12, 20, 32, 50, 64, 100, 116, 240, 256, 277):
        T = eval(py(t_expr), {}, {"n": n})
        for w in pchol.WARP_TILES:
            assert eval(py(ret), {}, {"T": T, "per_block": w}) == \
                smem.chol_warp_floats(n, w)


def test_blk_mirror_reads_kernel_constants():
    # smem.chol_blk_floats is chol_blk.cu's Blk<NT>::floats: the panel
    # width, the block size, the phase-2 k-tile and its row stride, the
    # panel row stride and the stage
    src = (Path(pchol.__file__).parent / "csrc" / "chol_blk.cu").read_text()
    c = _consts(src)
    assert c["kNB"] == smem.BLK_NB
    assert (c["kN64"], c["kN128"]) == (smem.BLK_N64, smem.BLK_N128)
    assert re.search(r"n <= kN64 \? launch<64>\(.*?\)\s*: n <= kN128 \? "
                     r"launch<128>\(.*?\)\s*: launch<256>", src, re.S)
    assert [smem.blk_threads(n) for n in (1, 64, 65, 256, 257)] == \
        [64, 64, 128, 128, 256]
    assert c["kKT"] == smem.BLK_KT
    assert re.search(r"constexpr int kXLd = kKT \+ (\d+);", src).group(1) \
        == str(smem.BLK_XLD - smem.BLK_KT)
    ldp = re.search(r"kLdp = kNB \+ (\d+);", src).group(1)
    stage = re.search(r"kStage = (.*?);", src).group(1).replace("NT",
                                                                "kThreads")
    body = re.search(r"static size_t floats\(int n\) \{(.*?)\n  \}", src,
                     re.S).group(1)
    env_expr = {k: re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", v)
                for k, v in re.findall(r"const size_t (p\d) = (.*?);", body,
                                       re.S)}
    for n in (1, 13, 32, 33, 50, 64, 65, 100, 256, 257, 300, 500, 1000,
              1581):
        env = dict(kNB=c["kNB"], kThreads=smem.blk_threads(n), kKT=c["kKT"],
                   kXLd=smem.BLK_XLD, kLdp=c["kNB"] + int(ldp), n=n)
        env["kStage"] = eval(stage, {}, env)
        p = {k: eval(re.sub(r"\((\w+ > \w+) \? (.*?) : 0\)",
                            r"((\2) if \1 else 0)", v), {}, env)
             for k, v in env_expr.items()}
        assert max(p.values()) == smem.chol_blk_floats(n)


@pytest.mark.parametrize("n", [1, 10, 12, 20, 28, 29, 50, 51, 100, 106, 107,
                               151, 152, 234, 240, 333, 334])
def test_lanes_tile_is_the_largest_that_fits(n):
    # the wrapper's lanes per block: the first of 32, 16, ..., 1 whose
    # block fits in 48 KB, so twice as many would not (at 32, none more is
    # built); past one lane in 48 KB (n > 151), the most that fit the card
    lb = pchol.lanes_tile(n, H100_SMEM)
    assert lb in pchol.LANE_TILES
    need = 4 * smem.chol_lanes_floats(n, lb)
    cap = pchol.LANES_BUDGET if 4 * smem.chol_lanes_floats(n, 1) <= \
        pchol.LANES_BUDGET else H100_SMEM
    assert (need <= cap) == (n <= 333)
    if need <= cap and lb < 32:
        assert 4 * smem.chol_lanes_floats(n, 2 * lb) > cap
    assert [pchol.lanes_tile(k, H100_SMEM) for k in (10, 20, 50, 100, 240)] \
        == [32, 32, 8, 2, 1]


# K1's and B9's warps a block from (B, n) on an H100 (132 SMs): the most
# of 8, 4, 2, 1 whose block fits in 48 KB while the batch still gives
# every SM a block (config 2's 10240 lanes at n = 50: 8; the stages batch
# of 1024: 4), else 1.
H100_SMS = 132


@pytest.mark.parametrize("B,n,warps", [
    (10240, 50, 8), (1024, 50, 4), (256, 50, 1), (10240, 53, 8),
    (10240, 54, 4), (10240, 73, 4), (10240, 74, 2), (10240, 98, 2),
    (10240, 99, 1), (256, 240, 1), (64, 256, 1), (10240, 10, 8),
    (528, 10, 4), (524, 10, 2), (131, 10, 1)])
def test_warp_tile_fits_and_gives_every_sm_a_block(B, n, warps):
    w = pchol.warp_tile(B, n, H100_SMEM, H100_SMS)
    assert w == warps
    assert w == 1 or (4 * smem.chol_warp_floats(n, w) <= pchol.WARP_BUDGET
                      and -(-B // w) >= H100_SMS)
    if w < max(pchol.WARP_TILES):               # twice as many would not
        assert 4 * smem.chol_warp_floats(n, 2 * w) > pchol.WARP_BUDGET \
            or -(-B // (2 * w)) < H100_SMS


# A batch of at most 8 matrices an SM runs one matrix a block (config
# 4's retry batch of 256, the flat grid's 64 at n = 100 and 16 at n = 200,
# the stages batches of 1024, limits' 64 at n = 256), and so does a width
# whose warp_tile is 1 (n >= 99), of 4 warps up to n = 128 and 8 past it
# (a warp each column group of 32, at least 4); a larger batch at a
# smaller width a warp a matrix, warp_tile matrices a block.
@pytest.mark.parametrize("B,n,shape", [
    (256, 50, (1, 4)), (1024, 50, (1, 4)), (1320, 50, (8, 1)),
    (1321, 50, (8, 1)), (10240, 50, (8, 1)), (64, 256, (1, 8)),
    (1056, 50, (1, 4)), (1057, 50, (8, 1)),
    (1024, 100, (1, 4)), (2048, 80, (2, 1)), (2048, 98, (2, 1)),
    (2048, 99, (1, 4)), (1, 10, (1, 4)), (16, 200, (1, 8)),
    (64, 100, (1, 4)), (16, 50, (1, 4)), (1024, 128, (1, 4)),
    (1024, 129, (1, 8)), (2048, 129, (1, 8)), (256, 240, (1, 8))])
def test_warp_shape_small_batch_shares_a_matrix(B, n, shape):
    assert pchol.warp_shape(B, n, H100_SMEM, H100_SMS) == shape
    w = pchol.warp_tile(B, n, H100_SMEM, H100_SMS)
    if shape[1] == 1:
        assert shape[0] == w > 1
    else:
        assert B <= pchol.WARP_SMALL_PER_SM * H100_SMS or w == 1
        assert shape[1] in pchol.WARP_P and (32 * shape[1] >= n or
                                             shape[1] == pchol.WARP_P[-1])
        assert shape[1] == pchol.WARP_P[0] or 32 * shape[1] // 2 < n


# batched_rinv_regularized's factorization by width on an H100, set from
# K1, B10 and the library timed in turns at B = 16-1024 (PERF.md §6):
# K1 to n = 128, B10 while its block fits, then the library; the
# kernel stream still takes an f32 batch that B10 factors where K2's
# block fits (n = 129, m = 100), as it did on K1
@pytest.mark.parametrize("n,route", [
    (10, "k1"), (50, "k1"), (100, "k1"), (128, "k1"), (129, "b10"),
    (150, "b10"), (200, "b10"), (256, "b10"), (257, "b10"), (1581, "b10"),
    (1582, "library")])
def test_factor_route_from_measurement(n, route):
    assert pchol.factor_route(n, H100_SMEM) == route
    assert n > pchol.WARP_ROUTE_N or route == "k1"
    kernel = pbatch.batch_route(torch.float32, n, 100, False, False,
                                H100_SMEM)
    assert kernel == ("kernel" if 4 * smem.slot_floats(100, n, n + 1)
                      <= H100_SMEM and route != "library" else "flat")
    if n == 129:
        assert kernel == "kernel"


@pytest.mark.parametrize("wrapper,twin,count", [
    (pchol.chol_rinv, pchol.chol_rinv_plain, "launches"),
    (pchol.chol_rinv_lanes, pchol.chol_rinv_lanes_plain, "lanes_launches"),
    (pchol.chol_rinv_dense, pchol.chol_rinv_dense_plain, "dense_launches"),
    (pchol.chol_rinv_blk, pchol.chol_rinv_blk_plain, "blk_launches")])
def test_cpu_tensor_runs_twin(monkeypatch, wrapper, twin, count):
    # a CPU tensor takes the twin and launches nothing; any other device
    # that is not CUDA raises (no quiet fallback)
    monkeypatch.setattr(pchol, count, 0)
    H = torch.as_tensor(_spd_batch(8, 9, seed=9), dtype=torch.float32)
    assert torch.equal(wrapper(H), twin(H))
    assert getattr(pchol, count) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(torch.empty((2, 3, 3), device="meta"))


def test_stage_solves_on_each_factor_match_jax():
    # the factorization stage end to end: each twin's factor, the pivot
    # ratio test for ok, then the slot tier through _kernel_batch_core's
    # fact= (as the JAX core takes it), against the JAX package's own
    # solve (factor by its tile kernel) and the constructed optimum
    KEYS = ('H', 'f', 'A', 'bupper', 'blower', 'sense')
    d = generate_test_qp_batch(128, 12, 30, 0, 8, 1e2, rng=47,
                               dtype=np.float32)
    over = {"iter_limit": 500}
    rj = batch_mod.solve_batch_pallas_jit(
        *[jnp.asarray(d[k]) for k in KEYS], st=_as_settings(
            over, jnp.float32), ms=0, has_soft=False, interpret=True)
    fj, xj = np.asarray(rj.exitflag), np.asarray(rj.x)
    args = [torch.as_tensor(d[k]) for k in KEYS]
    st = dt.as_settings(over, torch.float32)
    sqrt_zt = torch.sqrt(torch.tensor(st.zero_tol))
    no = torch.zeros(128, dtype=torch.bool)
    for twin in (pchol.chol_rinv_plain, pchol.chol_rinv_lanes_plain,
                 pchol.chol_rinv_dense_plain, pchol.chol_rinv_blk_plain):
        R = twin(args[0])
        ok = pchol.pivot_ok(R, sqrt_zt)
        assert bool(ok.all()), twin.__name__
        rp = pbatch._kernel_batch_core(*args, st, fact=(R, ok, no,
                                                        torch.zeros(128)))
        fp, xp = rp.exitflag.numpy(), rp.x.numpy()
        assert (fp == fj).mean() >= 0.98, twin.__name__
        both = (fp == 1) & (fj == 1)
        assert np.linalg.norm(xp - xj, axis=1)[both].max() < 2e-3
        assert np.linalg.norm(xp - d['x'], axis=1)[fp == 1].max() < 2e-3
