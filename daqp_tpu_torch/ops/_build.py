"""Build the hand-written CUDA kernels with nvcc and bind them by ctypes.

Each ``csrc/*.cu`` file compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The library lands in ``<checkout>/build/daqp_tpu_torch/``,
keyed by a hash of the sources (``*.cu`` and ``*.cuh``) and flags, and is
built at first use.  There is no fallback: a missing nvcc or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "daqp_tpu_torch"
# no --use_fast_math: the active-set kernels rely on isfinite and IEEE
# division.  ptxas picks each kernel's register budget itself (B3-B6 set
# no blocks per SM); at its default register usage level it left B3 at
# 128 registers with 8-12 bytes of spill, at level 0 with none (nvcc
# 12.9, sm_90a)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-Xptxas", "--register-usage-level=0"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes; every entry returns
# cudaGetLastError(), or the error of cudaFuncSetAttribute
_SIGNATURES = {
    # (H, Rinv, B, n, matrices per block, warps per matrix, tiny, stream)
    "chol_rinv_f32": [_P, _P, _I, _I, _I, _I, _F, _P],
    # (H, Rinv, B, n, matrices per block, tiny, stream)
    "chol_lanes_f32": [_P, _P, _I, _I, _I, _F, _P],
    # (H, Rinv, B, n, matrices per block, warps per matrix, tiny, stream)
    "chol_dense_f32": [_P, _P, _I, _I, _I, _I, _F, _P],
    # (H, Rinv, B, n, tiny, stream)
    "chol_blk_f32": [_P, _P, _I, _I, _F, _P],
    # (host array of 53 device pointers, B, m, n, K, n_true, steps,
    #  dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol, cycle_tol,
    #  bland, stream)
    "slot_round_f32": [_P, _I, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _I, _P],
    # (host array of 58 device pointers, S, m, n, K, n_true, steps, P,
    #  the six tolerances, bland, body (-1 by shape, 0 the 128-thread
    #  body, 1 the horizon body), stream)
    "mpc_segment_f32": [_P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _I, _I, _P],
    # (host array of 70 device pointers, B, m, n, K, n_true, steps, P,
    #  the six tolerances, bland, stream)
    "prox_segment_f32": [_P, _I, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _I, _P],
    # (host array of 47 device pointers, the last 8 null unless has_sw,
    #  B, m, n, n_true, steps, the six tolerances, bland, rho_soft,
    #  has_soft, has_sw, stream)
    "dense_round_f32": [_P, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _I, _F, _I, _I, _P],
    # (host array of 79 device pointers, B, m, n, K, n_true, steps, P,
    #  the six tolerances, bland, stream)
    "avi_segment_f32": [_P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _I, _P],
    # (host array of 75 device pointers, the last 2 null unless the bounds
    #  are asked for, B, m, n, K, n_true, steps, P, the six tolerances,
    #  bland, eta, stream)
    "lp_segment_f32": [_P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _I, _F, _P],
}

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of daqp_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sorted(_CSRC.glob("*.cu"))
    deps = sorted(_CSRC.glob("*.cuh")) + srcs
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libdaqp_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = None
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        (BUILD_DIR / "nvcc.log").write_text("".join(logs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + "".join(logs)[-4000:])
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() code from a C entry."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
