"""Build the hand-written CUDA kernels with nvcc and bind them by ctypes.

All ``csrc/*.cu`` files compile in one nvcc call into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The library lands in ``<checkout>/build/daqp_tpu_torch/``, keyed by a
hash of the sources and flags, and is built at first use.  There is no
fallback: a missing nvcc or a failed build raises.
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
# no --use_fast_math: the slot kernel relies on isfinite and IEEE division
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes; every entry returns cudaGetLastError()
_SIGNATURES = {
    # (H, Rinv, B, n, tiny, stream)
    "chol_rinv_f32": [_P, _P, _I, _I, _F, _P],
    # (host array of 53 device pointers, B, m, n, K, n_true, steps,
    #  dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol, cycle_tol,
    #  bland, stream)
    "slot_round_f32": [_P, _I, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _I, _P],
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
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, srcs)],
                              capture_output=True, text=True)
        (BUILD_DIR / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + proc.stderr[-4000:])
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
