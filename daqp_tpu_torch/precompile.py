"""Deploy-time warm-up of the kernel tiers.

Counterpart of ``daqp_tpu/precompile.py`` (``:32 warmup``).  The JAX
package compiles a Mosaic program per (B, n, m) shape and settings, and
its warm-up pays that once before serving.  The port has no compile per
shape: its CUDA kernels are one library, built by nvcc on first use
(``ops/_build.py``).  What a first call still pays is that build, the
library's loading and CUDA's and PyTorch's own first-use costs (context,
allocator, library handles).  :func:`warmup` pays them before the first
real batch: it builds the library when the device is the card, then runs
each named tier once at exactly (B, n, m) on a trivial batch.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from . import batch as pbatch
from .ops import _build
from .types import SOFT, Settings, SoftWeights, as_settings

TIERS = ("hard", "soft", "sw", "flat")


def warmup(n: int, m: int, B: int, settings: Optional[Settings] = None,
           tiers: Sequence[str] = ("hard",), ms: int = 0,
           dtype=torch.float32, device=None) -> dict:
    """Run each of ``tiers`` once at (B, n, m) in ``dtype`` on ``device``
    (the card unless ``"cpu"``, where the kernels' plain twins run):

    * ``"hard"``: ``solve_batch_kernel_stream`` (K1, K2);
    * ``"soft"``: the stream with every row SOFT and ``has_soft`` (B7);
    * ``"sw"``: the stream with ``SoftWeights`` (B7's SOFT_WEIGHTS
      variant);
    * ``"flat"``: ``solve_batch_flat_jit``.

    The batch: H = I, f = 0, the rows of A cycling through the unit
    vectors, bounds -1 and 1 (its solution is x = 0).  An unknown tier
    raises ValueError before any work.  Returns {tier: seconds}."""
    bad = [t for t in tiers if t not in TIERS]
    if bad:
        raise ValueError(f"unknown tier {bad[0]!r}; expected one of {TIERS}")
    dev = pbatch.resolve_device((), device)
    if dev.type == "cuda":
        _build.library()
    st = as_settings(settings, dtype)
    mg = m - ms
    H = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n).contiguous()
    f = torch.zeros((B, n), dtype=dtype, device=dev)
    A = torch.eye(n, dtype=dtype, device=dev)[
        torch.arange(mg, device=dev) % n].expand(B, mg, n).contiguous()
    bu = torch.ones((B, m), dtype=dtype, device=dev)
    hard = torch.zeros((B, m), dtype=torch.int32, device=dev)
    zero = torch.zeros_like(bu)
    sw = SoftWeights(zero, zero, bu * st.rho_soft, bu * st.rho_soft)
    runs = {
        "hard": lambda: pbatch.solve_batch_kernel_stream(
            H, f, A, bu, -bu, hard, st, ms=ms),
        "soft": lambda: pbatch.solve_batch_kernel_stream(
            H, f, A, bu, -bu, hard | SOFT, st, ms=ms, has_soft=True),
        "sw": lambda: pbatch.solve_batch_kernel_stream(
            H, f, A, bu, -bu, hard | SOFT, st, ms=ms, sw=sw),
        "flat": lambda: pbatch.solve_batch_flat_jit(
            H, f, A, bu, -bu, hard, st, ms=ms),
    }
    out = {}
    for tier in tiers:
        t0 = time.perf_counter()
        runs[tier]()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[tier] = time.perf_counter() - t0
    return out
