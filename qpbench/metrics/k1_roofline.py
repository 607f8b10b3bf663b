"""Layer: kernel K1 (``ops/csrc/chol_rinv.cu``, ``chol_warp.cuh``).

The least time of K1's launches in the traced window on the published
peaks (each matrix's lower triangle read once and Rinv written once, or
2n^3/3 operations a matrix: ``harness/counts.py``), over K1's device
time there, in %.  Bound by bytes at n = 50."""
from harness import counts

LAUNCH = "daqp_tpu_torch.ops.chol:chol_rinv"
KERNEL = "chol_rinv_kernel"


def record(args, kwargs, out):
    H = args[0]
    if H.device.type != "cuda" or not H.shape[0]:
        return None
    return H.shape[0], H.shape[-1], H.element_size()


def read(ctx):
    recs = ctx.records(__name__)
    t = ctx.trace.kernel_s(KERNEL) if ctx.trace else 0.0
    if not recs or t <= 0:
        return None
    least = sum(counts.bound(counts.factor_bytes(B, n, size),
                             counts.factor_flops(B, n))["bound_ms"]
                for B, n, size in recs) * 1e-3
    return 100.0 * least / t
