"""Layer: kernel B7 (``ops/csrc/dense_round.cu``).

The least time of B7's rounds in the traced window on the published
peaks (the state read once and written once; each lane's steps at its
mean active rows, ``counts.dense_round_flops``), over B7's device time
there, in %."""
from harness import counts

LAUNCH = "daqp_tpu_torch.ops.dense:run_kernel_round"
KERNEL = "dense_round_kernel"
# fields of the dense state the round reads and does not write
CONST = ("M", "dupper", "dlower", "scaling", "immut", "soft", "fbound",
         "sw_dls", "sw_dus", "sw_rls", "sw_rus")


def record(args, kwargs, out):
    s0 = args[0]
    if s0.M.device.type != "cuda" or not s0.M.shape[0]:
        return None
    return dict(s0=_counted(s0), sk=_counted(out), n=s0.M.shape[2],
                sw=s0.sw_dls is not None,
                bytes=counts.state_bytes(s0) + counts.state_bytes(out, CONST))


class _counted:
    """The fields ``dense_round_flops`` reads, kept by reference."""

    def __init__(self, s):
        self.act_up, self.act_lo, self.iterations = \
            s.act_up, s.act_lo, s.iterations


def read(ctx):
    recs = ctx.records(__name__)
    t = ctx.trace.kernel_s(KERNEL) if ctx.trace else 0.0
    if not recs or t <= 0:
        return None
    least = sum(counts.bound(r["bytes"], counts.dense_round_flops(
        r["s0"], r["sk"], r["n"], r["sw"]))["bound_ms"] for r in recs) * 1e-3
    return 100.0 * least / t
