"""Layer: kernel K2 (``ops/csrc/slot_round.cu``, ``slot_step.cuh``).

The least time of K2's rounds in the traced window on the published
peaks (the state read once and written once; each lane's steps at its
mean used slots, ``counts.slot_round_flops``), over K2's device time
there, in %.  Bound by operations at config 2's shapes."""
from harness import counts

LAUNCH = "daqp_tpu_torch.ops.slot:run_slot_round"
KERNEL = "slot_round_kernel"
# fields of the slot state the round reads and does not write
CONST = ("M", "dupper", "dlower", "scaling", "immut", "simm", "fbound")


def record(args, kwargs, out):
    s0 = args[0]
    if s0.M.device.type != "cuda" or not s0.M.shape[0]:
        return None
    _, m, n = s0.M.shape
    return dict(s0=_counted(s0), sk=_counted(out), m=m, n=n,
                bytes=counts.state_bytes(s0) + counts.state_bytes(out, CONST))


class _counted:
    """The fields ``slot_round_flops`` reads, kept by reference."""

    def __init__(self, s):
        self.used, self.iterations, self.status = \
            s.used, s.iterations, s.status


def read(ctx):
    recs = ctx.records(__name__)
    t = ctx.trace.kernel_s(KERNEL) if ctx.trace else 0.0
    if not recs or t <= 0:
        return None
    least = sum(counts.bound(r["bytes"], counts.slot_round_flops(
        r["s0"], r["sk"], r["m"], r["n"]))["bound_ms"] for r in recs) * 1e-3
    return 100.0 * least / t
