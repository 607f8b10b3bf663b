"""Layer: host loops (``batch._kernel_batch_core``, ``ops/slot.slot_solve``,
``ops/dense.dense_solve``).

The port's own count of host reads of device values, each a wait for
the device (``daqp_tpu_torch.ops.host_syncs``), over a traced run's first
window (untraced), a call."""
COUNTERS = ("daqp_tpu_torch.ops:host_syncs",)


def read(ctx):
    return ctx.counter(COUNTERS[0]) / ctx.calls
