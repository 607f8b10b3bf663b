"""Layer: kernel dispatch (``ops/chol.py``, ``ops/slot.py``, ``ops/dense.py``).

The port's launch counters of its own hand-written kernels (K1, B8, B9,
B10; K2, B3, B4, B5, B6; B7), summed over the first window of a traced
run (untraced), a call.  Beside ``launches_per_call``, which counts
every kernel the card ran."""
COUNTERS = (
    "daqp_tpu_torch.ops.chol:launches",
    "daqp_tpu_torch.ops.chol:lanes_launches",
    "daqp_tpu_torch.ops.chol:dense_launches",
    "daqp_tpu_torch.ops.chol:blk_launches",
    "daqp_tpu_torch.ops.slot:launches",
    "daqp_tpu_torch.ops.slot:mpc_launches",
    "daqp_tpu_torch.ops.slot:prox_launches",
    "daqp_tpu_torch.ops.slot:avi_launches",
    "daqp_tpu_torch.ops.slot:lp_launches",
    "daqp_tpu_torch.ops.dense:launches",
)


def read(ctx):
    return sum(ctx.counter(c) for c in COUNTERS) / ctx.calls
