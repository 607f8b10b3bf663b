"""Entry adapter: ``daqp_tpu_torch.solve_batch``, the batched entry of the
quick start (dense strictly convex QPs with a leading batch dimension).

One call hands the pool item's device tensors to ``solve_batch`` as a
user would, with the traffic's settings (none: the defaults for the
served type), and ends with x, the exit flags and the iterations on the
host.  A row of the item's ``soft`` mask is passed as DAQP's SOFT sense
bit, which routes the batch to the dense-mask tier.
"""
import torch

import daqp_tpu_torch as dt

OPTIMAL = (dt.EXIT_OPTIMAL, dt.EXIT_SOFT_OPTIMAL)

# functions of the port that a traced run wraps in spans, from the entry
# down (module:function), to label the device's idle gaps
SPANS = (
    "daqp_tpu_torch.batch:solve_batch_kernel_stream",
    "daqp_tpu_torch.batch:_kernel_batch_core",
    "daqp_tpu_torch.ops.chol:batched_rinv_regularized",
    "daqp_tpu_torch.transform:build_ldp",
    "daqp_tpu_torch.transform:ldp_to_qp_solution",
    "daqp_tpu_torch.ops.slot:slot_solve",
    "daqp_tpu_torch.ops.slot:exact_repair",
    "daqp_tpu_torch.ops.slot:polish",
    "daqp_tpu_torch.ops.slot:slot_duals_dense",
    "daqp_tpu_torch.ops.dense:dense_solve",
    "daqp_tpu_torch.ops.dense:exact_repair",
    "daqp_tpu_torch.ops.dense:polish",
)


def prepare(item: dict, config: dict, traffic: dict):
    """The call's arguments, made at set-up."""
    sense = torch.where(item["soft"], dt.SOFT, 0).to(torch.int32)
    args = (item["H"], item["f"], item["A"], item["bupper"],
            item["blower"], sense)
    return args, dict(ms=config.get("ms", 0),
                      settings=traffic.get("settings") or None)


def call(args, kwargs):
    """One timed call: x (B, n), exit flags (B,), iterations (B,) on the
    host."""
    r = dt.solve_batch(*args, **kwargs)
    return r.x.cpu(), r.exitflag.cpu(), r.iterations.cpu()
