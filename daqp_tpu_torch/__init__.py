"""daqp_tpu_torch: the PyTorch / CUDA port of daqp_tpu.

The cold batch path of ``daqp_tpu`` (transform, slot active-set solver
for hard batches, dense-mask solver for batches with soft rows or
SOFT_WEIGHTS slack data, stream entry, the f64 backstop), the flat tier
(``ldp_flat``: any shape, in the caller's dtype) behind the quick
start's ``solve_batch``, the warm MPC horizons (``mpc``), the
semidefinite proximal batch, the batched hierarchical least-squares
walk, batched affine variational inequalities, batched LPs (the
adaptive-eps proximal LP tier) and batched MIQP branch and bound in node
waves, with their TPU kernels rewritten for Hopper in
CUDA C++ (``ops/csrc``); and the single-instance solvers with their
public API (``solve``, ``quadprog``, ``linprog``, ``avi``, ``Model``,
``minrep``, ``isfeasible``): dense QPs, LPs, AVIs, hierarchies and MIQP
branch and bound, with the f64 backstops of every batched tier; the
deploy-time pieces (``warmup``, ``codegen.render_c`` behind
``Model.codegen``) and scale-out over ``torch.distributed``
(``parallel``: batches split by rank, the tree-sharded MIQP).  Entry points run
on the card unless asked for the CPU (CPU tensors or ``device="cpu"``),
where each kernel's plain PyTorch twin runs.

TF32 is switched off here: it keeps ~3 decimal digits and would corrupt
the f32 solver math, as bf16 does on the TPU.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .types import (  # noqa: E402
    ACTIVE, LOWER, IMMUTABLE, SOFT, BINARY, DAQP_INF, EXIT_OPTIMAL,
    EXIT_SOFT_OPTIMAL, EXIT_NO_DOF,
    EXIT_INFEASIBLE, EXIT_CYCLE, EXIT_UNBOUNDED, EXIT_ITERLIMIT,
    EXIT_NONCONVEX, EXIT_OVERDETERMINED_INITIAL, EXIT_TIMELIMIT,
    EXIT_UNSUPPORTED, EXIT_RUNNING, EXIT_REFACTOR, FLAG_TO_STATUS,
    PRICING_DANTZIG, PRICING_BLAND, Problem, Result, Settings, SoftWeights,
    default_settings_f32, as_settings)
from .batch import (  # noqa: E402
    BatchResult, solve_batch, solve_batch_kernel, solve_batch_kernel_stream,
    solve_batch_prox_kernel, solve_batch_hiqp_kernel, solve_batch_avi_kernel,
    solve_batch_lp_kernel, solve_batch_miqp_kernel, kkt_residuals,
    backstop_resolve, backstop_resolve_lp, backstop_resolve_avi,
    backstop_resolve_hiqp)
from .api import solve, quadprog, linprog, avi  # noqa: E402
from .model import Model  # noqa: E402
from .geometry import minrep, isfeasible  # noqa: E402
from .mpc import (  # noqa: E402
    MPCStep, solve_mpc_scan, solve_mpc_scan_kernel,
    solve_mpc_scan_kernel_fused)
from .precompile import warmup  # noqa: E402
