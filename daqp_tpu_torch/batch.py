"""Batched QP solving on the port's kernel path.

Counterpart of ``daqp_tpu/batch.py``: ``:56 BatchResult``, ``:248
solve_batch_pallas_jit``, ``:315 solve_batch_pallas_stream_jit``, ``:428
_difficulty_nviol``, ``:451 _pallas_batch_core`` (its hard, soft and
SOFT_WEIGHTS branches, :551-694), ``:699 solve_batch_prox_pallas_jit``,
``:981 solve_batch_lp_pallas_jit``, ``:1587
solve_batch_avi_pallas_jit``, ``:1999 solve_batch_hiqp_pallas_jit``,
``:2233 solve_batch_miqp_pallas_jit``, ``:2582 kkt_residuals``,
``:2637-2771`` (``backstop_resolve_lp``, ``_avi``, ``_hiqp``) and
``:2772 backstop_resolve``; and of its flat and ordered tiers: ``:65
_solve_one`` and ``:91 solve_batch_jit`` (the ordered tier, its lane
body in ``solve_batch_jit``'s loop), ``:117 _solve_one_flat``
(``_solve_flat``, batched), ``:175 _flat_batch_core`` and ``:222
solve_batch_flat_jit`` (the flat tier, ``ldp_flat``; the chunks in
``solve_batch_flat_jit``), ``:2566 solve_batch_miqp_jit`` and ``:2857
solve_batch``.  The entry points keep the JAX names so that a reader
finds the counterpart; nothing here is jitted.

Every entry point runs where its inputs are: tensors keep their device
(inputs on mixed devices raise) and other inputs (numpy arrays, lists) go
to ``device``, which defaults to ``"cuda"``.  The CPU is used only when
asked for, with CPU tensors or ``device="cpu"``.

The path: K1 factors every H (``ops.chol.batched_rinv_regularized``),
``transform.build_ldp`` builds the LDP data, ``ops.slot`` runs K2 rounds
with exact repair and polish (hard batches) or ``ops.dense`` runs B7
rounds (batches with SOFT rows, whose working set may outgrow n + 1
slots), and the state maps back to x, lam, fval.
``solve_batch_hiqp_kernel`` (``batch.py:1999
solve_batch_hiqp_pallas_jit``) walks the hierarchy's levels on B7, and
``solve_batch_avi_kernel`` runs the Douglas-Rachford splitting of
batched affine variational inequalities on B5 and K2, and
``solve_batch_lp_kernel`` the adaptive-eps proximal LP regime on K2 (or
B6 with ``fused=True``); ``solve_batch_miqp_kernel`` runs branch and
bound in node waves on K1 and K2.  The backstops re-solve a batch's loud
lanes in f64 through the single-instance API (``quadprog``, ``linprog``,
``avi``, ``quadprog(break_points=...)``).

The flat tier (``solve_batch_flat_jit``) solves any shape in the caller's
dtype on ``ldp_flat``'s slot table in torch ops; an f32 batch on the card
is factored by K1 or B10 (``chol.factor_route``), any other batch by the
library's Cholesky, as the JAX flat tier factors in XLA.
``solve_batch`` sends what fits the kernels' blocks to the kernel stream
and the rest to the flat tier, by ``batch_route``.  The ordered tier
(``solve_batch_jit``) and ``solve_batch_miqp_jit`` run the
single-instance solvers lane after lane.  Left behind as TPU
workarounds: the 512-lane guard and its routing, the 128-lane padding,
the n-padding of the AVI matrices, the MIQP tier's 31-bit words and
one-hot bin-to-row einsum, and the in-core difficulty sort for tile
occupancy (one block per QP has no tiles).

Every entry takes ``deadline``, an absolute ``time.perf_counter()``
time: the host checks it between kernel rounds (``ops.slot.slot_solve``,
``ops.dense.dense_solve``) and once per outer pass, segment, level or
chunk of the drivers, and a lane still running past it exits
``EXIT_TIMELIMIT``.  The check reads only the host's clock, so it adds no
host sync, and ``deadline=None`` skips it.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import bnb, core, ldp_flat, transform
from . import ldp as ldp_mod
from .ops import (chol, dense, host_any, host_numpy, host_read, late, slot,
                  smem)
from .prox import auto_eta
from .types import (ACTIVE, BINARY, IMMUTABLE, LOWER, SOFT, DAQP_INF,
                    EXIT_CYCLE, EXIT_INFEASIBLE, EXIT_ITERLIMIT, EXIT_NO_DOF,
                    EXIT_NONCONVEX,
                    EXIT_OPTIMAL, EXIT_REFACTOR, EXIT_RUNNING,
                    EXIT_SOFT_OPTIMAL, EXIT_TIMELIMIT, EXIT_UNBOUNDED,
                    EXIT_UNSUPPORTED, PRICING_BLAND, Settings, SoftWeights,
                    as_settings)


class BatchResult(NamedTuple):
    x: torch.Tensor           # (B, n)
    lam: torch.Tensor         # (B, m)
    fval: torch.Tensor        # (B,)
    exitflag: torch.Tensor    # (B,) int32
    iterations: torch.Tensor  # (B,) int32
    soft_slack: torch.Tensor  # (B,)


def timed_out(flag, run):
    """``flag`` with the ``run`` lanes set to EXIT_TIMELIMIT."""
    return torch.where(run, EXIT_TIMELIMIT, flag).to(torch.int32)


def resolve_device(inputs, device=None) -> torch.device:
    """The device an entry point runs on: that of its tensor inputs, else
    ``device`` (default ``"cuda"``).  Tensors on mixed devices, or on
    another device than an explicit ``device``, raise ValueError; a CUDA
    target on a machine without a CUDA device raises RuntimeError."""
    devs = {x.device for x in inputs if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(
            f"inputs on mixed devices: {sorted(map(str, devs))}")
    want = torch.device("cuda" if device is None else device)
    if devs:
        (have,) = devs
        if device is not None and (have.type != want.type or (
                want.index is not None and have.index != want.index)):
            raise ValueError(f"inputs on {have}, but device={want}")
        return have
    if want.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass CPU tensors "
            "or device='cpu' to run the plain twins on the host")
    return want


def _tensors(H, f, A, bupper, blower, sense, device=None):
    """The inputs as tensors on the resolved device, in H's float type."""
    dev = resolve_device((H, f, A, bupper, blower, sense), device)
    H = torch.as_tensor(H, device=dev)
    out = [H] + [torch.as_tensor(x, device=dev).to(H.dtype)
                 for x in (f, A, bupper, blower)]
    if sense is None:
        sense = torch.zeros(out[3].shape, dtype=torch.int32, device=dev)
    return out + [torch.as_tensor(sense, device=dev).to(torch.int32)]


def _difficulty_nviol(f, A, bupper, blower, ms: int, Rinv):
    """Violated-constraint count at the unconstrained optimum
    x = -Rinv Rinv' f: the stream's difficulty proxy."""
    v = torch.matmul(Rinv.transpose(1, 2), f[..., None])
    x_unc = -torch.matmul(Rinv, v)[..., 0]
    Ax = torch.matmul(A, x_unc[..., None])[..., 0]
    vals = torch.cat([x_unc[:, :ms], Ax], dim=1)
    return ((vals > bupper) | (vals < blower)).sum(dim=-1)


def _guess_activate(s: slot.SlotState, ldpd: transform.LDPData, immut,
                    guess_cap: int, st: Settings) -> slot.SlotState:
    """The primal-init active-set guess (``daqp_tpu/batch.py:621-677``,
    the batched form of the reference's ``daqp_primal_init_active``,
    api.c:555-592, at the unconstrained optimum u = 0): the top
    ``guess_cap`` violated rows that are not immutable, ranked by
    max(-dupper, dlower), activated at once through ``slot_activate``
    (one batched Cholesky in place of ~guess_cap pricing / add steps).  A
    wrong guess leaves through the ordinary blocking search; a lane whose
    guessed set is dependent (``EXIT_REFACTOR``) keeps its cold start."""
    viol = torch.maximum(-ldpd.dupper, ldpd.dlower)
    elig = (viol > 0) & (immut <= 0)
    order = torch.argsort(torch.where(elig, -viol, torch.inf), dim=-1,
                          stable=True)
    pick = elig & (torch.argsort(order, dim=-1) < guess_cap)
    up = ldpd.dupper < 0
    s_g = slot.slot_activate(s, pick & up, pick & ~up, st)
    return slot.select_lanes(s_g.status != EXIT_REFACTOR, s_g, s)


def _kernel_batch_core(H, f, A, bupper, blower, sense, st: Settings,
                       ms: int = 0, fact=None, has_soft: bool = False,
                       sw: Optional[SoftWeights] = None,
                       deadline=None, guess_cap=None) -> BatchResult:
    """Factor (or take ``fact`` = (Rinv, ok, reg_mask, eps_used)), build
    the LDP, solve and map back to QP space: on the slot tier (K2), or
    with ``has_soft`` on the dense-mask tier (B7), where soft rows carry
    rho_soft on their Gram diagonal, or with ``sw`` (raw user units,
    implies ``has_soft``) per-row slack bounds and per-side weights (B7's
    SOFT_WEIGHTS variant).  Without ``has_soft`` a lane with soft rows
    exits ``EXIT_UNSUPPORTED``.  ``guess_cap`` (hard batches, opt-in)
    starts a batch with no sense-ACTIVE row from ``_guess_activate``; the
    dense-mask tier ignores it, as the JAX package's does."""
    has_soft = has_soft or sw is not None
    B = H.shape[0]
    n = A.shape[-1]
    f32 = torch.float32
    if fact is None:
        fact = chol.batched_rinv_regularized(H, st)
    Rinv, okl, regl, eps_l = fact
    ldpd = transform.build_ldp(f, A, bupper, blower, sense, ms, st,
                               Rinv=Rinv)
    ldpd = ldpd._replace(
        error=torch.where(okl, ldpd.error, EXIT_NONCONVEX).to(torch.int32),
        n_prox=torch.where(regl, n, 0).to(torch.int32),
        eps_used=eps_l.to(ldpd.eps_used.dtype))
    immut = ((ldpd.sense & IMMUTABLE) > 0).to(f32)
    soft_b = ((ldpd.sense & SOFT) > 0).to(f32)
    # LDP-space dominance bound = 2 * fval_bound (daqp.c:10)
    fb = 2.0 * torch.full((B,), st.fval_bound, dtype=f32, device=H.device)
    act_bits = (ldpd.sense & ACTIVE) > 0
    lo_bits = act_bits & ((ldpd.sense & LOWER) > 0)
    if has_soft:
        s = dense.dense_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                             immut, soft_b, fbound=fb,
                             sw=None if sw is None
                             else transform.normalize_soft_weights(sw, ldpd))
        if host_any(act_bits):
            # equalities / warm starts: bulk-activate the sense-ACTIVE rows
            s = dense.dense_activate(s, act_bits & ~lo_bits, lo_bits, st)
        s = dense.dense_solve(s, st, n_true=n, deadline=deadline)
        act = s.act_up + s.act_lo
        lam = s.lam_star * act * s.scaling
        if sw is None:
            slack = st.rho_soft * (s.soft * act * s.lam_star
                                   * s.lam_star).sum(1)
        else:       # the active side's weight (batch.py:602-605)
            rho_w = s.act_lo * s.sw_rls + s.act_up * s.sw_rus
            slack = (s.soft * act * rho_w * s.lam_star * s.lam_star).sum(1)
    else:
        s = slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                           immut, n_true=n, fbound=fb)
        if host_any(act_bits):
            s = slot.slot_activate(s, act_bits & ~lo_bits, lo_bits, st)
        elif guess_cap:
            s = _guess_activate(s, ldpd, immut, guess_cap, st)
        s = slot.slot_solve(s, st, n_true=n, deadline=deadline)
        lam = slot.slot_duals_dense(s)
        slack = torch.zeros(B, dtype=f32, device=H.device)
    x = transform.ldp_to_qp_solution(ldpd, s.u[:, :n])
    fval = 0.5 * (s.fval - (ldpd.v * ldpd.v).sum(1))
    exitflag = torch.where(ldpd.error < 0, ldpd.error, s.status)
    if not has_soft:
        exitflag = torch.where((soft_b > 0).any(dim=1), EXIT_UNSUPPORTED,
                               exitflag)
    return BatchResult(x=x, lam=lam, fval=fval,
                       exitflag=exitflag.to(torch.int32),
                       iterations=s.iterations.to(torch.int32),
                       soft_slack=slack.to(x.dtype))


def solve_batch_kernel(H, f, A, bupper, blower, sense, st: Settings,
                       ms: int = 0, has_soft: Optional[bool] = None,
                       deadline=None, sw=None,
                       guess_cap=None, device=None) -> BatchResult:
    """Batched strictly convex QP solve on the kernel path, one call for
    the whole batch (``solve_batch_pallas_jit``).  On a CUDA device it
    launches K1 and K2, or K1 and B7 for a batch with soft rows; on the
    CPU their plain twins run.  ``has_soft=None`` detects soft rows from
    ``sense``; with ``has_soft=False`` a lane carrying soft rows exits
    ``EXIT_UNSUPPORTED``.  ``sw``: a ``SoftWeights`` of (B, m) fields in
    raw user units, the SOFT_WEIGHTS slack semantics on B7's SOFT_WEIGHTS
    variant (implies ``has_soft``).  ``guess_cap`` (opt-in, default off):
    a hard batch with no sense-ACTIVE row starts from its top
    ``guess_cap`` violated rows activated at once (``_guess_activate``)."""
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    sw = _sw_tensors(sw, H)
    if has_soft is None:
        has_soft = sw is not None or host_any((sense & SOFT) > 0)
    return _kernel_batch_core(H, f, A, bupper, blower, sense, st, ms=ms,
                              has_soft=bool(has_soft), sw=sw,
                              deadline=deadline, guess_cap=guess_cap)


def _sw_tensors(sw, like) -> Optional[SoftWeights]:
    """``sw`` (a SoftWeights of arrays or tensors, or None) as tensors on
    ``like``'s device; a field on another device raises."""
    if sw is None:
        return None
    fields = []
    for x in sw:
        if isinstance(x, torch.Tensor) and x.device != like.device:
            raise ValueError(f"sw on {x.device}, inputs on {like.device}")
        fields.append(torch.as_tensor(x, device=like.device))
    return SoftWeights(*fields)


def solve_batch_kernel_stream(H, f, A, bupper, blower, sense,
                              st: Settings, ms: int = 0, chunk: int = 256,
                              has_soft: bool = False, deadline=None,
                              sw=None, sort_stream: bool = False,
                              guess_cap=None, device=None) -> BatchResult:
    """Streaming solve (``solve_batch_pallas_stream_jit``): one global
    factorization of the whole batch through K1, then ``chunk``-lane
    solves that reuse it, on K2, or on B7 with ``has_soft``.
    ``sort_stream`` orders the stream by the difficulty proxy first
    (stable sort).  Each lane's result depends on that lane alone, so
    ``chunk`` and the order only bound memory and shape the waves; outputs
    come back in input order.  ``sw`` (raw user units, implies
    ``has_soft``) follows the sort and the chunks.  ``deadline`` is
    checked as each chunk's rounds start and between them.  ``guess_cap``
    as ``solve_batch_kernel``, chunk by chunk."""
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    sw = _sw_tensors(sw, H)
    B = H.shape[0]
    fact = chol.batched_rinv_regularized(H, st)
    order = None
    if sort_stream:
        nv = _difficulty_nviol(f, A, bupper, blower, ms, fact[0])
        order = torch.argsort(nv, stable=True)
        H, f, A, bupper, blower, sense = (
            x[order] for x in (H, f, A, bupper, blower, sense))
        fact = tuple(x[order] for x in fact)
        if sw is not None:
            sw = SoftWeights(*(x[order] for x in sw))
    parts = []
    for c0 in range(0, B, chunk):
        sl = slice(c0, c0 + chunk)
        parts.append(_kernel_batch_core(
            H[sl], f[sl], A[sl], bupper[sl], blower[sl], sense[sl], st,
            ms=ms, fact=tuple(x[sl] for x in fact), has_soft=has_soft,
            sw=None if sw is None else SoftWeights(*(x[sl] for x in sw)),
            deadline=deadline, guess_cap=guess_cap))
    out = BatchResult(*(torch.cat(p) for p in zip(*parts)))
    if order is not None:
        unsort = torch.argsort(order)
        out = BatchResult(*(x[unsort] for x in out))
    return out


LANE_CHUNK = 2048   # lanes a flat chunk: its steps are host-bound (PERF.md §6)


def factor_batch(H, st: Settings, graph: bool = False):
    """``transform.factorize_hessian`` of a batch, as the flat and ordered
    tiers and the flat horizon factor: the dense lanes of an f32 batch on
    the card through ``chol.batched_rinv_regularized`` (K1 or
    B10 by n), any other batch through the library's Cholesky, as the JAX
    flat tier factors (``daqp_tpu/transform.py:57``).  ``graph``: the
    retries' form with no host read (``torch.export``)."""
    dense_fn = None
    if H.is_cuda and H.dtype == torch.float32:
        def dense_fn(Hd, st_):
            return chol.batched_rinv_regularized(Hd, st_, graph=graph)
    return transform.factorize_hessian(H, st, dense=dense_fn, graph=graph)


def _flat_start(H, f, A, bupper, blower, sense, sw, ms: int, st: Settings,
                K: int, is_late: bool = False, graph: bool = False):
    """The flat tier up to ``flat_solve``: the transform, SOFT_WEIGHTS
    data normalized by the row scaling, the equality / warm activation,
    then the pre-status in the JAX order (transform error, failed
    activation, unconstrained shortcut, and with ``is_late`` TIMELIMIT
    for a chunk that starts past its deadline).  ``graph``: the host
    loops' forms with no host read.  Returns (LDP data, state)."""
    ldpd = transform.build_ldp(f, A, bupper, blower, sense, ms, st,
                               fact=factor_batch(H, st, graph))
    sw_n = None if sw is None else transform.normalize_soft_weights(sw, ldpd)
    s = ldp_flat.flat_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                           ldpd.scaling, K=K, sw=sw_n)
    s = (ldp_flat.flat_activate_graph if graph
         else ldp_flat.flat_activate)(s, st)
    unc_ok, _ = transform.check_unconstrained(
        ldpd._replace(sense=s.sense), st)
    pre = torch.where(ldpd.error < 0, ldpd.error, torch.where(
        s.status != EXIT_RUNNING, s.status,
        torch.where(unc_ok, EXIT_OPTIMAL, EXIT_RUNNING)))
    if is_late:
        pre = timed_out(pre, pre == EXIT_RUNNING)
    return ldpd, s._replace(status=pre.to(torch.int32))


def _flat_result(ldpd: transform.LDPData,
                 s: ldp_flat.FlatState) -> BatchResult:
    """The map back to x, lam, fval."""
    return BatchResult(
        x=transform.ldp_to_qp_solution(ldpd, s.u),
        lam=ldp_flat.flat_extract_duals(s),
        fval=0.5 * (s.fval - (ldpd.v * ldpd.v).sum(1)),
        exitflag=s.status, iterations=s.iterations,
        soft_slack=s.soft_slack)


def _solve_flat(H, f, A, bupper, blower, sense, sw, ms: int, st: Settings,
                K: int, is_late: bool = False) -> BatchResult:
    """A chunk of lanes on the flat tier (``_solve_one_flat``, batched):
    ``_flat_start``, ``flat_solve`` and the map back to x, lam, fval."""
    ldpd, s = _flat_start(H, f, A, bupper, blower, sense, sw, ms, st, K,
                          is_late)
    return _flat_result(ldpd, ldp_flat.flat_solve(s, st))


def solve_flat_graph(H, f, A, bupper, blower, sense, ms: int, st: Settings,
                     K: int):
    """``_solve_flat`` (no SOFT_WEIGHTS, no deadline) with no host read,
    the form ``torch.export`` traces (``codegen.export_aot``): the
    retries, the activation and the round loop in their graph forms, so
    each lane gets what ``_solve_flat`` gives it.  Returns (result, the
    rounds run as a 0-d tensor)."""
    ldpd, s = _flat_start(H, f, A, bupper, blower, sense, None, ms, st, K,
                          graph=True)
    s, r = ldp_flat.flat_solve_graph(s, st)
    return _flat_result(ldpd, s), r


def _lanes(x, sl):
    return None if x is None else type(x)(*(v[sl] for v in x))


def solve_batch_flat_jit(H, f, A, bupper, blower, sense, st: Settings,
                         ms: int = 0, K: Optional[int] = None,
                         lane_chunk: int = LANE_CHUNK, sw=None,
                         deadline=None, device=None) -> BatchResult:
    """Batched strictly convex QP solve on the flat tier (``ldp_flat``),
    in the inputs' dtype, in chunks of ``lane_chunk`` lanes: a chunk's
    rounds last as long as its slowest lane, and a lane's result depends
    on that lane alone.  Not jitted: the name is the JAX package's.

    For batches with SOFT rows pass K = n + max_ns + 1 (the reference's
    per-instance allocation, api.c:288-305; ``solve_batch`` computes it);
    the default K = n + 1 turns a soft working set past n + 1 into a
    pending add and CYCLE, never a silent overwrite.  ``sw``: a
    ``SoftWeights`` of (B, m) fields in raw user units (SOFT_WEIGHTS,
    auxiliary.c:199-274).  ``deadline`` (absolute ``time.perf_counter()``
    seconds) is read from the host's clock as each chunk starts: a chunk
    starting past it returns TIMELIMIT on its lanes."""
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    sw = _sw_tensors(sw, H)
    B, n = H.shape[0], H.shape[-1]
    K = n + 1 if K is None else K
    parts = []
    for c0 in range(0, B, lane_chunk):
        sl = slice(c0, c0 + lane_chunk)
        parts.append(_solve_flat(H[sl], f[sl], A[sl], bupper[sl],
                                 blower[sl], sense[sl], _lanes(sw, sl), ms,
                                 st, K, late(deadline)))
    return BatchResult(*(torch.cat(p) for p in zip(*parts)))


def solve_batch_jit(H, f, A, bupper, blower, sense, st: Settings,
                    ms: int = 0, K: Optional[int] = None,
                    repair_rounds: int = 2, device=None) -> BatchResult:
    """Batched strictly convex QP solve on the ordered tier: the batch
    factored at once (as the flat tier), then lane after lane the
    single-instance state (``ldp``), activated, its loop in batch mode and
    ``repair_rounds`` rounds of ``ldp.batch_post_pass``
    (``ldp_solve_batched_lane``), the port's form of the JAX package's
    vmap of ``_solve_one``.  K: as ``solve_batch_flat_jit``."""
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    B, n = H.shape[0], A.shape[-1]
    K = n + 1 if K is None else K
    ldpd_b = transform.build_ldp(f, A, bupper, blower, sense, ms, st,
                                 fact=factor_batch(H, st))
    outs = []
    for b in range(B):
        ldpd = core.lane(_lanes(ldpd_b, slice(b, b + 1)))
        _, state, _, _ = core.start(ldpd, st, K)
        state = ldp_mod.ldp_solve_batched_lane(state, st,
                                               rounds=repair_rounds)
        outs.append(core.extract(ldpd, state))
    dev = H.device
    return BatchResult(
        x=torch.stack([o.x for o in outs]),
        lam=torch.stack([o.lam for o in outs]),
        fval=torch.stack([o.fval for o in outs]),
        exitflag=torch.tensor([o.exitflag for o in outs], dtype=torch.int32,
                              device=dev),
        iterations=torch.tensor([o.iterations for o in outs],
                                dtype=torch.int32, device=dev),
        soft_slack=torch.stack([o.soft_slack for o in outs]))


def batch_route(dtype, n: int, m: int, has_soft: bool, has_sw: bool,
                limit: int) -> str:
    """Where ``solve_batch`` sends a batch, decided from its type and
    shapes before anything is launched on a card whose blocks may opt in
    to ``limit`` bytes of shared memory: "kernel" (the stream: K1, then
    K2, or B7 / B7-sw with soft rows or SOFT_WEIGHTS data) for an f32
    batch that K1 or B10 factors (``chol.factor_route``) and whose LDP
    block fits (``smem.slot_floats`` at K = n + 1, ``smem.dense_floats``);
    "flat" for the rest: f64 batches and shapes past a block."""
    if dtype != torch.float32 or chol.factor_route(n, limit) == "library":
        return "flat"
    floats = smem.dense_floats(m, n, has_sw) if has_soft or has_sw \
        else smem.slot_floats(m, n, n + 1)
    return "kernel" if smem.F32 * floats <= limit else "flat"


def solve_batch(H, f, A, bupper, blower, sense=None, ms: int = 0,
                settings=None, soft_weights=None,
                device=None) -> BatchResult:
    """The batched entry of the quick start (``daqp_tpu.solve_batch``):
    dense strictly convex QPs with a leading batch dimension.

    ``settings``: a ``Settings``, a dict of overrides or None (the
    defaults for H's dtype); its ``time_limit`` > 0 becomes a deadline.
    ``soft_weights``: SOFT_WEIGHTS data, a ``SoftWeights`` of (B, m)
    fields or a dict of them (missing keys: d 0, rho ``rho_soft``).
    ``batch_route`` picks the tier: an f32 batch that fits the kernels'
    blocks runs the kernel stream, anything else the flat tier with K =
    n + max_ns + 1 (the reference allocates n + ns + 1 per instance,
    api.c:288-305, and a soft working set may outgrow n + 1)."""
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    B, n = H.shape[0], H.shape[-1]
    m = bupper.shape[-1]
    dtype = H.dtype
    st = as_settings(settings, dtype)
    deadline = time.perf_counter() + float(st.time_limit) \
        if float(st.time_limit) > 0 else None
    sw = None
    if isinstance(soft_weights, dict):
        zm = torch.zeros((B, m), dtype=dtype, device=H.device)
        rm = torch.full((B, m), float(st.rho_soft), dtype=dtype,
                        device=H.device)
        sw = SoftWeights(*(torch.as_tensor(
            soft_weights.get(k, dflt), device=H.device).to(dtype)
            for k, dflt in zip(SoftWeights._fields, (zm, zm, rm, rm))))
    elif soft_weights is not None:
        sw = SoftWeights(*(x.to(dtype) for x in _sw_tensors(soft_weights,
                                                             H)))
    max_ns = int(host_read(((sense & SOFT) > 0).sum(1).amax())) \
        if B and m else 0
    route = batch_route(dtype, n, m, max_ns > 0, sw is not None,
                        smem.limit(H.device))
    if route == "kernel":
        return solve_batch_kernel_stream(
            H, f, A, bupper, blower, sense, st, ms=ms,
            has_soft=max_ns > 0 or sw is not None, deadline=deadline, sw=sw)
    return solve_batch_flat_jit(H, f, A, bupper, blower, sense, st, ms=ms,
                                K=n + max_ns + 1, sw=sw, deadline=deadline)


PSEG = 8            # proximal passes per B4 launch
PROX_STEPS = 64     # inner iterations per proximal pass
prox_resumed_lanes = 0  # lanes resumed on the per-pass path after B4


def prox_init(H, f, A, bupper, blower, sense, st: Settings, ms: int = 0):
    """The proximal driver's set-up, f32: K1's regularized factorization,
    the LDP, the shift eps per lane (0 where H is PD), the fixed-point
    tolerance eta / eps, the cold slot state and the scaled user bounds.
    Returns ``(Rinv, ok, ldpd, eps, tol_stat, s, bu_s, bl_s)``."""
    f32 = torch.float32
    H, f, A, bupper, blower = (x.to(f32) for x in (H, f, A, bupper, blower))
    n = H.shape[-1]
    Rinv, okl, regl, eps_l = chol.batched_rinv_regularized(H, st)
    ldpd = transform.build_ldp(f, A, bupper, blower, sense, ms, st,
                               Rinv=Rinv)
    eps = torch.where(regl, eps_l, 0.0).to(f32)
    tol_stat = torch.tensor(auto_eta(st), dtype=f32, device=H.device) \
        / torch.clamp(eps, min=1e-30)
    immut = ((ldpd.sense & IMMUTABLE) > 0).to(f32)
    s = slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                       n_true=n)
    return (Rinv, okl, ldpd, eps, tol_stat, s,
            (bupper * ldpd.scaling).contiguous(),
            (blower * ldpd.scaling).contiguous())


def solve_batch_prox_kernel(H, f, A, bupper, blower, sense, st: Settings,
                            ms: int = 0, max_outer: int = 200,
                            fused: bool = True, deadline=None,
                            device=None) -> BatchResult:
    """Batched semidefinite-H QP solve: the proximal-point outer loop
    (``daqp_prox.c`` full-shift regime) over the slot tier, as
    ``solve_batch_prox_pallas_jit``.

    K1 factors every H with the retry-doubling shift
    (``chol.batched_rinv_regularized``); lanes that needed it iterate
    x <- argmin of the shifted QP centred at x until ||x_new - x||_inf <
    eta / eps (with stagnation acceptance and 1.5x over-relaxation), the
    others converge after one pass.  ``fused=True`` runs ``PSEG`` passes
    per B4 launch (``ops.slot.run_prox_segment``; its twin on the CPU),
    resumes the lanes that failed inside a segment on the per-pass path
    (the other lanes keep their segment results), Newton-refreshes E per
    segment and ends with one hygiene pass with the full repair and
    polish.
    ``fused=False`` runs every pass as a warm ``slot_solve`` on K2.
    Hard constraints only; lanes the factorization rejects exit
    NONCONVEX, lanes still running after ``max_outer`` passes
    ITERLIMIT, and past ``deadline`` (checked per pass and per segment)
    TIMELIMIT."""
    global prox_resumed_lanes
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    f32 = torch.float32
    H, f = H.to(f32), f.to(f32)
    B, n = H.shape[0], H.shape[-1]
    dev = H.device
    Rinv, okl, ldpd, eps, tol_stat, s, bu_s, bl_s = prox_init(
        H, f, A, bupper, blower, sense, st, ms)

    def v_of(x):
        return torch.einsum('bji,bj->bi', Rinv, f - eps[:, None] * x)

    def carry_solve(s, v, lane_run, deadline=None):
        Mv = torch.einsum('bmj,bj->bm', s.M, v)
        s = slot.reset_control(slot.slot_refresh_bounds(s, bu_s + Mv,
                                                        bl_s + Mv), lane_run)
        return slot.slot_solve(s, st, n_true=n, steps=PROX_STEPS,
                               deadline=deadline)

    def passes(budget, s, x, lane_run, stall, best_diff, lane_flag, tot):
        """The per-pass outer loop (``batch.py:806-857``) on K2."""
        for _ in range(budget):
            if late(deadline):
                lane_flag = timed_out(lane_flag, lane_run)
                lane_run = torch.zeros_like(lane_run)
                break
            if not host_any(lane_run):
                break
            v = v_of(x)
            s = carry_solve(s, v, lane_run, deadline)
            tot = tot + torch.where(lane_run, s.iterations, 0.0)
            inner_ok = s.status > 0
            x_new = torch.einsum('bij,bj->bi', Rinv, s.u - v)
            max_diff = (x_new - x).abs().amax(1)
            improved = max_diff < 0.9 * best_diff
            best_diff = torch.minimum(max_diff, best_diff)
            stall = torch.where(improved | ~lane_run, 0, stall + 1)
            converged = (eps == 0) | (max_diff < tol_stat) | (stall >= 8)
            froze = (s.iterations <= 1) & ~converged & inner_ok
            x = torch.where(lane_run[:, None],
                            torch.where(froze[:, None],
                                        x + 1.5 * (x_new - x), x_new), x)
            done = lane_run & (converged | ~inner_ok)
            lane_flag = torch.where(
                done, torch.where(inner_ok, EXIT_OPTIMAL, s.status),
                lane_flag).to(torch.int32)
            lane_run = lane_run & ~done
        return s, x, lane_run, stall, best_diff, lane_flag, tot

    x = torch.zeros((B, n), dtype=f32, device=dev)
    lane_flag = torch.where(okl, EXIT_RUNNING, EXIT_NONCONVEX).to(torch.int32)
    stall = torch.zeros(B, dtype=f32, device=dev)
    best_diff = torch.full((B,), float("inf"), dtype=f32, device=dev)
    tot = torch.zeros(B, dtype=f32, device=dev)
    if not fused:
        s, x, lane_run, _, _, lane_flag, tot = passes(
            max_outer, s, x, okl, stall, best_diff, lane_flag, tot)
    else:
        lr = okl.to(f32)
        for _ in range(0, max_outer, PSEG):
            if late(deadline):
                lane_flag = timed_out(lane_flag, lr > 0)
                lr = torch.zeros_like(lr)
                break
            if not host_any(lr > 0):
                break
            s, x, lr, stall, best_diff, lane_flag, tot, failed = \
                slot.run_prox_segment(s, x, lr, stall, best_diff, lane_flag,
                                      tot, Rinv, f, bu_s, bl_s, eps,
                                      tol_stat, st, n, P=PSEG,
                                      steps=PROX_STEPS)
            failed = failed > 0
            if host_any(failed):
                prox_resumed_lanes += int(failed.sum())
                # per-lane resume of the lanes that froze in the segment
                r = passes(PSEG, s, x, failed, stall, best_diff, lane_flag,
                           tot)
                s = slot.select_lanes(failed, r[0], s)
                x, lr, stall, best_diff, lane_flag, tot = (
                    torch.where(failed.view((-1,) + (1,) * (a.dim() - 1)),
                                a.to(b.dtype), b)
                    for a, b in zip(r[1:], (x, lr, stall, best_diff,
                                            lane_flag, tot)))
            s = slot.newton_refresh(s)
        lane_run = lr > 0
        # final hygiene pass: the in-kernel passes run without the
        # between-round polish, so one warm pass with the full repair and
        # polish at the final v tightens the last inner solve
        fin = lane_flag == EXIT_OPTIMAL
        v_fin = v_of(x)
        s = carry_solve(s, v_fin, fin)
        ok_fin = fin & (s.status > 0)
        x_fin = torch.einsum('bij,bj->bi', Rinv, s.u - v_fin)
        x = torch.where(ok_fin[:, None], x_fin, x)
        tot = tot + torch.where(fin, s.iterations, 0.0)
    lane_flag = torch.where(lane_run, EXIT_ITERLIMIT, lane_flag)
    lane_flag = torch.where(ldpd.error < 0, ldpd.error, lane_flag)
    fval = 0.5 * torch.einsum('bi,bij,bj->b', x, H, x) \
        + torch.einsum('bi,bi->b', f, x)
    return BatchResult(x=x, lam=slot.slot_duals_dense(s), fval=fval,
                       exitflag=lane_flag.to(torch.int32),
                       iterations=tot.to(torch.int32),
                       soft_slack=torch.zeros(B, dtype=f32, device=dev))


# f32 conditioning floor of the hierarchical tier's level penalty
# (daqp_tpu/batch.py:32 _HIQP_RHO_FLOOR): a conflicting soft add's Schur
# pivot is ~rho, and rank-one updates through it amplify f32 rounding by
# 1/rho
HIQP_RHO_FLOOR = 3e-2


def hiqp_settings(st: Settings, rho_floor: float = None) -> Settings:
    """``st`` with rho_soft raised to the hierarchical tier's floor
    (``rho_floor``, default ``HIQP_RHO_FLOOR``; batch.py:2091-2093)."""
    floor = HIQP_RHO_FLOOR if rho_floor is None else float(rho_floor)
    return st._replace(rho_soft=max(float(st.rho_soft), floor))


def solve_batch_hiqp_kernel(H, f, A, bupper, blower, sense, st: Settings,
                            ms: int = 0, break_points: tuple = (),
                            rho_floor: float = None, deadline=None,
                            device=None) -> BatchResult:
    """Batched hierarchical (lexicographic least-squares) QP solve on B7:
    the level walk of ``daqp_hiqp`` (hierarchical.c:5-108) as
    ``solve_batch_hiqp_pallas_jit`` runs it.

    Per level: the level's rows turn SOFT (uniform rho_soft, floored at
    ``rho_floor``, default ``HIQP_RHO_FLOOR``) and later rows IMMUTABLE;
    the lanes still walking re-solve warm on the dense tier; the level's
    optimal soft violations w = lam* rho are frozen into d with a +-ptol
    margin (hierarchical.c:51-65) and reported as output duals; the level
    turns hard.  Between levels the working set is rebuilt by sequential
    re-adds that drop dependent entries (``dense_reactivate``,
    hierarchical.c:72-95), E gets one Newton refresh, and a lane whose
    degrees of freedom are spent stops.  A lane whose level fails exits
    ``EXIT_NO_DOF`` with the previous level's point; one over
    ``iter_limit`` exits ITERLIMIT.  A lane still walking when a level
    starts past ``deadline``, or whose level solve ran past it, exits
    TIMELIMIT with the previous level's point.

    ``break_points`` is strictly increasing and ends at m, shared by the
    batch.  ``H=None`` is the identity metric and then fval = f'x.  Warm
    ACTIVE bits are honored for the rows before ``break_points[0]``."""
    dev = resolve_device((H, f, A, bupper, blower, sense), device)
    f32 = torch.float32

    def t(x, dtype=f32):
        return None if x is None else torch.as_tensor(x, device=dev).to(dtype)

    A, bupper, blower = t(A), t(bupper), t(blower)
    if A.dim() == 2:
        A = A[..., None]
    B, m = bupper.shape
    n = A.shape[-1] if A.numel() else (H.shape[-1] if H is not None else ms)
    bp = tuple(int(b) for b in break_points)
    if len(bp) < 2 or bp[-1] != m or any(a >= b for a, b in zip(bp, bp[1:])):
        raise ValueError(f"break_points {bp} must increase strictly and end "
                         f"at m = {m}")
    st = hiqp_settings(st, rho_floor)
    H_b = torch.eye(n, dtype=f32, device=dev).expand(B, n, n) \
        if H is None else t(H)
    f_b = torch.zeros((B, n), dtype=f32, device=dev) if f is None else t(f)
    sense = torch.zeros((B, m), dtype=torch.int32, device=dev) \
        if sense is None else t(sense, torch.int32)
    ldpd = transform.build_ldp(f_b, A, bupper, blower, sense, ms, st,
                               H=H_b)
    immut_base = ((ldpd.sense & IMMUTABLE) > 0).to(f32)
    s = dense.dense_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling,
                         immut_base)
    rows = torch.arange(m, device=dev)

    # pre-hierarchy hard warm / equality rows (< bp[0])
    act_bits = ((ldpd.sense & ACTIVE) > 0) & (rows < bp[0])
    if host_any(act_bits):
        lo_bits = act_bits & ((ldpd.sense & LOWER) > 0)
        s = dense.dense_activate(s, act_bits & ~lo_bits, lo_bits, st)

    lam_out = torch.zeros((B, m), dtype=f32, device=dev)
    lane_flag = torch.where(ldpd.error < 0, ldpd.error,
                            EXIT_RUNNING).to(torch.int32)
    done = lane_flag != EXIT_RUNNING
    nfree = torch.full((B,), float(n), dtype=f32, device=dev)
    u_best = s.u
    tot = torch.zeros(B, dtype=f32, device=dev)
    rho, ptol = st.rho_soft, st.primal_tol
    for i in range(1, len(bp)):
        if late(deadline):
            lane_flag = timed_out(lane_flag, ~done)
            break
        start, end = bp[i - 1], bp[i]
        lvl = ((rows >= start) & (rows < end)).to(f32).expand(B, m)
        beyond = (rows >= end).to(f32)
        lane_run = ~done
        run_m = lane_run.to(f32)[:, None]
        u_prev = s.u
        # lanes that stopped walking are held out of the level's solve
        prev_status = s.status
        held = torch.where(lane_run, EXIT_RUNNING, slot._HELD)
        s = s._replace(
            soft=lvl.contiguous(),
            immut=torch.clamp(immut_base + beyond, max=1.0),
            status=held.to(torch.int32),
            iterations=torch.zeros_like(s.iterations),
            cycle=torch.zeros_like(s.cycle),
            repaired=torch.zeros_like(s.repaired),
            best_fval=torch.full_like(s.best_fval, -1.0),
            pend=s.pend * (1.0 - run_m[:, 0]))
        s = dense.dense_solve(s, st, n_true=n, deadline=deadline)
        s = s._replace(status=torch.where(lane_run, s.status,
                                          prev_status).to(torch.int32))
        tot = tot + torch.where(lane_run, s.iterations, 0.0)
        failed = lane_run & (s.status < 0)
        late_lane = failed & (s.status == EXIT_TIMELIMIT)

        # freeze the level's optimal soft violations into d, with the
        # symmetric ptol margin of the JAX tier (batch.py:2161-2178), and
        # record them as the level's duals
        act = s.act_up + s.act_lo
        wv = s.lam_star * rho * act * s.soft
        s = s._replace(
            dupper=(s.dupper + (torch.where(wv > ptol, wv, 0.0)
                                + ptol * lvl) * run_m).contiguous(),
            dlower=(s.dlower + (torch.where(wv < -ptol, wv, 0.0)
                                - ptol * lvl) * run_m).contiguous())
        soft_act = (act * s.soft > 0) & lane_run[:, None]
        lam_out = torch.where(soft_act, wv, lam_out)

        # harden the level (hierarchical.c:68)
        s = s._replace(soft=torch.zeros_like(s.soft))
        if i < len(bp) - 1:
            s2, n_imm = dense.dense_reactivate(s, st, n, start)
            s2 = dense.newton_refresh(s2, st)
            s = dense.select_lanes(lane_run, s2, s)
            nfree = nfree - torch.where(lane_run, n_imm, 0.0)

        iterlim = lane_run & ~failed & (tot >= st.iter_limit)
        lane_flag = torch.where(failed, torch.where(
            late_lane, EXIT_TIMELIMIT, EXIT_NO_DOF), lane_flag)
        lane_flag = torch.where(iterlim, EXIT_ITERLIMIT, lane_flag)
        u_best = torch.where(lane_run[:, None],
                             torch.where(failed[:, None], u_prev, s.u),
                             u_best)
        done = done | failed | iterlim | (nfree <= 0)

    x = transform.ldp_to_qp_solution(ldpd, u_best)
    if H is None and f is not None:
        fval = (f_b * x).sum(1)
    else:
        fval = 0.5 * ((u_best * u_best).sum(1) - (ldpd.v * ldpd.v).sum(1))
    lane_flag = torch.where(lane_flag == EXIT_RUNNING, EXIT_OPTIMAL,
                            lane_flag)
    return BatchResult(x=x, lam=lam_out, fval=fval,
                       exitflag=lane_flag.to(torch.int32),
                       iterations=torch.clamp(tot, min=1.0).to(torch.int32),
                       soft_slack=torch.zeros(B, dtype=f32, device=dev))


AVI_STEPS = 64           # inner iterations per AVI pass
avi_kkt_services = 0     # exact KKT steps serviced between B5 segments
avi_resumed_lanes = 0    # lanes resumed on the per-pass path after B5


def _lu_solve(lu, b):
    """(H's LU, pivots) from ``torch.linalg.lu_factor_ex``, solved against
    (B, n) or (B, n, k) right-hand sides."""
    if b.dim() == 2:
        return torch.linalg.lu_solve(lu[0], lu[1], b[..., None])[..., 0]
    return torch.linalg.lu_solve(lu[0], lu[1], b)


class AVIProblem(NamedTuple):
    """The batched AVI's data as the KKT step reads it, f32: H, f, the
    rows [I_ms; A] with their raw bounds, and H's LU."""
    H: torch.Tensor          # (B, n, n)
    f: torch.Tensor          # (B, n)
    Aall: torch.Tensor       # (B, m, n)
    bu: torch.Tensor         # (B, m)
    bl: torch.Tensor         # (B, m)
    H_lu: tuple              # (LU (B, n, n), pivots (B, n))


def kkt_all(s: slot.SlotState, lane_do, p: AVIProblem, st: Settings):
    """The exact KKT step of the batched AVI on the original asymmetric H
    over each lane's slot working set (avi.c:103-184; ``batch.py:1699-
    1750``): the Schur system A_W H^-1 A_W' lam = -(b_W + A_W H^-1 f),
    x = H^-1 (-f - A_W' lam), then the verification (avi.c:187-221): dual
    signs on mutable slots, primal feasibility of the inactive rows, and
    the stationarity residual ||H x + f + A_W' lam||_inf < 1e-3 (1 +
    ||f||_inf), without which an ill-conditioned f32 Schur solve could
    certify an x 1.3e-2 off.  Returns ``(x, lamK (B, K), certified)``,
    ``certified`` within ``lane_do``."""
    f32 = torch.float32
    m = p.bu.shape[1]
    iota_m = torch.arange(m, dtype=f32, device=p.H.device)
    used, slo = s.used, s.slo
    oh = (s.sid[:, :, None] == iota_m).to(f32) * used[:, :, None]
    Aw = torch.einsum('bkm,bmn->bkn', oh, p.Aall)              # (B, K, n)
    S = torch.matmul(Aw, _lu_solve(p.H_lu, Aw.transpose(1, 2)))
    S = S * (used[:, :, None] * used[:, None, :]) \
        + torch.diag_embed(1.0 - used)
    b_sel = torch.einsum('bkm,bm->bk', oh, p.bl) * slo \
        + torch.einsum('bkm,bm->bk', oh, p.bu) * (1.0 - slo)
    rhs = -(b_sel + torch.einsum('bkn,bn->bk', Aw,
                                 _lu_solve(p.H_lu, p.f))) * used
    lamK = torch.linalg.solve_ex(S, rhs[..., None])[0][..., 0] * used
    x = _lu_solve(p.H_lu, -p.f - torch.einsum('bkn,bk->bn', Aw, lamK))
    mutable = used * (1.0 - s.simm) > 0
    sign_ok = torch.where(slo > 0, lamK <= st.dual_tol,
                          lamK >= -st.dual_tol)
    dual_ok = (sign_ok | ~mutable).all(1)
    r = torch.einsum('bmn,bn->bm', p.Aall, x)
    act = (s.act_up + s.act_lo)[:, :m] > 0
    feas = (r <= p.bu + st.primal_tol) & (r >= p.bl - st.primal_tol)
    primal_ok = (feas | act).all(1)
    g_res = torch.einsum('bij,bj->bi', p.H, x) + p.f \
        + torch.einsum('bkn,bk->bn', Aw, lamK)
    stat_ok = g_res.abs().amax(1) < 1e-3 * (1.0 + p.f.abs().amax(1))
    return x, lamK, lane_do & dual_ok & primal_ok & stat_ok


class AVISetup(NamedTuple):
    """The batched AVI's set-up (``batch.py:1640-1687``), f32."""
    prob: AVIProblem
    rho: torch.Tensor        # (B,) the DR step
    Hsym: torch.Tensor       # (B, n, n) sym(H)
    Hs_rho: torch.Tensor     # (B, n, n) sym(H) + rho I, the QP metric
    H_rho_lu: tuple          # LU of H + rho I
    ldpd: transform.LDPData  # the projection QP's LDP (v = 0)
    s: slot.SlotState        # cold slot state
    bu_s: torch.Tensor       # (B, m) user bounds times the row scaling
    bl_s: torch.Tensor
    x_unc: torch.Tensor      # (B, n) unconstrained point H^-1 (-f)
    unc_ok: torch.Tensor     # (B,) it is feasible: the lane is solved


def avi_init(H, f, A, bupper, blower, sense, st: Settings, ms: int = 0,
             device=None) -> AVISetup:
    """Per lane rho = sqrt(min diag(sym H) * max row sum |sym H|), else
    ||H||_F / 2 (``batch.py:1647-1654``); the LUs of H and H + rho I
    (library calls: the JAX tier does this part in XLA); the LDP of the
    projection QP in the sym(H) + rho I metric with v = 0 (v is set per
    pass); the cold slot state; the scaled bounds; and the unconstrained
    shortcut (utils.c:547-551)."""
    dev = resolve_device((H, f, A, bupper, blower, sense), device)
    f32 = torch.float32

    def t(x, dtype=f32):
        return torch.as_tensor(x, device=dev).to(dtype)

    H, f, A, bu, bl = (t(x) for x in (H, f, A, bupper, blower))
    if A.dim() == 2:
        A = A[..., None]
    B, n = H.shape[0], H.shape[-1]
    m = bu.shape[-1]
    sense = torch.zeros((B, m), dtype=torch.int32, device=dev) \
        if sense is None else t(sense, torch.int32)
    eye = torch.eye(n, dtype=f32, device=dev)
    Hsym = 0.5 * (H + H.transpose(1, 2))
    min_diag = torch.diagonal(Hsym, dim1=1, dim2=2).amin(1)
    max_rs = Hsym.abs().sum(2).amax(1)
    fro = torch.sqrt((H * H).sum((1, 2)))
    rho = torch.where((min_diag > 0) & (max_rs > 0),
                      torch.sqrt(torch.clamp(min_diag * max_rs, min=1e-30)),
                      fro / 2)
    Hs_rho = Hsym + rho[:, None, None] * eye
    Aall = torch.cat([eye[:ms].expand(B, ms, n), A], dim=1) if ms else A
    prob = AVIProblem(H=H, f=f, Aall=Aall, bu=bu, bl=bl,
                      H_lu=torch.linalg.lu_factor_ex(H)[:2])
    ldpd = transform.build_ldp(torch.zeros_like(f), A, bu, bl, sense, ms,
                               st, H=Hs_rho)
    immut = ((ldpd.sense & IMMUTABLE) > 0).to(f32)
    s = slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                       n_true=n)
    x_unc = _lu_solve(prob.H_lu, -f)
    r_unc = torch.einsum('bmn,bn->bm', Aall, x_unc)
    unc_ok = ((r_unc <= bu + st.primal_tol)
              & (r_unc >= bl - st.primal_tol)).all(1) \
        & ~((ldpd.sense & (ACTIVE | IMMUTABLE)) > 0).any(1)
    return AVISetup(
        prob=prob, rho=rho, Hsym=Hsym, Hs_rho=Hs_rho,
        H_rho_lu=torch.linalg.lu_factor_ex(H + rho[:, None, None] * eye)[:2],
        ldpd=ldpd, s=s, bu_s=(bu * ldpd.scaling).contiguous(),
        bl_s=(bl * ldpd.scaling).contiguous(), x_unc=x_unc, unc_ok=unc_ok)


def avi_segment_operands(a: AVISetup):
    """B5's per-lane matrices and vectors: (Rinv, G1 = H - sym(H) - rho I,
    G2 = sym(H)/2 + rho I, G3 = H - sym(H)/2, Hri = (H + rho I)^-1, f,
    bu_s, bl_s) (``batch.py:1855-1872`` without the padding)."""
    H, n = a.prob.H, a.prob.H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Hri = _lu_solve(a.H_rho_lu, eye.expand_as(H))
    return (a.ldpd.Rinv.contiguous(), (H - a.Hs_rho).contiguous(),
            (0.5 * a.Hsym + a.rho[:, None, None] * eye).contiguous(),
            (H - 0.5 * a.Hsym).contiguous(), Hri.contiguous(),
            a.prob.f.contiguous(), a.bu_s, a.bl_s)


def avi_carries(a: AVISetup):
    """The cold carries of ``slot.AVI_LANE``: x = y = xold = 0, minres
    INF, ctr 0, tlim 5, lane_run (not failed by the transform, not solved
    by the shortcut), lflag and tot 0."""
    B, n = a.prob.f.shape
    dev = a.prob.f.device
    zn = torch.zeros((B, n), dtype=torch.float32, device=dev)
    zb = torch.zeros(B, dtype=torch.float32, device=dev)
    err = a.ldpd.error
    flag = torch.where(err < 0, err, torch.where(a.unc_ok, EXIT_OPTIMAL,
                                                 EXIT_RUNNING))
    return (zn, zn, zn, torch.full_like(zb, DAQP_INF), zb,
            torch.full_like(zb, 5.0), ((err >= 0) & ~a.unc_ok).to(zb.dtype),
            flag.to(torch.int32), zb)


def solve_batch_avi_kernel(H, f, A, bupper, blower, sense, st: Settings,
                           ms: int = 0, max_outer: int = 500,
                           fused: bool = True, deadline=None,
                           device=None) -> BatchResult:
    """Batched affine variational inequalities (find x with
    H x + f + A' lam = 0 and lam complementary to l <= A x <= u, H
    asymmetric): the Douglas-Rachford splitting of ``daqp_solve_avi``
    (avi.c:6-101) over one slot state for the whole batch, as
    ``solve_batch_avi_pallas_jit`` (``batch.py:1587``).

    Per lane rho = sqrt(min diag(sym H) * max row sum |sym H|), else
    ||H||_F / 2.  Each pass solves the projection QP in the sym(H) + rho I
    metric warm on the slot tier; a lane whose inner set was stable for
    ``tlim`` passes gets the exact KKT step on the original H
    (``kkt_all``), which certifies it optimal or lets it iterate on; a
    Newton step that increased the residual is reverted (avi.c:44-61).
    Lanes whose unconstrained point is feasible exit at once.

    ``fused=True`` runs ``PSEG`` passes per B5 launch
    (``ops.slot.run_avi_segment``; its twin on the CPU), services the KKT
    requests between segments, resumes lanes that failed inside a
    segment on the per-pass path for PSEG passes, and Newton-refreshes E.
    ``fused=False`` runs every pass as a warm ``slot_solve`` on K2.  Hard
    rows only; a lane still running after ``max_outer`` passes exits
    ITERLIMIT, and past ``deadline`` (checked per pass and per segment)
    TIMELIMIT.  lam is the KKT step's, scattered to rows (0 on a lane the
    KKT step never reached); fval = f'x."""
    global avi_kkt_services, avi_resumed_lanes
    a = avi_init(H, f, A, bupper, blower, sense, st, ms, device)
    H, f, prob, Rinv = a.prob.H, a.prob.f, a.prob, a.ldpd.Rinv
    B, n = f.shape
    m = prob.bu.shape[1]
    dev = f.device
    f32 = torch.float32

    def mv(M_, w):
        return torch.einsum('bij,bj->bi', M_, w)

    def passes(budget, s, x, y, xold, lamK, minres, ctr, tlim, lane_run,
               flag, tot):
        """The per-pass outer loop (``batch.py:1757-1820``) on K2."""
        for _ in range(budget):
            if late(deadline):
                flag = timed_out(flag, lane_run)
                lane_run = torch.zeros_like(lane_run)
                break
            if not host_any(lane_run):
                break
            Hx = mv(H, x)
            v = torch.einsum('bji,bj->bi', Rinv, Hx + f - mv(a.Hs_rho, x))
            Mv = torch.einsum('bmj,bj->bm', s.M, v)
            s = slot.reset_control(slot.slot_refresh_bounds(
                s, a.bu_s + Mv, a.bl_s + Mv), lane_run)
            # lanes that do not run (never started, stopped, or kept out
            # of a resume) are held out of the solve
            held = ~lane_run & (s.status == EXIT_RUNNING)
            s = s._replace(status=torch.where(held, slot._HELD, s.status)
                           .to(torch.int32))
            s = slot.slot_solve(s, st, n_true=n, steps=AVI_STEPS,
                                deadline=deadline)
            s = s._replace(status=torch.where(held, EXIT_RUNNING, s.status)
                           .to(torch.int32))
            tot = tot + torch.where(lane_run, s.iterations, 0.0)
            inner_ok = s.status > 0
            y_in = mv(Rinv, s.u - v)
            # Newton-step progress bookkeeping (avi.c:44-61)
            at_limit = ctr == tlim
            res2 = ((x - y_in) ** 2).sum(1)
            worse = at_limit & (res2 > minres)
            x = torch.where(worse[:, None], xold, x)
            tlim = torch.where(worse, torch.clamp(tlim + 5.0, max=30.0),
                               tlim)
            minres = torch.where(at_limit & ~worse, res2, minres)
            y = torch.where((at_limit & worse)[:, None], y, y_in)
            stable = s.iterations <= 1
            ctr = torch.where(stable & lane_run, ctr + 1.0, 0.0)
            do_kkt = stable & (ctr == tlim) & lane_run & inner_ok
            if host_any(do_kkt):
                x_kkt, lam_new, opt = kkt_all(s, do_kkt, prob, st)
                xold = torch.where(do_kkt[:, None], x, xold)
                x = torch.where(do_kkt[:, None], x_kkt, x)
                lamK = torch.where(do_kkt[:, None], lam_new, lamK)
                flag = torch.where(opt & (flag == EXIT_RUNNING),
                                   EXIT_OPTIMAL, flag)
            # DR update for the running non-KKT lanes (avi.c:84-96)
            x_dr = _lu_solve(a.H_rho_lu, a.rho[:, None] * y + Hx
                             + 0.5 * mv(a.Hsym, y - x))
            move = lane_run & ~do_kkt & inner_ok
            x = torch.where(move[:, None], x_dr, x)
            flag = torch.where(lane_run & ~inner_ok, s.status, flag)
            done = lane_run & ((flag != EXIT_RUNNING) | ~inner_ok)
            lane_run = lane_run & ~done
        return (s, x, y, xold, lamK, minres, ctr, tlim, lane_run,
                flag.to(torch.int32), tot)

    x, y, xold, minres, ctr, tlim, lr, flag, tot = avi_carries(a)
    lamK = torch.zeros((B, a.s.E.shape[1]), dtype=f32, device=dev)
    s = a.s
    if not fused:
        s, x, y, xold, lamK, minres, ctr, tlim, lr, flag, tot = passes(
            max_outer, s, x, y, xold, lamK, minres, ctr, tlim, lr > 0, flag,
            tot)
    else:
        ops_ = avi_segment_operands(a)
        for _ in range(0, max_outer, PSEG):
            if late(deadline):
                flag = timed_out(flag, lr > 0)
                lr = torch.zeros_like(lr)
                break
            if not host_any(lr > 0):
                break
            (s, x, y, xold, minres, ctr, tlim, lr, flag, tot, failed,
             kktq) = slot.run_avi_segment(
                s, x, y, xold, minres, ctr, tlim, lr, flag, tot, *ops_, st,
                n, P=PSEG, steps=AVI_STEPS)
            kq = kktq > 0
            if host_any(kq):
                avi_kkt_services += 1
                x_kkt, lam_new, opt = kkt_all(s, kq, prob, st)
                xold = torch.where(kq[:, None], x, xold)
                x = torch.where(kq[:, None], x_kkt, x)
                lamK = torch.where(kq[:, None], lam_new, lamK)
                flag = torch.where(opt & (flag == EXIT_RUNNING),
                                   EXIT_OPTIMAL, flag).to(torch.int32)
                lr = torch.where(opt, 0.0, lr)
            fl = failed > 0
            if host_any(fl):
                avi_resumed_lanes += int(fl.sum())
                # per-lane resume of the lanes that froze in the segment
                r = passes(PSEG, s, x, y, xold, lamK, minres, ctr, tlim, fl,
                           flag, tot)
                s = slot.select_lanes(fl, r[0], s)
                x, y, xold, lamK, minres, ctr, tlim, lr, flag, tot = (
                    torch.where(fl.view((-1,) + (1,) * (new.dim() - 1)),
                                new.to(old.dtype), old)
                    for new, old in zip(r[1:], (x, y, xold, lamK, minres,
                                                ctr, tlim, lr, flag, tot)))
            s = slot.newton_refresh(s)
    lane_run = lr > 0
    flag = torch.where(lane_run, EXIT_ITERLIMIT, flag)
    x = torch.where(a.unc_ok[:, None], a.x_unc, x)
    # the KKT duals scattered from slots to rows
    oh = (s.sid[:, :, None] == torch.arange(m, dtype=f32, device=dev)
          ).to(f32) * s.used[:, :, None]
    lam = torch.einsum('bkm,bk->bm', oh, lamK)
    return BatchResult(x=x, lam=lam, fval=(f * x).sum(1),
                       exitflag=flag.to(torch.int32),
                       iterations=torch.clamp(tot, min=1.0).to(torch.int32),
                       soft_slack=torch.zeros(B, dtype=f32, device=dev))


LP_PSEG = 10             # LP passes per B6 launch
LP_SEG_STEPS = 192       # inner iterations per B6 pass
LP_STEPS = 64            # inner iterations per per-pass solve
LP_RETRY_PASSES = 60     # outer-pass cap of each retry
LP_DUAL_TOL = 5e-4       # stationarity of a flag-1 lane's own duals
lp_resumed_lanes = 0     # lanes frozen in a B6 segment that resumed
lp_certified_lanes = 0   # loud lanes the final LP certificate certified


class LPSetup(NamedTuple):
    """The batched LP tier's set-up (``batch.py:1050-1080``), f32."""
    f: torch.Tensor          # (B, n)
    A: torch.Tensor          # (B, m - ms, n)
    ldpd: transform.LDPData  # LP mode: Rinv = I, v = 0
    s0: slot.SlotState       # cold, the sense-ACTIVE rows activated
    bu_s: torch.Tensor       # (B, m) user bounds times the row scaling
    bl_s: torch.Tensor
    bu_r: torch.Tensor       # (B, m) raw user bounds
    bl_r: torch.Tensor
    eta: float               # fixed-point tolerance of the outer loop
    ms: int


def lp_init(f, A, bupper, blower, sense, st: Settings, ms: int = 0,
            device=None) -> LPSetup:
    """The LP-mode LDP (``transform.build_ldp`` with neither H nor Rinv),
    the cold slot state with the equality / warm rows bulk-activated
    (``batch.py:1058-1072``), the scaled and raw bounds, and eta."""
    dev = resolve_device((f, A, bupper, blower, sense), device)
    f32 = torch.float32

    def t(x, dtype=f32):
        return torch.as_tensor(x, device=dev).to(dtype)

    f, A, bu, bl = (t(x) for x in (f, A, bupper, blower))
    if A.dim() == 2:
        A = A[..., None]
    B, n = f.shape
    sense = torch.zeros(bu.shape, dtype=torch.int32, device=dev) \
        if sense is None else t(sense, torch.int32)
    ldpd = transform.build_ldp(None, A, bu, bl, sense, ms, st)
    immut = ((ldpd.sense & IMMUTABLE) > 0).to(f32)
    s0 = slot.slot_init(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.scaling, immut,
                        n_true=n)
    act = (ldpd.sense & ACTIVE) > 0
    if host_any(act):
        lo = act & ((ldpd.sense & LOWER) > 0)
        s0 = slot.slot_activate(s0, act & ~lo, lo, st)
    return LPSetup(f=f, A=A, ldpd=ldpd, s0=s0,
                   bu_s=(bu * ldpd.scaling).contiguous(),
                   bl_s=(bl * ldpd.scaling).contiguous(), bu_r=bu.contiguous(),
                   bl_r=bl.contiguous(), eta=auto_eta(st), ms=ms)


def lp_carries(p: LPSetup):
    """The cold carries of ``slot.LP_LANE``: x = 0, eps 1, stall 0, best
    INF, lane_run where the transform found no error, lflag the error or
    RUNNING, tot and passes 0."""
    B, n = p.f.shape
    zb = torch.zeros(B, dtype=torch.float32, device=p.f.device)
    err = p.ldpd.error
    return (torch.zeros_like(p.f), zb + 1.0, zb, zb + float("inf"),
            (err >= 0).to(zb.dtype),
            torch.where(err < 0, err, EXIT_RUNNING).to(torch.int32), zb, zb)


def _lp_refit(p: LPSetup, vals, cand, tol_f, st: Settings):
    """The certificate's re-fit (``batch.py:1454-1521``), in f64: the rows
    tight at x within ``tol_f`` (B,) on the ``cand`` lanes, packed into
    slots from the cold state (``slot.slot_activate``); with G = W W' by
    an f64 Cholesky, the least-squares duals lam = -G^-1 W f, scattered to
    rows, and the exact point of the tight face, x = W' G^-1 dsl (W x =
    dsl is A_act x = b_act: v = 0).  Returns ``(lam (B, m), ok (B,), x
    (B, n))``; ``ok`` needs exactly n tight rows (the n + 1 of a
    degenerate vertex are dependent: no certificate), a Cholesky that
    succeeds, a cold state whose own activation succeeded, and a finite
    point.

    The JAX tier solves in f32 through the activation's E with two
    refinement passes of f64 residuals, and takes up to its padded slot
    count of rows.  The port's activation gates every Schur pivot at 1e-4
    of its row's norm (ROADMAP Queue C), which also refuses a vertex that
    is merely ill-conditioned (measured: a lane certified by the JAX tier
    at stationarity 6.7e-8 went uncertified at 1.7e-3), so the Gram is
    solved here in f64 without that gate; the checks that follow decide
    the certificate."""
    n = p.f.shape[1]
    tol = tol_f[:, None]
    up_t = p.bu_r - vals < tol
    tight_u = up_t & cand[:, None]
    tight_l = (vals - p.bl_r < tol) & cand[:, None] & ~up_t
    s_c = slot.slot_activate(p.s0, tight_u, tight_l, st)
    used, W = s_c.used.double(), s_c.W.double()
    G = slot._gram(W, used)
    L, info = torch.linalg.cholesky_ex(G)
    ok = (info == 0) & ((tight_u | tight_l).sum(1) == n) \
        & (p.s0.status != EXIT_REFACTOR)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    Ginv = torch.cholesky_solve(
        eye.expand_as(G), torch.where(ok[:, None, None], L, eye)) \
        * (used[:, :, None] * used[:, None, :])
    lam = -torch.einsum('bij,bj->bi', Ginv,
                        torch.einsum('bkj,bj->bk', W, p.f.double())) * used
    x_f = torch.einsum('bkj,bk->bj', W, torch.einsum(
        'bij,bj->bi', Ginv, s_c.dsl.double() * used)).to(p.f.dtype)
    ok = ok & torch.isfinite(x_f).all(1)
    lam_m = slot.slot_duals_dense(s_c._replace(lam_star=lam.to(p.f.dtype)))
    return lam_m, ok, x_f


def solve_batch_lp_kernel(f, A, bupper, blower, sense, st: Settings,
                          ms: int = 0, max_outer: int = 120,
                          fused: bool = False, deadline=None,
                          device=None) -> BatchResult:
    """Batched LP solve (min f'x, bl <= [x[:ms]; A x] <= bu): the
    adaptive-eps proximal LP regime (daqp_prox.c:21-271) over one slot
    state for the whole batch, as ``solve_batch_lp_pallas_jit``
    (``batch.py:981``).

    Each outer pass solves the proximal LDP at v = f eps - x warm on the
    slot tier; x_new = u - v is accepted on ||x_new - x||_inf < eta eps or
    after three stagnant vertex passes; a lane whose solve took one
    iteration off a vertex takes the gradient step (``slot.lp_grad_step``:
    the blocking row of the ray x_new + alpha (x_new - x) joins the
    working set; no blocking row exits UNBOUNDED); eps x10 on such a lane,
    x0.9 otherwise, capped at 1e3.

    ``fused=False`` (the reference's default) runs every pass as a warm
    ``slot_solve`` on K2 (eps adapts from the batch's second pass on).
    ``fused=True`` runs ``LP_PSEG`` passes per B6 launch
    (``ops.slot.run_lp_segment``; its twin on the CPU; eps adapts from the
    lane's second pass on), lets a lane frozen in a segment resume in the
    next (after two failed resumes it exits CYCLE), Newton-refreshes E
    per segment, and sends loud lanes once through the per-pass path from
    where they stopped.  Then on both paths: a cold Bland retry of every
    loud lane but UNBOUNDED ones, the crossover to a vertex (at most n + 1
    projected steepest-descent steps through ``lp_grad_step``), the
    vertex polish (an exact solve of the active system), and the final
    LP certificate: the rows tight at x are re-activated from the cold
    state, the duals re-fit, and the exact face point is checked for
    feasibility (10 primal_tol (1 + max|bu|)), stationarity (1e-5 (1 +
    ||f||_inf)) and complementarity; a loud lane that passes is
    certified optimal with that point and those duals, a flag-1 lane it
    refutes exits CYCLE.  Elsewhere lam is the slot duals over eps; unlike
    the JAX tier, a flag-1 lane the re-fit cannot judge exits CYCLE unless
    those duals are stationary within ``LP_DUAL_TOL``.  fval = f'x,
    iterations the inner iterations summed over passes.  A lane still
    running past ``deadline`` (checked per pass and per segment) exits
    TIMELIMIT; the retries and the certificate leave it so."""
    global lp_resumed_lanes, lp_certified_lanes
    p = lp_init(f, A, bupper, blower, sense, st, ms, device)
    f, s0 = p.f, p.s0
    B, n = f.shape
    dev = f.device
    f32 = torch.float32
    budget_retry = min(max_outer, LP_RETRY_PASSES)

    def run_regime(s, run0, flag, st_k, budget, x=None, eps=None,
                   lanes=None):
        """The per-pass outer loop (``batch.py:1149-1229``) on K2 for the
        ``run0`` lanes; the others are held terminal and keep ``flag``.
        With ``lanes`` (an index tensor) the state and carries are those
        lanes' alone."""
        fz, bu_s, bl_s, bu_r, bl_r = (
            t if lanes is None else t[lanes]
            for t in (f, p.bu_s, p.bl_s, p.bu_r, p.bl_r))
        Bn = fz.shape[0]
        x = torch.zeros_like(fz) if x is None else x
        eps = torch.ones(Bn, dtype=f32, device=dev) if eps is None else eps
        s = s._replace(status=torch.where(run0, s.status, EXIT_OPTIMAL)
                       .to(torch.int32))
        lane_run = run0
        stall = torch.zeros(Bn, dtype=f32, device=dev)
        best = torch.full((Bn,), float("inf"), dtype=f32, device=dev)
        tot = torch.zeros(Bn, dtype=f32, device=dev)
        for k in range(budget):
            if late(deadline):
                flag = timed_out(flag, lane_run)
                lane_run = torch.zeros_like(lane_run)
                break
            if not host_any(lane_run):
                break
            v = fz * eps[:, None] - x
            Mv = torch.einsum('bmj,bj->bm', s.M, v)
            s = slot.reset_control(slot.slot_refresh_bounds(
                s, bu_s + Mv, bl_s + Mv), lane_run)
            s = slot.slot_solve(s, st_k, n_true=n, steps=LP_STEPS,
                                deadline=deadline)
            tot = tot + torch.where(lane_run, s.iterations, 0.0)
            inner_ok = s.status > 0
            x_new = s.u - v
            it1 = s.iterations <= 1
            at_vx = s.used.sum(1) >= n
            diff = (x_new - x).abs().amax(1)
            ndiff = diff / eps
            improved = ndiff < 0.9 * best
            best = torch.minimum(ndiff, best)
            stall = torch.where(improved | ~(it1 & at_vx) | ~lane_run, 0.0,
                                stall + 1.0)
            converged = (diff < p.eta * eps) | (inner_ok & (stall >= 3))
            need = it1 & ~at_vx & ~converged & lane_run & inner_ok
            s, x_new, found = slot.lp_grad_step(s, x_new, x, need, bu_r,
                                                bl_r, st_k, n)
            unbounded = need & ~found
            if k > 0:
                grow = it1 & ~at_vx
                eps = torch.where(lane_run, torch.clamp(torch.where(
                    grow, eps * 10.0, eps * 0.9), max=1e3), eps)
            done = lane_run & (converged | ~inner_ok | unbounded)
            flag = torch.where(done, torch.where(
                unbounded, EXIT_UNBOUNDED,
                torch.where(inner_ok, EXIT_OPTIMAL, s.status)), flag) \
                .to(torch.int32)
            x = torch.where((lane_run & ~(done & ~inner_ok))[:, None], x_new,
                            x)
            lane_run = lane_run & ~done
        return s, x, eps, torch.where(lane_run, EXIT_ITERLIMIT, flag), tot

    def retry(s, x, eps, flag, tot, st_k, cont=False):
        """``retry_stage`` (``batch.py:1313-1357``): the loud lanes but
        UNBOUNDED ones re-run on the per-pass path, from where they
        stopped (``cont``) or cold, and merge back lane by lane.  A lane's
        passes depend on that lane alone, so only those lanes run (the JAX
        tier runs the whole batch with the others held)."""
        fail = (flag < 0) & (flag != EXIT_UNBOUNDED) \
            & (flag != EXIT_TIMELIMIT)
        if not host_any(fail):
            return s, x, eps, flag, tot
        idx = torch.nonzero(fail)[:, 0]
        base = s if cont else s0
        r = run_regime(slot.SlotState(*(t[idx] for t in base)),
                       torch.ones_like(idx, dtype=torch.bool), flag[idx], st_k,
                       budget_retry, x[idx] if cont else None,
                       eps[idx] if cont else None, lanes=idx)
        return (slot.SlotState(*(t.index_copy(0, idx, rt.to(t.dtype))
                                 for t, rt in zip(s, r[0]))),
                x.index_copy(0, idx, r[1]), eps.index_copy(0, idx, r[2]),
                flag.index_copy(0, idx, r[3].to(flag.dtype)),
                tot.index_add(0, idx, r[4]))

    carry = lp_carries(p)
    if not fused:
        s, x, eps, flag, tot = run_regime(s0, carry[4] > 0, carry[5], st,
                                          max_outer)
    else:
        s = s0._replace(status=torch.full_like(s0.status, EXIT_OPTIMAL))
        x, eps, stall, best, lr, lflag, tot, passes = carry
        resumes = torch.zeros(B, dtype=f32, device=dev)
        data = (f, p.bu_s, p.bl_s, p.bu_r, p.bl_r)
        for _ in range(0, max_outer, LP_PSEG):
            if late(deadline):
                lflag = timed_out(lflag, lr > 0)
                lr = torch.zeros_like(lr)
                break
            if not host_any(lr > 0):
                break
            s, x, eps, stall, best, lr, lflag, tot, passes, failed = \
                slot.run_lp_segment(s, x, eps, stall, best, lr, lflag, tot,
                                    passes, *data, st, n, p.eta, P=LP_PSEG,
                                    steps=LP_SEG_STEPS)
            # a lane frozen in the segment resumes in the next, after the
            # Newton refresh below; after two failed resumes it turns loud
            # and goes to the retries
            fm = failed > 0
            resumes = resumes + fm.to(f32)
            give_up = (resumes > 2) & fm
            lflag = torch.where(give_up, EXIT_CYCLE, lflag).to(torch.int32)
            lr = torch.where(give_up, 0.0, lr)
            if host_any(fm):
                lp_resumed_lanes += int((fm & ~give_up).sum())
            s = slot.newton_refresh(s)
        flag = torch.where(lr > 0, EXIT_ITERLIMIT, lflag).to(torch.int32)
        s, x, eps, flag, tot = retry(s, x, eps, flag, tot, st, cont=True)
    s, x, eps, flag, tot = retry(s, x, eps, flag, tot,
                                 st._replace(pricing=PRICING_BLAND))

    # crossover to a vertex (``batch.py:1360-1390``): projected steepest
    # descent within the active face to the nearest blocking row
    for _ in range(n + 1):
        need = (flag == EXIT_OPTIMAL) & (s.used.sum(1) < n)
        if not host_any(need):
            break
        Wf = torch.einsum('bkj,bj->bk', s.W, f) * s.used
        tv = torch.einsum('bij,bj->bi', s.E, Wf) * s.used
        d = torch.einsum('bkj,bk->bj', s.W, tv) - f
        need = need & (torch.linalg.vector_norm(d, dim=1) > 1e-10)
        s, x2, _ = slot.lp_grad_step(s, x, x - d, need, p.bu_r, p.bl_r, st,
                                     n)
        x = torch.where(need[:, None], x2, x)

    # vertex polish (``batch.py:1392-1421``): W u = dsl at the last v by
    # u = W'E (dsl o used) and two refinement passes through the f32 E
    # with the residual in f64 (the JAX tier casts to f64, which is f32 on
    # a TPU without x64)
    v_last = f * eps[:, None] - x
    Mv = torch.einsum('bmj,bj->bm', s.M, v_last)
    s = slot.slot_refresh_bounds(s, p.bu_s + Mv, p.bl_s + Mv)
    do_vx = (flag == EXIT_OPTIMAL) & (s.used.sum(1) >= n)
    rhs = s.dsl * s.used
    u = torch.einsum('bkj,bk->bj', s.W, torch.einsum('bij,bj->bi', s.E, rhs))
    W64, E64 = s.W.double(), s.E.double()
    for _ in range(2):
        r = (torch.einsum('bkj,bj->bk', W64, u.double()) - rhs.double()) \
            * s.used
        u = (u.double() - torch.einsum(
            'bkj,bk->bj', W64, torch.einsum('bij,bj->bi', E64, r))).to(f32)
    x_vx = u - v_last
    x = torch.where((do_vx & torch.isfinite(x_vx).all(1))[:, None], x_vx, x)
    lam = slot.slot_duals_dense(s) / eps[:, None]

    # the final LP certificate (``batch.py:1427-1578``)
    def rows(z):
        return torch.cat([z[:, :ms], torch.einsum('bmj,bj->bm', p.A, z)], 1)

    def violation(vals):
        return torch.maximum((vals - p.bu_r).amax(1),
                             (p.bl_r - vals).amax(1))

    vals = rows(x)
    feas_v = violation(vals)
    bscale = 1.0 + torch.where(torch.isfinite(p.bu_r), p.bu_r,
                               0.0).abs().amax(1)
    tol_f = 10.0 * st.primal_tol * bscale
    cand = ((flag < 0) & (flag != EXIT_UNBOUNDED)
            & (flag != EXIT_TIMELIMIT)) | (flag == EXIT_OPTIMAL)
    lam_fit, refit_ok, x_fit = torch.zeros_like(lam), \
        torch.zeros_like(cand), torch.zeros_like(x)
    if host_any(cand):
        lam_fit, refit_ok, x_fit = _lp_refit(p, vals, cand, tol_f, st)
    ref_lane = cand & refit_ok
    vals_fit = rows(x_fit)
    vals = torch.where(ref_lane[:, None], vals_fit, vals)
    feas_ok = torch.where(ref_lane, violation(vals_fit), feas_v) < tol_f
    grad = f + torch.einsum('bmj,bm->bj', p.A, lam_fit[:, ms:])
    grad[:, :ms] += lam_fit[:, :ms]
    stat_ok = grad.abs().amax(1) < 1e-5 * (1.0 + f.abs().amax(1))
    comp_bad = (((lam_fit > 1e-6) & (p.bu_r - vals > tol_f[:, None]))
                | ((lam_fit < -1e-6) & (vals - p.bl_r > tol_f[:, None]))
                ).any(1)
    cert_ok = refit_ok & feas_ok & stat_ok & ~comp_bad
    certified = cand & cert_ok
    rescued = certified & (flag != EXIT_OPTIMAL)
    if host_any(rescued):
        lp_certified_lanes += int(rescued.sum())
    # beyond the JAX tier: a flag-1 lane the re-fit cannot judge (its
    # tight set is not n independent rows) keeps flag 1 there with no dual
    # that shows it optimal (measured: stationarity 0.27 with its own
    # duals); here it must carry duals within LP_DUAL_TOL of stationarity
    # (tests/test_batch_lp.py:52), or it exits CYCLE
    own_stat = (f + torch.einsum('bmj,bm->bj', p.A, lam[:, ms:]))
    own_stat[:, :ms] += lam[:, :ms]
    undual = ~refit_ok & (own_stat.abs().amax(1) >= LP_DUAL_TOL)
    demote = (flag == EXIT_OPTIMAL) & ((refit_ok & ~cert_ok) | ~feas_ok
                                       | undual)
    flag = torch.where(certified, EXIT_OPTIMAL, flag)
    flag = torch.where(demote, EXIT_CYCLE, flag)
    lam = torch.where(certified[:, None], lam_fit, lam)
    x = torch.where(certified[:, None], x_fit, x)
    return BatchResult(x=x, lam=lam, fval=(f * x).sum(1),
                       exitflag=flag.to(torch.int32),
                       iterations=tot.to(torch.int32),
                       soft_slack=torch.zeros(B, dtype=f32, device=dev))


MIQP_STEPS = 64          # K2 steps a round of a node wave
miqp_waves = 0           # node waves of the last solve_batch_miqp_kernel


def solve_batch_miqp_kernel(H, f, A, bupper, blower, sense, st: Settings,
                            ms: int = 0, bin_ids: tuple = None,
                            max_waves: int = 512, deadline=None,
                            device=None) -> BatchResult:
    """Batched MIQP branch and bound whose node relaxations are solved in
    whole-batch WAVES on K1 and K2 (``solve_batch_miqp_pallas_jit``,
    ``batch.py:2233``; BASELINE config 5).

    K1 factors the batch once (``chol.batched_rinv_regularized``; a lane
    that needed a shift is NONCONVEX).  Each lane keeps its own DFS stack
    of nodes (the binaries fixed, their sides and the parent's final
    working set, as (B, cap, nb) and (B, cap, m) bool masks).  A wave pops
    every live lane's top node and solves all the relaxations at once:
    ``slot.slot_init`` with the lane's live incumbent bound as K2's
    per-lane dominance cut ``fbound`` (rel_subopt / abs_subopt folded in,
    bnb.c:29-31, 68, in LDP space where the v'v shift is the same at every
    node), the fixed binaries and equalities bulk-activated with the
    parent's working set (``slot.slot_activate``; a lane whose warm set is
    dependent falls back to fixed and equality rows alone, as the
    reference drops dependent adds, auxiliary.c:446-469), then
    ``slot.slot_solve(steps=64)``.  Then per lane: the dominance prune,
    the first binary off its endpoints branched nearest endpoint first
    (bnb.c:130-156), both children pushed with this node's working set,
    or the incumbent updated.  The JAX tier's 31-bit words, one-hot
    bin-to-row einsum and lane padding were TPU workarounds; they are
    not here.

    ``bin_ids``: the BINARY rows, shared by the batch (default: every row
    with a BINARY bit on some lane; a lane without the bit on a row never
    branches on it).  Strictly convex H and hard rows.  A lane whose tree
    is not exhausted after ``max_waves`` waves exits ITERLIMIT; past
    ``deadline`` (checked in the slot rounds) its relaxation exits
    TIMELIMIT and so does the lane.  ``iterations`` is the lane's node
    count.  Host syncs a wave: the live-lane test and ``slot_solve``'s
    own round tests."""
    global miqp_waves
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    f32 = torch.float32
    H, f, A, bupper, blower = (x.to(f32) for x in (H, f, A, bupper, blower))
    B, n = f.shape
    m = bupper.shape[1]
    dev = H.device
    if bin_ids is None:
        bin_ids = tuple(np.flatnonzero(np.any(
            host_numpy(sense)[0] & BINARY, axis=0)).tolist())
    nb = len(bin_ids)
    if nb == 0:
        raise ValueError("solve_batch_miqp_kernel: no BINARY rows")
    bins = torch.as_tensor(bin_ids, dtype=torch.int64, device=dev)
    cap = nb + 2
    Rinv, okl, regl, _ = chol.batched_rinv_regularized(H, st)
    ldpd = transform.build_ldp(f, A, bupper, blower, sense, ms, st,
                               Rinv=Rinv)
    err0 = torch.where(okl & ~regl, ldpd.error, EXIT_NONCONVEX)
    vv = (ldpd.v * ldpd.v).sum(1)
    du0, dl0, scaling = ldpd.dupper, ldpd.dlower, ldpd.scaling
    immut0 = (ldpd.sense & IMMUTABLE) > 0
    eq_act = (ldpd.sense & ACTIVE) > 0
    eq_lo = eq_act & ((ldpd.sense & LOWER) > 0)
    bin_du, bin_dl = du0[:, bins], dl0[:, bins]
    bin_tol = st.primal_tol * scaling[:, bins]
    lane_is_bin = (sense[:, bins] & BINARY) > 0          # (B, nb)
    # the subopt folding in LDP space (bnb.c:29-31, 68)
    eps_r = 1.0 / (1.0 + torch.tensor(st.rel_subopt, dtype=f32))
    abs2 = 2.0 * torch.tensor(st.abs_subopt, dtype=f32)
    bound0 = (2.0 * torch.tensor(st.fval_bound, dtype=f32) - abs2) * eps_r

    def rows(per_bin):
        """(B, nb) bool per binary -> (B, m) bool per row."""
        out = torch.zeros((B, m), dtype=torch.bool, device=dev)
        out[:, bins] = per_bin
        return out

    lanes = torch.arange(B, device=dev)
    slot_iota = torch.arange(cap, device=dev)
    stack_fx = torch.zeros((B, cap, nb), dtype=torch.bool, device=dev)
    stack_lo = torch.zeros_like(stack_fx)
    stack_wu = torch.zeros((B, cap, m), dtype=torch.bool, device=dev)
    stack_wl = torch.zeros_like(stack_wu)
    sp = torch.where(err0 < 0, 0, 1).to(torch.int64)
    best_fldp = torch.full((B,), DAQP_INF, dtype=f32, device=dev)
    bound_fldp = bound0.to(dev).expand(B).clone()
    best_u = torch.zeros((B, n), dtype=f32, device=dev)
    best_lam = torch.zeros((B, m), dtype=f32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    nodes = torch.zeros(B, dtype=torch.int32, device=dev)
    lane_err = torch.where(err0 < 0, err0, 0).to(torch.int32)
    waves = 0
    while waves < max_waves and host_any((sp > 0) & (lane_err == 0)):
        live = (sp > 0) & (lane_err == 0)
        idx = torch.clamp(sp - 1, min=0)
        fx, lo = stack_fx[lanes, idx], stack_lo[lanes, idx]
        wu, wl = stack_wu[lanes, idx], stack_wl[lanes, idx]
        sp = sp - live.to(sp.dtype)
        nodes = nodes + live.to(nodes.dtype)
        fixed = rows(fx) & live[:, None]
        lower = rows(fx & lo) & live[:, None]
        du = torch.where(fixed & lower, dl0, du0)
        dl = torch.where(fixed & ~lower, du0, dl0)
        s = slot.slot_init(ldpd.M, du, dl, scaling, immut0 | fixed,
                           n_true=n, fbound=bound_fldp)
        up_f = (fixed & ~lower) | (eq_act & ~eq_lo)
        lo_f = lower | eq_lo
        warm = ~fixed & ~eq_act & live[:, None]
        sw_ = slot.slot_activate(s, up_f | (wu & warm),
                                 lo_f | (wl & warm & ~wu), st)
        # a dependent warm set falls back to the fixed and equality rows
        # (selected per lane: no read)
        sf = slot.slot_activate(s, up_f, lo_f, st)
        s = slot.select_lanes(sw_.status == EXIT_REFACTOR, sf, sw_)
        # exhausted and errored lanes are terminal: the kernel skips them
        s = s._replace(status=torch.where(live, s.status, EXIT_OPTIMAL)
                       .to(torch.int32))
        s = slot.slot_solve(s, st, n_true=n, steps=MIQP_STEPS,
                            deadline=deadline)
        flag, fldp = s.status, s.fval
        u = s.u[:, :n]
        viable = live & (flag > 0) & (fldp < bound_fldp)
        hard_fail = live & (flag < 0) & (flag != EXIT_INFEASIBLE) \
            & (flag != EXIT_RUNNING)
        lane_err = torch.where(hard_fail, flag, lane_err)

        # the branch: the first binary off both endpoints of its original
        # bounds, nearest endpoint first
        mu = torch.einsum('bmj,bj->bm', ldpd.M, u)[:, bins]
        diff = 0.5 * (bin_du + bin_dl) - mu
        dist = 0.5 * (bin_du - bin_dl) - diff.abs()
        frac = ~fx & (dist > bin_tol) & lane_is_bin
        has_branch = frac.any(1)
        pos = torch.argmax(frac.to(torch.int32), dim=1)
        lower_first = diff.gather(1, pos[:, None])[:, 0] >= 0

        # integer feasible: the incumbent and the folded bound (bnb.c:68)
        take = viable & ~has_branch
        best_fldp = torch.where(take, fldp, best_fldp)
        bound_fldp = torch.where(take, (fldp - abs2) * eps_r, bound_fldp)
        best_u = torch.where(take[:, None], u, best_u)
        best_lam = torch.where(take[:, None], slot.slot_duals_dense(s)[:, :m],
                               best_lam)
        found = found | take

        # push the children, far endpoint first: both keep this node's
        # final working set (tree_WS is written at the branch point,
        # bnb.c:211-222)
        push = viable & has_branch
        bitk = (torch.arange(nb, device=dev) == pos[:, None]) & push[:, None]
        at0 = push[:, None] & (slot_iota == sp[:, None])
        at1 = push[:, None] & (slot_iota == sp[:, None] + 1)
        at01 = (at0 | at1)[:, :, None]
        child_fx = (fx | bitk)[:, None, :]
        far_lo = (lo | (bitk & ~lower_first[:, None]))[:, None, :]
        near_lo = (lo | (bitk & lower_first[:, None]))[:, None, :]
        stack_fx = torch.where(at01, child_fx, stack_fx)
        stack_lo = torch.where(at0[:, :, None], far_lo,
                               torch.where(at1[:, :, None], near_lo,
                                           stack_lo))
        stack_wu = torch.where(at01, (s.act_up[:, None, :m] > 0.5), stack_wu)
        stack_wl = torch.where(at01, (s.act_lo[:, None, :m] > 0.5), stack_wl)
        sp = sp + 2 * push.to(sp.dtype)
        waves += 1
    miqp_waves = waves

    x = transform.ldp_to_qp_solution(ldpd, best_u)
    pending = sp > 0
    exitflag = torch.where(
        lane_err < 0, lane_err,
        torch.where(pending, EXIT_ITERLIMIT,
                    torch.where(found, EXIT_OPTIMAL, EXIT_INFEASIBLE)))
    return BatchResult(x=x, lam=best_lam, fval=0.5 * (best_fldp - vv),
                       exitflag=exitflag.to(torch.int32), iterations=nodes,
                       soft_slack=torch.zeros(B, dtype=f32, device=dev))


def solve_batch_miqp_jit(H, f, A, bupper, blower, sense, st: Settings,
                         ms: int = 0, bin_ids: tuple = (), K=None,
                         device=None) -> bnb.BnBOut:
    """Batched MIQP: the single-instance branch and bound
    (``bnb.bnb_core``) on each instance in turn, the instances sharing
    their BINARY rows ``bin_ids`` (``daqp_tpu/batch.py:2566``, a vmap
    there).  Returns a ``bnb.BnBOut`` with leading batch dimensions."""
    H, f, A, bupper, blower, sense = _tensors(H, f, A, bupper, blower,
                                              sense, device)
    outs = [bnb.bnb_core(H[b], f[b], A[b], bupper[b], blower[b], sense[b],
                         ms, st, bin_ids=tuple(bin_ids), K=K)
            for b in range(H.shape[0])]

    def ints(name):
        return torch.tensor([getattr(o, name) for o in outs],
                            dtype=torch.int32, device=H.device)

    return bnb.BnBOut(
        x=torch.stack([o.x for o in outs]),
        lam=torch.stack([o.lam for o in outs]),
        fval=torch.stack([o.fval for o in outs]),
        exitflag=ints("exitflag"), iterations=ints("iterations"),
        soft_slack=torch.stack([o.soft_slack for o in outs]),
        nodes=ints("nodes"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def kkt_residuals(H, f, A, bupper, blower, sense, x, lam, ms: int = 0):
    """Per-lane f64 KKT check of a batched solve (host-side NumPy).

    Returns ``(stationarity, violation)``:
      * stationarity — relative ||H x + f + A' lam||_inf;
      * violation   — worst over HARD rows of the relative primal
        violation and the complementarity / dual-sign violation
        min(|lam_i|, slack of the side lam_i's sign claims active).
    """
    H = _np(H).astype(float)
    f = _np(f).astype(float)
    A = _np(A).astype(float)
    bu = _np(bupper).astype(float)
    bl = _np(blower).astype(float)
    x = _np(x).astype(float)
    lam = _np(lam).astype(float)
    B, n = x.shape
    m = bu.shape[-1]
    sense = (np.zeros((B, m), np.int32) if sense is None else _np(sense))

    grad = np.einsum('bij,bj->bi', H, x) + f
    if ms:
        grad[:, :ms] += lam[:, :ms]
    if A.shape[1]:
        grad += np.einsum('bri,br->bi', A, lam[:, ms:])
    denom = (np.abs(H).sum(-1).max(-1) * np.maximum(np.abs(x).max(-1), 1)
             + np.abs(f).max(-1) + 1.0)
    stat = np.abs(grad).max(-1) / denom

    vals = np.concatenate(
        [x[:, :ms], np.einsum('brj,bj->br', A, x)], axis=1) \
        if ms else np.einsum('brj,bj->br', A, x)
    bscale = 1.0 + np.maximum(np.abs(np.where(bu >= DAQP_INF, 0, bu)),
                              np.abs(np.where(bl <= -DAQP_INF, 0, bl)))
    viol = np.maximum(vals - bu, bl - vals) / bscale
    hard = (sense & SOFT) == 0
    lscale = 1.0 + np.abs(lam).max(-1, keepdims=True)
    slack_claim = np.where(lam > 0, bu - vals, vals - bl)
    slack_claim = np.minimum(np.abs(slack_claim) / bscale,
                             np.abs(lam) / lscale)
    comp = np.where(hard, slack_claim, 0.0)
    viol = np.maximum(np.where(hard, viol, -np.inf), comp).max(-1)
    return stat, viol


# the f32 tolerances a re-solve in f64 drops for the reference defaults
_F32_TOLS = ('primal_tol', 'dual_tol', 'zero_tol', 'pivot_tol',
             'progress_tol', 'sing_tol')
backstop_lanes = 0       # lanes re-solved by the backstops


def backstop_resolve(res: BatchResult, H, f, A, bupper, blower, sense=None,
                     ms: int = 0, settings=None, kkt_tol: float = 1e-4,
                     sw: Optional[SoftWeights] = None) -> BatchResult:
    """The f32 outlier backstop (``daqp_tpu/batch.py:2772``): the lanes
    whose exit flag is not optimal, or whose f64 KKT residual
    (``kkt_residuals``) exceeds ``kkt_tol``, are solved again one by one
    in f64 through the port's single-instance ``quadprog``, on the batch's
    device, with the reference's f64 tolerances in place of the f32 ones
    of ``settings``.  With ``sw`` (the batch's SOFT_WEIGHTS data, (B, m)
    fields in raw units) a lane with SOFT rows is solved with its own
    slack bounds and weights.  Lanes with BINARY bits are left as they
    are.  A lane solved optimal takes the new x, lam and fval; every
    re-solved lane takes the new flag.

    A clean batch costs one KKT check on the host and comes back as the
    same object."""
    from .api import quadprog
    x, lam, flags = host_numpy(res.x, res.lam, res.exitflag)
    sense_np = _sense_rows(sense, *lam.shape)
    stat, viol = kkt_residuals(H, f, A, bupper, blower, sense_np, x, lam,
                               ms=ms)
    bad = (~np.isin(flags, (EXIT_OPTIMAL, EXIT_SOFT_OPTIMAL))
           | (stat > kkt_tol) | (viol > kkt_tol))
    bad &= ~np.any(sense_np & BINARY, axis=-1)
    if not bad.any():
        return res
    st = _f64_settings(settings)
    dev = res.x.device

    def one(b):
        soft_w = None
        if sw is not None and np.any(sense_np[b] & SOFT):
            soft_w = {k: v[b] for k, v in zip(SoftWeights._fields, sw)}
        return quadprog(H[b], f[b], A[b], bupper[b], blower[b], sense_np[b],
                        ms=ms, settings=st, dtype=torch.float64,
                        soft_weights=soft_w, device=dev)

    return _resolve_lanes(res, bad, one, lambda fl: fl in (
        EXIT_OPTIMAL, EXIT_SOFT_OPTIMAL))


def _f64_settings(settings) -> Optional[dict]:
    """``settings`` as a dict of overrides without the f32 tolerances, so
    that an f64 re-solve takes the reference's (None if nothing is
    left)."""
    st = {} if settings is None else dict(settings) \
        if isinstance(settings, dict) else settings._asdict()
    for k in _F32_TOLS:
        st.pop(k, None)
    return st or None


def _resolve_lanes(res: BatchResult, bad, one_solve, accept) -> BatchResult:
    """The ``bad`` lanes (a host bool array) solved again one by one
    through ``one_solve(b)`` (a ``Result``), counted in
    ``backstop_lanes``: a lane takes the new x, lam and fval when
    ``accept(flag)``, and always the new flag."""
    global backstop_lanes
    x_out, lam_out = res.x.clone(), res.lam.clone()
    fval_out, flag_out = res.fval.clone(), res.exitflag.clone()
    for b in np.flatnonzero(bad):
        one = one_solve(b)
        backstop_lanes += 1
        if accept(one.exitflag):
            x_out[b] = one.x
            lam_out[b] = one.lam
            fval_out[b] = one.fval
        flag_out[b] = one.exitflag
    return res._replace(x=x_out, lam=lam_out, fval=fval_out,
                        exitflag=flag_out)


def _loud_lanes(res: BatchResult, bad_flag) -> np.ndarray:
    """Lanes whose flag fails ``bad_flag`` (on a host array) or whose x
    is not finite, in one read."""
    flags, finite = host_numpy(res.exitflag,
                               torch.isfinite(res.x).all(dim=-1))
    return bad_flag(flags) | ~finite


def _sense_rows(sense, B: int, m: int) -> np.ndarray:
    return np.zeros((B, m), np.int32) if sense is None \
        else _np(sense).astype(np.int32)


def backstop_resolve_lp(res: BatchResult, f, A, bupper, blower, sense=None,
                        ms: int = 0, settings=None) -> BatchResult:
    """The LP tier's backstop (``daqp_tpu/batch.py:2637``): the lanes
    whose flag is neither optimal nor UNBOUNDED, or whose x is not
    finite, are solved again one by one in f64 through the port's own
    ``linprog`` (the adaptive eps and the vertex cleanup), on the batch's
    device, with the reference's f64 tolerances in place of the f32 ones
    of ``settings``.  A lane solved optimal takes the new x, lam and fval;
    every re-solved lane takes the new flag.  A clean batch costs one read
    and comes back as the same object."""
    from .api import linprog
    bad = _loud_lanes(res, lambda fl: (fl != EXIT_OPTIMAL)
                      & (fl != EXIT_UNBOUNDED))
    if not bad.any():
        return res
    sense_np = _sense_rows(sense, *res.lam.shape)
    st = _f64_settings(settings)
    dev = res.x.device
    return _resolve_lanes(
        res, bad, lambda b: linprog(f[b], A[b], bupper[b], blower[b],
                                    sense_np[b], ms=ms, settings=st,
                                    dtype=torch.float64, device=dev),
        lambda fl: fl == EXIT_OPTIMAL)


def backstop_resolve_avi(res: BatchResult, H, f, A, bupper, blower,
                         sense=None, ms: int = 0, settings=None
                         ) -> BatchResult:
    """The AVI tier's backstop (``daqp_tpu/batch.py:2679``): the lanes
    whose flag is not optimal, or whose x is not finite, are solved again
    one by one in f64 through the port's own ``avi`` (the splitting with
    its exact KKT step and Newton revert), as ``backstop_resolve_lp``
    does for LPs."""
    from .api import avi
    bad = _loud_lanes(res, lambda fl: fl != EXIT_OPTIMAL)
    if not bad.any():
        return res
    sense_np = _sense_rows(sense, *res.lam.shape)
    st = _f64_settings(settings)
    dev = res.x.device
    return _resolve_lanes(
        res, bad, lambda b: avi(H[b], f[b], A[b], bupper[b], blower[b],
                                sense_np[b], ms=ms, settings=st,
                                dtype=torch.float64, device=dev),
        lambda fl: fl == EXIT_OPTIMAL)


def backstop_resolve_hiqp(res: BatchResult, H, f, A, bupper, blower,
                          sense=None, ms: int = 0, break_points: tuple = (),
                          settings=None) -> BatchResult:
    """The hierarchical tier's backstop (``daqp_tpu/batch.py:2725``): the
    lanes whose flag is negative (the iteration limit, a numerical
    failure; exit 3, no degrees of freedom, is an outcome, not a failure),
    or whose x is not finite, walk the hierarchy again one by one in f64
    through the port's own ``quadprog(break_points=...)`` (``H=None``:
    the identity metric).  A lane that exits positive takes the new x,
    lam and fval; every re-solved lane takes the new flag."""
    from .api import quadprog
    bad = _loud_lanes(res, lambda fl: fl < 0)
    if not bad.any():
        return res
    sense_np = _sense_rows(sense, *res.lam.shape)
    st = _f64_settings(settings)
    dev = res.x.device
    n = res.x.shape[1]

    def one(b):
        return quadprog(None if H is None else H[b],
                        torch.zeros(n, dtype=torch.float64, device=dev)
                        if f is None else f[b], A[b], bupper[b], blower[b],
                        sense_np[b], ms=ms, break_points=break_points,
                        settings=st, dtype=torch.float64, device=dev)

    return _resolve_lanes(res, bad, one, lambda fl: fl > 0)
