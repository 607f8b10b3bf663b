"""Mixed-integer QP by branch and bound over BINARY rows, one problem.

Counterpart of ``daqp_tpu/bnb.py`` (``:69 _truncate_ws``, ``:86
_add_fixed_binary``, ``:98 _rebuild_node``, ``:117 _replay_warmstart``,
``:156 _find_branch``, ``:176 bnb_init``, ``:217 bnb_run``, ``:374
bnb_finalize``, ``:408 bnb_core``), the reference's ``src/bnb.c``.  A
binary row holds with equality at its lower or upper bound; the tree
fixes one at a time and solves warm dual relaxations on the port's
``ldp.py``:

* depth first, two children a branch, the endpoint nearest the
  relaxation first (bnb.c:130-156: the first binary whose value lies
  off both endpoints by more than the scaled primal tolerance);
* the dominance cut: the incumbent enters the relaxations' dual
  objective bound ``fval_bound`` with ``rel_subopt`` / ``abs_subopt``
  folded in, and a dominated relaxation exits INFEASIBLE (bnb.c:29-31,
  62, daqp.c:20-23);
* warm starts: a spawned node keeps its parent's free working set (row
  ids with a side) in ``tree_ws`` and replays it on entry; the first
  child processed right after its parent adds its binary to the live
  workspace (the sibling fast path, bnb.c:99-112); a singular replay
  stops there;
* a relaxation that cycles is restarted cold once (bnb.c:118-125).

Where the reference truncates its LDL factor to a clean prefix, the
inverse Gram is downdated entry by entry from the end
(``_truncate_ws``).  The JAX module's fixed-capacity stack arrays (a
``jit`` requirement) are Python lists here; the visiting order is the
same.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from . import core
from . import ldp as ldp_mod
from . import transform
from .ops import host_numpy, late
from .types import (ACTIVE, BINARY, EXIT_CYCLE, EXIT_INFEASIBLE,
                    EXIT_OPTIMAL, EXIT_RUNNING, EXIT_TIMELIMIT, IMMUTABLE,
                    LOWER, Settings)


class BnBOut(NamedTuple):
    x: torch.Tensor
    lam: torch.Tensor
    fval: torch.Tensor
    exitflag: int
    iterations: int
    soft_slack: torch.Tensor
    nodes: int


class _Node(NamedTuple):
    bid: int        # the binary row fixed at this node
    lower: bool     # fixed at its lower bound
    depth: int      # -1 at the root
    ws0: int        # the parent's working set: tree_ws[ws0:ws1]
    ws1: int


def _truncate_ws(state: ldp_mod.LDPState, keep: int, st: Settings):
    """Remove working-set entries from the end down to ``keep``; a fixed
    binary removed loses IMMUTABLE and can be branched on again
    (``daqp_node_cleanup_workspace``, bnb.c:175-187).  Removing the last
    entry never re-adds another, so one read gives every entry."""
    k = state.n_active
    if k <= keep:
        return state
    ws, bits = host_numpy(state.WS[:k], state.sense)
    for pos in range(k - 1, keep - 1, -1):
        idx, b = int(ws[pos]), int(bits[ws[pos]])
        state = ldp_mod.remove_constraint(state, pos, st, (idx, b))
        if b & BINARY:
            state = state._replace(sense=ldp_mod._put(
                state.sense, idx, state.sense[idx] & ~IMMUTABLE))
    return state


def _add_fixed_binary(state: ldp_mod.LDPState, bid: int, lower: bool,
                      st: Settings):
    """Fix binary row ``bid`` at one bound as an immutable equality
    (``daqp_add_upper_lower`` + IMMUTABLE, bnb.c:106-107, 224-236)."""
    bits = state.sense[bid] | LOWER if lower else state.sense[bid] & ~LOWER
    state = state._replace(sense=ldp_mod._put(state.sense, bid, bits))
    state = ldp_mod.add_constraint(state, bid, -1.0 if lower else 1.0, st)
    return state._replace(sense=ldp_mod._put(
        state.sense, bid, state.sense[bid] | IMMUTABLE))


def _rebuild(state, neq: int, fixed: List[tuple], depth: int, st):
    """The cold node: truncated to the equality prefix, then the fixed
    path fixed[0..depth] re-added until one is singular
    (``daqp_setup_cold_bnb``, bnb.c:238-246)."""
    state = _truncate_ws(state, neq, st)
    for i in range(min(depth + 1, len(fixed))):
        if state.sing:
            break
        state = _add_fixed_binary(state, *fixed[i], st)
    return state


def _replay_warmstart(state, codes: List[int], st: Settings):
    """Re-add a node's saved working set (codes id * 2 + is_lower) until
    an add is singular, which is undone (``daqp_warmstart_node``,
    bnb.c:190-209)."""
    for code in codes:
        bid, lower = code // 2, code % 2 == 1
        bits = state.sense[bid] | LOWER if lower \
            else state.sense[bid] & ~LOWER
        state = state._replace(sense=ldp_mod._put(state.sense, bid, bits))
        state = ldp_mod.add_constraint(state, bid, -1.0 if lower else 1.0,
                                       st)
        if state.sing:
            pos = state.n_active - 1
            return state._replace(
                n_active=pos, sing=False, sense=ldp_mod._put(
                    state.sense, bid, state.sense[bid] & ~ACTIVE))
    return state


def _find_branch(state: ldp_mod.LDPState, bin_ids: torch.Tensor,
                 st: Settings):
    """The first binary off both endpoints by more than primal_tol
    scaled, and its nearest endpoint (``daqp_get_branch_id`` +
    ``daqp_binary_diff``, bnb.c:6-21, 130-156), as device values: (found,
    the binary's row, whether its lower side comes first)."""
    mu = state.M[bin_ids] @ state.u
    du, dl = state.dupper[bin_ids], state.dlower[bin_ids]
    diff = 0.5 * (du + dl) - mu
    dist = 0.5 * (du - dl) - diff.abs()
    fixed = (state.sense[bin_ids] & ACTIVE) > 0
    frac = ~fixed & (dist > st.primal_tol * state.scaling[bin_ids])
    pos = torch.argmax(frac.to(torch.int32))     # the first one
    return frac.any(), bin_ids[pos], diff[pos] >= 0


def _solve_node(state, st_node: Settings, deadline):
    s = state._replace(status=EXIT_RUNNING, tried_repair=0, cycle_counter=0,
                       best_fval=torch.full_like(state.fval, -1.0))
    return ldp_mod.ldp_solve(s, st_node, deadline=deadline)


class BnBCarry(NamedTuple):
    """The tree between waves (``daqp_tpu/bnb.py``'s ``BnBCarry``): the
    workspace, the node stack (top last), the saved working sets, the
    fixed path, the equality count, the folded incumbent bound, the
    incumbent's u, the node and iteration counts and the status."""
    state: ldp_mod.LDPState
    stack: List[_Node]
    tree_ws: List[int]
    fixed: List[tuple]
    neq: int
    bound: torch.Tensor       # () the dominance bound, subopt folded in
    incumbent_u: Optional[torch.Tensor]
    incumbent_found: bool
    nodecount: int
    itercount: int
    status: int


def bnb_init(ldpd: transform.LDPData, bin_ids: tuple, st: Settings,
             K: int) -> BnBCarry:
    """The root on the stack, the equalities (and sense-ACTIVE rows)
    activated, the bound from ``st.fval_bound``."""
    state = ldp_mod.init_state(ldpd.M, ldpd.dupper, ldpd.dlower, ldpd.sense,
                               ldpd.scaling, K=K)._replace(in_bnb=True)
    act_flag, state = ldp_mod.activate_constraints(state, st)
    eps_r = 1.0 / (1.0 + st.rel_subopt)
    bound = torch.tensor((st.fval_bound - st.abs_subopt) * eps_r,
                         dtype=ldpd.M.dtype, device=ldpd.M.device)
    return BnBCarry(
        state=state, stack=[_Node(0, False, -1, 0, 0)], tree_ws=[],
        fixed=[(0, False)] * max(len(bin_ids), 1), neq=state.n_active,
        bound=bound, incumbent_u=None, incumbent_found=False, nodecount=0,
        itercount=0, status=act_flag if act_flag < 0 else EXIT_RUNNING)


def bnb_run(c: BnBCarry, bin_ids: tuple, st: Settings,
            node_budget: Optional[int] = None,
            deadline: float = None) -> BnBCarry:
    """Process nodes from the stack until it empties, the solve errors,
    the iteration limit is reached or ``node_budget`` nodes have been
    processed (the resumable form behind the incumbent-bound exchange
    between waves, ``parallel.sharding.solve_miqp_sharded``)."""
    state, neq, bound = c.state, c.neq, c.bound
    stack, tree_ws, fixed = list(c.stack), list(c.tree_ws), list(c.fixed)
    incumbent_u, found_any = c.incumbent_u, c.incumbent_found
    nodes, iters, status = c.nodecount, c.itercount, c.status
    target = None if node_budget is None else nodes + node_budget
    bins = torch.as_tensor(bin_ids, dtype=torch.int64,
                           device=state.M.device)
    eps_r = 1.0 / (1.0 + st.rel_subopt)
    while stack and status == EXIT_RUNNING and iters < st.iter_limit \
            and (target is None or nodes < target):
        node = stack.pop()
        nodes += 1
        depth = node.depth
        if depth >= 0:
            if depth < len(fixed):
                # (a binary whose fixing was dropped as singular can be
                # branched on again, deeper than nb: the JAX module's
                # fixed path keeps its first nb entries)
                fixed[depth] = (node.bid, node.lower)
            if stack and stack[-1].depth == depth:
                # the workspace still holds the parent: add our binary,
                # or rebuild cold if it is singular (bnb.c:108-110)
                state = _add_fixed_binary(state, node.bid, node.lower, st)
                if state.sing:
                    state = _rebuild(state, neq, fixed, depth, st)
            else:
                state = _rebuild(state, neq, fixed, depth, st)
                state = _replay_warmstart(state,
                                          tree_ws[node.ws0:node.ws1], st)
                # tree_ws rewinds to this node's slice (bnb.c:208)
                del tree_ws[node.ws0:]
        st_node = st._replace(fval_bound=bound)
        state = _solve_node(state, st_node, deadline)
        iters += state.iterations
        if state.status == EXIT_CYCLE:
            state = _rebuild(state, neq, fixed, depth, st)
            state = _solve_node(state, st_node, deadline)
            iters += state.iterations
        flag = state.status
        if flag == EXIT_INFEASIBLE:
            pass                    # pruned: dominated or infeasible
        elif flag < 0:
            status = flag
        else:
            k = state.n_active
            frac, bid, lower_first = _find_branch(state, bins, st)
            got, ws, bits = host_numpy(
                torch.stack([frac.to(torch.int64), bid,
                             lower_first.to(torch.int64)]),
                state.WS[:k], state.sense)
            if not got[0]:
                # integer feasible: the new incumbent and bound (bnb.c:68)
                bound = (0.5 * state.fval - st.abs_subopt) * eps_r
                incumbent_u, found_any = state.u, True
            else:
                # the free working set, the fixed binaries left out
                # (bnb.c:211-222)
                ws0 = len(tree_ws)
                fix = IMMUTABLE | BINARY
                tree_ws += [int(w) * 2 + int(bits[w] & LOWER > 0)
                            for w in ws[neq:k] if bits[w] & fix != fix]
                near = bool(got[2])
                for lower in (not near, near):   # nearest on top
                    stack.append(_Node(int(got[1]), lower, depth + 1, ws0,
                                       len(tree_ws)))
        # the tree's own wall-clock check every 32 nodes (bnb.c:51-59)
        if nodes % 32 == 0 and status == EXIT_RUNNING and late(deadline):
            status = EXIT_TIMELIMIT
    return c._replace(state=state, stack=stack, tree_ws=tree_ws,
                      fixed=fixed, bound=bound, incumbent_u=incumbent_u,
                      incumbent_found=found_any, nodecount=nodes,
                      itercount=iters, status=status)


def bnb_finalize(c: BnBCarry, st: Settings) -> BnBCarry:
    """The incumbent's u in the state, its fval from the folded bound,
    and the final status (bnb.c:77-89)."""
    status, state = c.status, c.state
    if c.incumbent_found:
        eps_r = 1.0 / (1.0 + st.rel_subopt)
        status = status if status < EXIT_INFEASIBLE else EXIT_OPTIMAL
        state = state._replace(
            u=c.incumbent_u,
            fval=2.0 * c.bound / eps_r + 2.0 * st.abs_subopt)
    elif status == EXIT_RUNNING:
        status = EXIT_INFEASIBLE
    return c._replace(state=state, status=status)


def bnb_solve(ldpd: transform.LDPData, bin_ids: tuple, st: Settings, K: int,
              deadline: float = None):
    """Branch and bound on a built LDP of one problem: (final state,
    status, iterations, nodes)."""
    c = bnb_init(ldpd, bin_ids, st, K)
    c = bnb_finalize(bnb_run(c, bin_ids, st, deadline=deadline), st)
    return c.state, c.status, c.itercount, c.nodecount


def bnb_core(H, f, A, bupper, blower, sense, ms: int, st: Settings,
             bin_ids: tuple = (), deadline: float = None,
             K: int = None) -> BnBOut:
    """The MIQP entry (the api.c dispatch to ``work->bnb``): build the
    LDP, branch and bound, extract.  ``bin_ids``: the BINARY rows."""
    n = A.shape[1] if A.numel() else H.shape[0]
    K = n + 1 if K is None else K
    ldpd = core.build_ldp(H, f, A, bupper, blower, sense, ms, st)
    state, status, iters, nodes = bnb_solve(ldpd, bin_ids, st, K,
                                            deadline=deadline)
    x = transform.ldp_to_qp_solution(core.batched(ldpd), state.u[None])[0]
    return BnBOut(x=x, lam=core.extract_duals(state),
                  fval=0.5 * (state.fval - ldpd.v @ ldpd.v),
                  exitflag=status, iterations=iters,
                  soft_slack=state.soft_slack, nodes=nodes)
