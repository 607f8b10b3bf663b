"""Carry state from the JAX package over to the port, and back.

The functions read JAX objects only through ``np.asarray`` and field
access, so this module (like the rest of the package) never imports
jax.  They let a test feed one state to a JAX function and to its
counterpart here: JAX keeps slot state lanes-last ((m, B), (1, B)), the
port batch-leading ((B, m), (B,)).  The single-instance ``LDPState``
keeps its arrays as they are; its control scalars are Python values
here, 0-d arrays in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .ldp import LDPState
from .ldp_flat import FlatState
from .ops.dense import DenseState
from .ops.slot import SlotState
from .transform import LDPData
from .types import Settings, SoftWeights

# per-lane scalars: (1, B) in JAX, (B,) here
_SCALARS = ("fbound", "pend", "plam", "plo", "pid", "pdd", "fval",
            "best_fval", "cycle", "repaired", "iterations", "status")


def settings_from_jax(st) -> Settings:
    """A JAX ``Settings`` read field by field as Python scalars."""
    return Settings(**{
        name: type(default)(np.asarray(getattr(st, name)).item())
        for name, default in Settings._field_defaults.items()})


def slot_state_from_jax(s, device="cpu") -> SlotState:
    """JAX lanes-last ``SlotState`` -> the port's batch-leading state.

    JAX's padded shapes (m, n, K multiples of 8; padded rows immutable
    with +-INF bounds) carry over as they are: the caller passes the true
    n as ``n_true`` to ``run_slot_round``."""
    fields = {}
    for name in SlotState._fields:
        a = np.moveaxis(np.asarray(getattr(s, name)), -1, 0)
        if name in _SCALARS:
            a = a[:, 0]
        dtype = torch.int32 if name == "status" else torch.float32
        fields[name] = torch.as_tensor(np.array(a), device=device).to(dtype)
    return SlotState(**fields)


def slot_state_to_numpy(s: SlotState) -> dict:
    """The port's state as numpy arrays in JAX's lanes-last layout."""
    out = {}
    for name in SlotState._fields:
        a = getattr(s, name).detach().cpu().numpy()
        out[name] = a[None, :] if name in _SCALARS else np.moveaxis(a, 0, -1)
    return out


# DenseState fields of the JAX package beside the port's (pending one-hot
# pend_oh -> row index pid); the SOFT_WEIGHTS fields carry over where the
# JAX state has them
_JAX_NAME = {"plam": "pend_lam", "plo": "pend_lo"}
_DENSE_SCALARS = ("fbound", "pend", "pend_lam", "pend_lo", "fval",
                  "best_fval", "cycle", "repaired", "iterations", "status",
                  "pfix")


def dense_state_from_jax(s, m: int = None, n: int = None,
                         device="cpu") -> DenseState:
    """JAX lanes-last ``DenseState`` -> the port's batch-leading state.

    The JAX package pads m and n to multiples of 8; ``m`` / ``n`` (the true
    sizes, default: keep all) slice the padded rows and columns off.  The
    pending entry's (m, B) one-hot becomes the row index ``pid`` (-1 where
    no row is flagged).  A SOFT_WEIGHTS state's ``sw_*``, ``sfix`` and
    ``pfix`` carry over; on a plain or soft state they stay None."""
    fields = {}
    for name in DenseState._fields:
        if name == "pid":
            continue
        src = _JAX_NAME.get(name, name)
        if getattr(s, src, None) is None:
            fields[name] = None
            continue
        a = np.moveaxis(np.asarray(getattr(s, src)), -1, 0)
        if src in _DENSE_SCALARS:
            a = a[:, 0]
        elif name == "M":
            a = a[:, :m, :n]
        elif name == "E":
            a = a[:, :m, :m]
        elif name == "u":
            a = a[:, :n]
        else:
            a = a[:, :m]
        dtype = torch.int32 if name == "status" else torch.float32
        fields[name] = torch.as_tensor(np.array(a), device=device).to(dtype)
    oh = np.moveaxis(np.asarray(s.pend_oh), -1, 0)[:, :m]
    pid = np.where((oh > 0).any(1), np.argmax(oh > 0, axis=1), -1)
    fields["pid"] = torch.as_tensor(pid, device=device).to(torch.float32)
    return DenseState(**fields)


def dense_state_to_numpy(s: DenseState) -> dict:
    """The port's dense state as numpy arrays in the JAX package's
    lanes-last layout and field names, ``pend_oh`` rebuilt from ``pid``."""
    out = {}
    for name in DenseState._fields:
        if name == "pid" or getattr(s, name) is None:
            continue
        a = getattr(s, name).detach().cpu().numpy()
        jname = _JAX_NAME.get(name, name)
        out[jname] = a[None, :] if jname in _DENSE_SCALARS \
            else np.moveaxis(a, 0, -1)
    m = s.M.shape[1]
    pid = s.pid.detach().cpu().numpy()
    oh = (np.arange(m)[:, None] == pid[None, :]).astype(np.float32)
    out["pend_oh"] = oh * s.pend.detach().cpu().numpy()[None, :]
    return out


def from_lanes_last(a, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """One lanes-last JAX segment operand -> batch-leading: the lane axis
    moves to the front and a (1, B) carry becomes (B,).  Covers the
    operands of ``run_mpc_segment`` (duq / dlq (P, m, B) -> (B, P, m);
    its (P, B) outputs -> (B, P)) and ``run_prox_segment`` (Rinv_l
    (n, n, B), fz_l / x (n, B), bus_l / bls_l (m, B), the (1, B)
    carries) and ``run_lp_segment`` (``lp_vars_from_jax``)."""
    a = np.moveaxis(np.asarray(a), -1, 0)
    if a.ndim == 2 and a.shape[1] == 1:
        a = a[:, 0]
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def lp_vars_from_jax(lp_vars, device="cpu") -> tuple:
    """The JAX LP segment's lanes-last carries (``pallas_slot.py:1474-
    1477``: x (n, B); eps, stall, best, lane_run (1, B) f32; lflag (1, B)
    int32; tot, passes (1, B) f32) -> the port's ``LP_LANE`` tensors,
    batch-leading, in the same order."""
    return tuple(from_lanes_last(a, torch.int32 if i == 5 else torch.float32,
                                 device)
                 for i, a in enumerate(lp_vars))


def ldp_from_jax(ldpd, device="cpu") -> LDPData:
    """A batched (vmapped, batch-leading) JAX ``LDPData`` -> the port's."""
    return LDPData(**{
        name: torch.as_tensor(np.array(getattr(ldpd, name)), device=device)
        for name in LDPData._fields})


def flat_state_from_jax(s, device="cpu") -> FlatState:
    """A vmapped (batch-leading) JAX ``FlatState`` -> the port's (the
    slot and pending row ids as int64)."""
    fields = {}
    for name in FlatState._fields:
        v = getattr(s, name)
        if name == "sw":
            fields[name] = None if v is None else SoftWeights(
                *(torch.as_tensor(np.array(x), device=device) for x in v))
            continue
        t = torch.as_tensor(np.array(v), device=device)
        fields[name] = t.to(torch.int64) if name in ("sid", "pend_id") \
            else t
    return FlatState(**fields)


# LDPState's control scalars: Python ints / bools here, 0-d arrays in JAX
_LDP_INT = ("n_active", "ns_active", "iterations", "cycle_counter",
            "tried_repair", "status")
_LDP_BOOL = ("sing", "in_bnb")


def ldp_state_from_jax(s, device="cpu") -> LDPState:
    """A JAX single-instance ``LDPState`` -> the port's (WS as int64)."""
    fields = {}
    for name in LDPState._fields:
        v = getattr(s, name)
        if name == "sw":
            fields[name] = None if v is None else SoftWeights(
                *(torch.as_tensor(np.array(x), device=device) for x in v))
        elif name in _LDP_INT:
            fields[name] = int(np.asarray(v))
        elif name in _LDP_BOOL:
            fields[name] = bool(np.asarray(v))
        else:
            t = torch.as_tensor(np.array(v), device=device)
            fields[name] = t.to(torch.int64) if name == "WS" else t
    return LDPState(**fields)


def ldp_state_to_numpy(s: LDPState) -> dict:
    """The port's ``LDPState`` (or JAX's) as numpy arrays: every field,
    the scalars as 0-d arrays, WS as int32, ``sw`` as a tuple or None."""
    out = {}
    for name in LDPState._fields:
        v = getattr(s, name)
        if name == "sw":
            out[name] = None if v is None else tuple(_host(x) for x in v)
        else:
            out[name] = _host(v).astype(np.int32) if name == "WS" \
                else _host(v)
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(x)


def result_to_numpy(r) -> dict:
    """A single-instance result of either package (the port's ``Result``
    or the JAX one) as numpy arrays and Python numbers."""
    return dict(x=_host(r.x), lam=_host(r.lam), fval=float(_host(r.fval)),
                exitflag=int(_host(r.exitflag)),
                iterations=int(_host(r.iterations)),
                soft_slack=float(_host(r.soft_slack)),
                nodes=int(_host(r.nodes)))

