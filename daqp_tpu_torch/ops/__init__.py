"""Kernels of the port: each wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch twin on a CPU tensor.

``host_any`` is the host loops' one way to read a device flag, and
``host_read`` / ``host_numpy`` read device values; ``host_syncs`` counts
those reads (each one waits for the device)."""
import time

import torch

from ..types import EXIT_RUNNING, EXIT_TIMELIMIT

host_syncs = 0


def host_any(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted in ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return bool(mask.any())


def host_read(*xs):
    """The values of 0-d tensors as Python floats, read in one transfer
    and counted once in ``host_syncs``: one value for one tensor, else a
    list in the order given (integers and booleans read as exact
    floats)."""
    global host_syncs
    host_syncs += 1
    if len(xs) == 1:
        return float(xs[0])
    return torch.stack([torch.as_tensor(x).to(torch.float64)
                        for x in xs]).tolist()


def host_numpy(*xs):
    """The tensors as numpy arrays on the host, counted once in
    ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return [x.detach().cpu().numpy() for x in xs]


def late(deadline) -> bool:
    """Whether the host's clock is past ``deadline`` (absolute
    ``time.perf_counter()`` seconds; never for None): no device sync."""
    return deadline is not None and time.perf_counter() > deadline


def check_deadline(s, deadline):
    """``s`` (a state with a per-lane ``status``) with its RUNNING lanes
    set to EXIT_TIMELIMIT once ``late(deadline)``."""
    if not late(deadline):
        return s
    return s._replace(status=torch.where(
        s.status == EXIT_RUNNING, EXIT_TIMELIMIT, s.status).to(torch.int32))
