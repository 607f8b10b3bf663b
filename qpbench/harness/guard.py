"""The check that nothing of JAX or of the JAX package is loaded.

Module names are compared by their top-level name (the part before the
first dot) as a whole: ``daqp_tpu_torch`` is the port and passes,
``daqp_tpu`` and ``daqp_tpu.batch`` are the JAX package and fail."""
from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "daqp_tpu"})


def banned_modules(modules=None) -> list:
    """The loaded modules whose top-level name is banned, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)
