"""Scale-out over ``torch.distributed``: batches split by rank, the
tree-sharded MIQP, process-group wiring.

Counterpart of ``daqp_tpu/parallel``.  Submodules load lazily, so that
``parallel.distributed.initialize`` can be imported and called before
the solver stack is."""
import importlib

_LAZY = {
    "make_mesh": "sharding",
    "solve_batch_sharded": "sharding",
    "exchange_incumbent": "sharding",
    "solve_miqp_sharded": "sharding",
    "solve_batch_miqp_sharded": "sharding",
    "ShardedStats": "sharding",
    "World": "distributed",
    "initialize": "distributed",
    "global_mesh": "distributed",
    "distribute_batch": "distributed",
}


def __getattr__(name):
    if name in ("sharding", "distributed"):
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY:
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
