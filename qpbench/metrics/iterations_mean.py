"""Layer: the active-set solver (the slot and dense-mask states).

The mean of the iterations each answer of a traced run's first window
(untraced) reports."""


def read(ctx):
    it = ctx.iterations
    return float(it.double().mean()) if it.numel() else None
