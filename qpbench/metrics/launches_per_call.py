"""Layer: kernel dispatch (``ops/chol.py``, ``ops/slot.py``, ``ops/dense.py``,
and torch's operators between them).

Every kernel the card ran in the card-only traced window (the port's own,
cuBLAS's and torch's elementwise and reduction kernels alike; copies and
sets are not counted), over the calls of that window.  The port's own
kernels alone are ``own_launches_per_call``."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.trace_calls or not t.kernel_launches:
        return None
    return t.kernel_launches / ctx.trace_calls
