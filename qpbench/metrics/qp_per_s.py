"""End to end: QPs answered a second.

Every QP handed to the port in the window (lanes, or scenarios x steps,
a call, times the calls) over the window on the host clock: from the
start of the first timed call to the end of the first call that ends
after ``--seconds``."""


def read(ctx):
    return ctx.attempted / ctx.window_s
