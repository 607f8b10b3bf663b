"""End to end: set-up time.

The host clock from the start of the process to the first timed call:
imports, the CUDA context, the kernels' library (built into the checkout's
``build/`` on a first run there, loaded after), the cell's inputs made on
the device and one warm call."""


def read(ctx):
    return ctx.setup_s
