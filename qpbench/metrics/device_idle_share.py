"""Layer: the device.

1 - (the union of the device operations' intervals / the window), in %,
over the card-only traced window: the share of the window in which
nothing ran on the card (``chip_profile.py``'s arithmetic over the
measured window).  That trace records no host events, so the host keeps
nearly its untraced pace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
