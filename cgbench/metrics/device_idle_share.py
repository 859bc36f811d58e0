"""The share of the traced window in which no operation ran on the device:
1 - (the union of device activity / the traced window), in %."""


def read(ctx):
    if not ctx.busy_s:
        return None
    return 100 * (1 - ctx.busy_s / ctx.trace_window_s)
