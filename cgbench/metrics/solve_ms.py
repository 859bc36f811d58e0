"""Time to tolerance per right-hand side: the window's wall time over the
right-hand sides solved in it."""


def read(ctx):
    return 1e3 * ctx.window_s / (ctx.requests * ctx.rhs_per_request)
