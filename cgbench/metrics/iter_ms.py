"""The traced window's host-clock time over the loop steps run in it."""


def read(ctx):
    return 1e3 * ctx.window_s / sum(ctx.iterations)
