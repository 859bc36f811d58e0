"""The port's kernel launches in the window (the change in the sum of
``ops/cuda/_common.LAUNCHES``) over the loop steps run."""


def read(ctx):
    return ctx.launches / sum(ctx.iterations)
