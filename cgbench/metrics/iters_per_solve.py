"""Loop steps per request as the port reports them (``CGInfo.iterations``;
lockstep: the slowest lane), the mean over the window's requests."""


def read(ctx):
    return sum(ctx.iterations) / len(ctx.iterations)
