"""The byte model's least time for one loop step at the card's HBM rate,
over the device's busy time per loop step in the traced window, in %."""


def read(ctx):
    if not ctx.busy_s or ctx.hbm_bytes_per_s is None:
        return None
    least_s = ctx.step_bytes / ctx.hbm_bytes_per_s
    return 100 * least_s / (ctx.busy_s / sum(ctx.iterations))
