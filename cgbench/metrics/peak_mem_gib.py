"""The device's allocated peak from the moment the inputs were made
(``reset_peak_memory_stats``) to the window's close: the port's set-up
and the window, with the inputs still resident."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
