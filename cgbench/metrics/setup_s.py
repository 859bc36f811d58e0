"""Seconds from the harness's first statement to the first timed request:
importing torch and the port, the CUDA context, the kernel library (built
in the first run of a checkout), the inputs, the port's set-up and one warm
request of the cell's shape."""


def read(ctx):
    return ctx.setup_s
