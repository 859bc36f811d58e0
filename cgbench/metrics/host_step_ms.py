"""Host milliseconds to enqueue one launched loop step: the port's
``cg.step`` spans, their seconds over their count.  Beside the device's busy
time a step, it says which side paces the cell."""

from cgbench.spans import totals


def read(ctx):
    step = totals().get("cg.step")
    return 1e3 * step["s"] / step["n"] if step else None
