"""Blocking host reads of the loop's state a request: the port's
``cg.live_read`` and ``cg.poll_wait`` counts over its ``cg.solve`` count."""

from cgbench.spans import totals


def read(ctx):
    t = totals()
    if not t:
        return None
    reads = sum(t.get(name, {}).get("n", 0) for name in ("cg.live_read", "cg.poll_wait"))
    return reads / t["cg.solve"]["n"]
