"""Host milliseconds a request spends outside its loop: the port's
``cg.solve`` seconds less its ``cg.loop`` seconds, over the ``cg.solve``
count (routing, the operator's wrapping, the state's and work buffers'
allocation, the result's assembly)."""

from cgbench.spans import totals


def read(ctx):
    t = totals()
    if not t:
        return None
    loop = t.get("cg.loop", {}).get("s", 0.0)
    return 1e3 * (t["cg.solve"]["s"] - loop) / t["cg.solve"]["n"]
