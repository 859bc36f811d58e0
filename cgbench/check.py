"""The comparison that decides ``correct``.

Each answer the window kept (the last solve of every request in the pool,
the request in flight at the close among them) is judged against the
plain reference, in float64, on the same right-hand sides:

* ``true_res``: the widest ||b - A x|| / ||b|| over the kept right-hand
  sides, A the reference operator built from the configuration;
* ``x_gap``: the widest ||x - x_ref|| / ||x_ref||, x_ref the reference CG's
  answer to the same tolerance (``reference/cg.py``);
* ``unconverged``: the window's requests whose solve did not report
  convergence (an exact count, limit 0).

The limits are the cell's ``limits/<workload>.json``, set from the
program's readings over many seeds and the control's (PERF.md).  A number
the file does not name is printed but not compared: where the control does
not read three times the program's, it has no upper reading to set a limit
below.
"""

from __future__ import annotations

import torch

#: the names compared, in the order they are printed
NAMES = ("unconverged", "true_res", "x_gap")


def readings(bench, cfg: dict, traffic: dict, pool: list, kept: dict) -> dict:
    """true_res and x_gap of the answers ``kept`` ({pool index: x})."""
    ref = bench.module("reference", cfg["operator"])
    refcg = bench.module("reference", "cg")
    n = ref.n(cfg)

    def matvec(v):
        return ref.matvec(cfg, v)

    res, gap, iters = 0.0, 0.0, []
    for j in sorted(kept):
        B = pool[j].reshape(-1, n).double()
        X = kept[j].reshape(-1, n).double()
        bnorm = torch.linalg.vector_norm(B, dim=1)
        tol = traffic["tol_rel"] * bnorm
        Xr, kr = refcg.cg(matvec, B, tol, n + 1)
        res = max(res, float((torch.linalg.vector_norm(B - matvec(X), dim=1) / bnorm).max()))
        gap = max(gap, float((torch.linalg.vector_norm(X - Xr, dim=1)
                              / torch.linalg.vector_norm(Xr, dim=1)).max()))
        iters.extend(int(k) for k in kr)
        del B, X, Xr
    return {"true_res": res, "x_gap": gap, "ref_iters": iters}


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each compared number, and whether all
    are within their limits (a NaN is not)."""
    limits = {"unconverged": 0, **limits}
    compared = {name: {"value": values[name], "limit": limits[name]}
                for name in NAMES if name in limits}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return {"compared": compared, "correct": bool(ok)}
