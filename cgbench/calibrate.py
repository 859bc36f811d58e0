"""Readings from which a cell's correctness limits are set (PERF.md), in one
process on the card:

    python3 -m cgbench.calibrate --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9

For each of ``--seeds``: the requests the window would serve (the pool that
seed draws), each solved once through the cell's own request entry, and the
two numbers ``check.readings`` compares (the lower readings).  For each of
``--control-seeds``: the control in the program's place, the plain
reference CG computed one precision lower than the cell states (bfloat16
for float32, float32 for float64) and capped at three times the program's
steps, judged the same way (the upper readings).  With ``--faults``: the
readings of faults planted in the program's answers on the first three
seeds (a state returned unchanged, half of a block's lanes left out, an
answer altered).  One JSON
line a reading.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check
from .spec import Bench
from .traffic import draw_pool, dtype_of

#: program seeds whose answers also carry the planted faults
FAULT_SEEDS = 3
#: the control's precision: the nearest below the cell's
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


class Control:
    """The reference CG in the program's place, in ``dtype``."""

    def __init__(self, bench, cfg, traffic, pool, dtype, maxiter):
        self.ref = bench.module("reference", cfg["operator"])
        self.cg = bench.module("reference", "cg").cg
        self.cfg, self.pool, self.dtype, self.maxiter = cfg, pool, dtype, maxiter
        self.tol_rel = traffic["tol_rel"]

    def request(self, j):
        n = self.ref.n(self.cfg)
        B = self.pool[j].reshape(-1, n)
        tol = self.tol_rel * torch.linalg.vector_norm(B.double(), dim=1)
        X, k = self.cg(lambda v: self.ref.matvec(self.cfg, v), B.to(self.dtype), tol,
                       self.maxiter)
        return X.to(B.dtype).reshape(self.pool[j].shape), k, torch.ones_like(k, dtype=torch.bool)


def faults(x: torch.Tensor) -> dict:
    """Planted faults of an answer, as the program would return them."""
    out = {"unchanged": torch.zeros_like(x), "altered": x * (1 + 1e-3)}
    if x.ndim == 2:
        half = x.clone()
        half[x.shape[0] // 2:] = 0
        out["half_batch"] = half
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    import conjugategradient_tpu_torch as port

    bench = Bench()
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cell = bench.workload(args.workload)
    cfg, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    ref = bench.module("reference", cfg["operator"])
    A = bench.module("operators", cfg["operator"]).build(
        port, cfg, dtype_of(traffic), dev)
    solver = bench.module("solvers", traffic["solver"])
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def emit(**kw):
        print(json.dumps({"workload": args.workload, "device": kind, **kw}), flush=True)

    most = 0
    for i, seed in enumerate(int(s) for s in args.seeds.split(",") if s):
        pool = draw_pool(traffic, ref.shape(cfg), seed, dev)
        entry = solver.Entry(port, A, pool, traffic, {}, sync)
        kept, iters, conv = {}, [], []
        t0 = time.perf_counter()
        for j in range(len(pool)):
            x, it, c = entry.request(j)
            sync()
            kept[j] = x
            iters.append(int(it.max()))
            conv.append(bool(c.all()))
        solve_s = time.perf_counter() - t0
        most = max(most, *iters)
        r = check.readings(bench, cfg, traffic, pool, kept)
        emit(kind="program", seed=seed, true_res=r["true_res"], x_gap=r["x_gap"],
             iterations=iters, ref_iterations=r["ref_iters"], converged=all(conv),
             solve_s=solve_s, check_s=time.perf_counter() - t0 - solve_s)
        if args.faults and i < FAULT_SEEDS:
            for name in ("unchanged", "altered", "half_batch"):
                bad = {j: faults(x).get(name) for j, x in kept.items()}
                if all(v is not None for v in bad.values()):
                    r = check.readings(bench, cfg, traffic, pool, bad)
                    emit(kind=f"fault:{name}", seed=seed, true_res=r["true_res"],
                         x_gap=r["x_gap"])
        del entry, kept
    low = LOWER[dtype_of(traffic)]
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        pool = draw_pool(traffic, ref.shape(cfg), seed, dev)
        ctl = Control(bench, cfg, traffic, pool, low, 3 * max(most, 1))
        kept, iters = {}, []
        for j in range(len(pool)):
            x, k, _ = ctl.request(j)
            kept[j] = x
            iters.append(int(k.max()))
        r = check.readings(bench, cfg, traffic, pool, kept)
        emit(kind=f"control:{str(low).split('.')[-1]}", seed=seed, true_res=r["true_res"],
             x_gap=r["x_gap"], iterations=iters, cap=3 * max(most, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
