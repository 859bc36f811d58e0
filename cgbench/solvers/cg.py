"""One right-hand side a request, through the port's public entry point
``cg_solve(A, b, tol=tol_rel * ||b||)``: fused="auto", x0 = 0 and the
default cap of n + 1 iterations."""

from __future__ import annotations

import time

import torch


class Entry:
    def __init__(self, port, A, pool: list, traffic: dict, spans: dict, sync):
        self.port, self.A, self.pool = port, A, pool
        self.tols = [traffic["tol_rel"] * float(torch.linalg.vector_norm(b.double()))
                     for b in pool]
        from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

        if hasattr(A, "packed") and bell_packed_route(A):
            # the view of the nonzeros the fused step reads: built once per
            # operator and kept with it, so the solves that follow reuse it
            t0 = time.perf_counter()
            A.packed()
            sync()
            spans["pack_s"] = time.perf_counter() - t0

    def request(self, j: int):
        """Solve pool[j]: (x, iterations, converged), the last two tensors."""
        x, info = self.port.cg_solve(self.A, self.pool[j], tol=self.tols[j], fused="auto")
        return x, info.iterations, info.converged
