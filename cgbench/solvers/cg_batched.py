"""R right-hand sides a request, solved together through the port's
``cg_solve_batched(A, B, tol=tol_rel * ||B_j|| per lane)``: x0 = 0 and
the default cap of n + 1 iterations."""

from __future__ import annotations

import torch


class Entry:
    def __init__(self, port, A, pool: list, traffic: dict, spans: dict, sync):
        self.port, self.A, self.pool = port, A, pool
        self.tols = [traffic["tol_rel"] * torch.linalg.vector_norm(B.double(), dim=1).to(B.dtype)
                     for B in pool]

    def request(self, j: int):
        """Solve the block pool[j]: (X, iterations, converged), the last two
        per lane."""
        X, info = self.port.cg_solve_batched(self.A, self.pool[j], tol=self.tols[j])
        return X, info.iterations, info.converged
