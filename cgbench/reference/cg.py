"""Plain reference CG, with the port's stated semantics: x0 = 0, the
recurrence residual, Hestenes-Stiefel alpha and beta, and each iteration
testing the residual it starts from (done once ||r_k|| <= tol, seen one
update late, so the step that sees it still updates x).  A block of L
right-hand sides, one a row, runs as L independent solves, each lane
frozen once done.  Plain torch only: it imports nothing of the port."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], B: torch.Tensor, tol: torch.Tensor,
       maxiter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A x_l = B[l] for each row of B (L, n) to ||r_l|| <= tol[l],
    in B's dtype; return X (L, n) and each lane's iterations (L,)."""
    X = torch.zeros_like(B)
    R = B.clone()
    P = R.clone()
    rho = (R * R).sum(dim=1)
    k = torch.zeros(B.shape[0], dtype=torch.int64, device=B.device)
    done = torch.zeros(B.shape[0], dtype=torch.bool, device=B.device)
    tol = tol.to(rho.dtype)
    for _ in range(maxiter):
        live = ~done
        if not bool(live.any()):
            break
        Q = matvec(P)
        pap = (P * Q).sum(dim=1)
        exact = rho == 0
        alpha = torch.where(exact | ~live, 0, rho / torch.where(exact, 1, pap))
        X += alpha[:, None] * P
        R -= alpha[:, None] * Q
        done = done | torch.isnan(rho) | (torch.sqrt(rho) <= tol)
        rho_next = (R * R).sum(dim=1)
        beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, rho))
        P = torch.where(live[:, None], R + beta[:, None] * P, P)
        rho = torch.where(live, rho_next, rho)
        k += live.to(torch.int64)
    return X, k
