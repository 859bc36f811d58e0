"""Preconditioners.  Counterpart of the Jacobi part of
``conjugategradient_tpu/solver/precond.py``."""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..types import as_linear_operator


def jacobi_preconditioner(A: Any, eps: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """M⁻¹ r = r / diag(A).  ``eps`` guards against (near-)zero diagonals.

    The returned apply carries ``inv_diag`` so ``cg_solve`` can send a
    Jacobi solve to the fused PCG kernels, which fold the apply into the
    direction update and the ρ reduction.
    """
    op = as_linear_operator(A)
    d = op.diagonal()
    if eps:
        d = torch.where(d.abs() > eps, d, torch.sign(d) * eps + (d == 0) * eps)
    inv_d = 1.0 / d

    def apply(r: torch.Tensor) -> torch.Tensor:
        return inv_d * r

    apply.inv_diag = inv_d
    return apply
