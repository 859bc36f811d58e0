"""Mixed-precision CG with iterative refinement (CG-IR).  Counterpart of
``conjugategradient_tpu/solver/refine.py``: the same algorithm, arguments,
defaults, guards and history.

Halving the operator's value bytes with ``bfloat16`` storage halves what
the SpMV streams, but plain low-precision CG stalls at the storage dtype's
resolution.  Iterative refinement (Carson & Higham, SIAM J. Sci. Comput.
2018) keeps ONE high-precision copy of the operator for residuals, runs
the inner solves against the low-precision copy, and corrects::

    r_j = b - A_hi x_j          (high-precision true residual)
    solve A_lo d_j = r_j        (inner CG, loose relative tolerance)
    x_{j+1} = x_j + d_j

Each refinement contracts the error by roughly ``eps_lo * kappa(A)`` until
the high dtype's own floor.  The low copy shares the high one's structure
tensors (``astype`` casts the values only).

The outer loop runs on the host: one matvec, one host read of ‖r‖² and one
inner solve per refinement; the inner iteration counts stay on the device
until the end.  The inner ``cg_solve`` keeps its own loop on
the device (on a CUDA device, a float32-vector solve on bfloat16 blocked-ELL
tiles runs the bf16 forms of the fused kernels 1 or 4 and 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..types import as_linear_operator
from .cg import CGInfo, cg_solve


@dataclasses.dataclass(frozen=True)
class RefineInfo:
    """Metadata for a refined solve (host values)."""

    refinements: int  # outer correction steps taken
    inner_iterations: int  # total CG iterations across all inner solves
    converged: bool  # ‖r‖ (true, high-precision) met tol
    rnorm_sq: float  # final true ‖r‖²
    rnorm_history: Tuple[float, ...]  # true ‖r‖² before each outer step + final
    inner_infos: Tuple[CGInfo, ...]  # per-inner-solve CGInfo


def refined_cg_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float,
    low_dtype=torch.bfloat16,
    A_low: Any = None,
    inner_tol: float = 1e-2,
    inner_maxiter: Optional[int] = None,
    max_refinements: int = 20,
    min_contraction: float = 0.5,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
    recompute_r_every: int = 0,
    fused: str = "auto",
) -> Tuple[torch.Tensor, RefineInfo]:
    """Solve ``A x = b`` to high-precision ``tol`` with low-precision inner CG.

    Args:
      A: the HIGH-precision operator (LinearOperator / dense / callable with
        ``n=``), used only for the outer true residuals, one matvec per
        refinement.
      b: right-hand side (high precision; its dtype sets the recurrences').
      tol: ABSOLUTE tolerance on the true ‖b − A x‖₂ (as in
        :func:`~.cg.cg_solve`).  Must be > 0.
      low_dtype: storage dtype of the inner operator (default bfloat16),
        built by ``A.astype(low_dtype)`` unless ``A_low`` is given.
      A_low: a pre-built low-precision operator, for a cheap operator in
        another LAYOUT too (e.g. a bf16 DIA copy of a CSR high operator).
      inner_tol: RELATIVE tolerance of each inner solve (× the current
        outer ‖r‖).
      inner_maxiter: per-inner-solve cap (default N+1, like cg_solve).
      max_refinements: outer-step cap.
      min_contraction: stagnation guard: stop (unconverged) when an outer
        step fails to shrink ‖r‖ by at least this factor.
      M / recompute_r_every / fused: forwarded to the inner ``cg_solve``.

    Returns ``(x, RefineInfo)``; ``x`` has ``b``'s dtype.
    """
    if float(tol) <= 0.0:
        raise ValueError("refined_cg_solve needs tol > 0 (absolute ‖r‖ target)")
    op_hi = as_linear_operator(A, n=n, dtype=b.dtype, device=b.device)
    op_lo = (
        as_linear_operator(A_low, n=n, device=b.device) if A_low is not None
        else op_hi.astype(low_dtype)
    )
    if op_lo.shape != op_hi.shape:
        raise ValueError(f"A_low shape {op_lo.shape} != A shape {op_hi.shape}")
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    acc = torch.promote_types(b.dtype, torch.float32)

    history: List[float] = []
    inner_infos: List[CGInfo] = []
    converged = False
    rnorm_sq = float("nan")
    for j in range(max_refinements + 1):
        r = b - op_hi.matvec(x)
        rnorm_sq = float(torch.sum(r.to(acc) ** 2))  # the refinement's one host read
        history.append(rnorm_sq)
        rnorm = rnorm_sq ** 0.5
        if math.isnan(rnorm_sq) or rnorm <= tol:
            converged = bool(rnorm <= tol)
            break
        if len(history) >= 2 and not (rnorm_sq < min_contraction**2 * history[-2]):
            break  # stagnated at the low dtype's floor
        if j == max_refinements:
            break
        d, info = cg_solve(
            op_lo,
            r,
            tol=inner_tol * rnorm,
            maxiter=inner_maxiter,
            M=M,
            recompute_r_every=recompute_r_every,
            fused=fused,
        )
        inner_infos.append(info)
        x = x + d.to(b.dtype)

    inner_total = sum(torch.max(i.iterations).to(torch.int64) for i in inner_infos)
    return x, RefineInfo(
        refinements=len(inner_infos),
        inner_iterations=int(inner_total),
        converged=converged,
        rnorm_sq=rnorm_sq,
        rnorm_history=tuple(history),
        inner_infos=tuple(inner_infos),
    )
