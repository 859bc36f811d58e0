"""Lanczos eigensolver for SPD operators.  Counterpart of
``conjugategradient_tpu/solver/eigs.py``.

One reorthogonalized Lanczos pass on the device (``precond.lanczos_tridiag``:
the k steps, matvecs included, with no host read between them), then the
small tridiagonal's eigendecomposition on the host, Ritz vectors assembled
on the device, and the classical residual bound per pair.  The same pass
gives ``estimate_spectral_bounds`` its interval and ``expected_step_count``
its condition number.

Accepts everything ``as_linear_operator`` takes; a callable needs ``n=``
and puts its vectors on ``device`` (None: ``DEFAULT_DEVICE``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..types import as_linear_operator

#: Ritz pairs whose residual bound falls below this (relative to the
#: pair's |theta|) are flagged converged in :class:`EigsResult`.
DEFAULT_RTOL = 1e-6


class EigsResult(NamedTuple):
    """Ritz approximations to an SPD operator's eigenpairs.

    ``values`` are sorted per ``which`` (ascending for ``"smallest"``,
    descending for ``"largest"``); ``vectors`` is the matching ``(n, k)``
    column stack on the device, or None.  ``residuals`` is the bound
    ‖A uᵢ − θᵢ uᵢ‖ = β_m·|yᵢ[m−1]| from the recurrence; ``converged``
    marks pairs with residual ≤ rtol·|θᵢ|; ``iters`` is the Krylov
    dimension used (shorter than asked iff Lanczos found an invariant
    subspace, where every Ritz pair is exact).
    """

    values: np.ndarray
    vectors: Optional[torch.Tensor]
    residuals: np.ndarray
    converged: np.ndarray
    iters: int


def _lanczos_ritz(A: Any, iters: int, n: Optional[int], seed: int,
                  v0: Optional[torch.Tensor], device=None):
    """The shared Lanczos → tridiagonal → eigh pass: (op, V, vals, Y,
    betas, mm) with the device basis V (k, n), the full ascending Ritz
    spectrum (vals, Y) of the tridiagonal truncated at mm, and the βs."""
    from .precond import lanczos_tridiag

    op = as_linear_operator(A, n=n, device=device)
    m_rows = op.shape[0]
    m = int(min(iters, m_rows))
    if m < 1:
        raise ValueError(f"need iters >= 1, got {iters}")
    if v0 is None:
        v0 = torch.as_tensor(np.random.default_rng(seed).standard_normal(m_rows),
                             dtype=op.dtype, device=op.device)
    V, alphas, betas = lanczos_tridiag(op, v0, m)
    alphas = alphas.double().cpu().numpy()
    betas = betas.double().cpu().numpy()
    # truncate at the first breakdown: the Krylov space became invariant
    # and the Ritz pairs inside it are exact eigenpairs
    stop = np.flatnonzero(betas < 1e-12)
    mm = int(stop[0]) + 1 if len(stop) else m
    T = np.diag(alphas[:mm])
    if mm > 1:
        off = betas[: mm - 1]
        T = T + np.diag(off, 1) + np.diag(off, -1)
    vals, Y = np.linalg.eigh(T)
    return op, V, vals, Y, betas, mm


def lanczos_eigs(
    A: Any,
    k: int = 6,
    which: str = "smallest",
    iters: Optional[int] = None,
    n: Optional[int] = None,
    seed: int = 0,
    v0: Optional[torch.Tensor] = None,
    return_vectors: bool = True,
    rtol: float = DEFAULT_RTOL,
    *,
    device=None,
) -> EigsResult:
    """k extreme Ritz pairs of an SPD operator by reorthogonalized Lanczos.

    ``which``: ``"smallest"`` (values ascending) or ``"largest"``
    (descending).  ``iters`` (default ``max(2k, k+10)``, capped at n) is
    the Krylov dimension: that many matvecs with full reorthogonalization
    on the device, then an ``iters``-sized host eigh.  Ritz values lie
    inside the spectrum; :func:`precond.estimate_spectral_bounds` pads
    them for an enclosing interval.
    """
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be 'smallest' or 'largest', got {which!r}")
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    m_req = int(iters if iters is not None else max(2 * k, k + 10))
    if k > m_req:
        raise ValueError(f"need k <= iters, got k={k}, iters={m_req}")
    op, V, vals, Y, betas, mm = _lanczos_ritz(A, m_req, n, seed, v0, device)
    kk = min(k, mm)
    if which == "smallest":
        sel = np.arange(kk)
    else:
        sel = np.arange(len(vals) - 1, len(vals) - 1 - kk, -1)
    theta = vals[sel]
    # ‖A uᵢ − θᵢ uᵢ‖ = β_mm · |last component of yᵢ| (0 past a breakdown)
    beta_last = betas[mm - 1] if mm <= len(betas) else 0.0
    resid = np.abs(beta_last * Y[-1, sel])
    vectors = None
    if return_vectors:
        Yk = torch.as_tensor(Y[:, sel], dtype=V.dtype, device=V.device)
        vectors = (V[:mm].T @ Yk).to(op.dtype)
    return EigsResult(
        values=theta,
        vectors=vectors,
        residuals=resid,
        converged=resid <= rtol * np.maximum(np.abs(theta), 1e-300),
        iters=mm,
    )


def condition_estimate(
    A: Any,
    iters: int = 30,
    n: Optional[int] = None,
    seed: int = 0,
    v0: Optional[torch.Tensor] = None,
    *,
    device=None,
) -> float:
    """κ₂(A) = λ_max/λ_min of an SPD operator from one Lanczos pass: both
    extremes from the same tridiagonal.  A lower bound on the true κ₂ that
    rises to it as ``iters`` grows."""
    _, _, vals, _, _, _ = _lanczos_ritz(A, iters, n, seed, v0, device)
    lo = float(vals[0])
    if lo <= 0:
        raise ValueError(
            f"smallest Ritz value {lo} is not positive — the operator is "
            "not SPD (or iters is far too small for this spectrum)"
        )
    return float(vals[-1]) / lo
