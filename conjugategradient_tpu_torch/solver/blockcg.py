"""Block CG: one Krylov space shared across right-hand sides.  Counterpart
of ``conjugategradient_tpu/solver/blockcg.py`` (O'Leary 1980).

The lockstep loop (solver/batched.py) reads the operator once for R
independent solves; block CG lets the R lanes share one block-Krylov
space, so each lane converges in fewer iterations than its solo solve.
Recurrences (preconditioned, M SPD; unpreconditioned Z = R):

    Q      = A P                                (one multi-RHS SpMV)
    alpha  = (P^T Q)^+ rho          (R x R)     X  += P alpha
                                                R  -= Q alpha
    Z      = M^-1 R
    rho'   = R^T Z                  (R x R)
    beta   = rho^+ rho'             (R x R)     P   = Z + P beta

The R x R solves are a symmetric-eigendecomposition pseudo-inverse with a
relative cutoff (``rcond``), on the device: a converged lane or two
dependent right-hand sides make the Gram matrices singular, and the
cutoff zeroes the dead directions.  Products run in full float32 or
float64 (``full_precision_matmul``, as the JAX package asks for
``Precision.HIGHEST``).  ``torch.linalg.eigh`` checks its result on the
host, so each block iteration reads the device twice (the two eighs);
the iteration's other work is queued.

Termination mirrors the lockstep loop's per-lane semantics (pre-update
test on ‖r_k‖, NaN exit): a lane's ``iterations`` counts the block
iterations it was unconverged for.  Converged lanes keep riding the
shared space; only their counters freeze.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.spmv import full_precision_matmul
from ..types import as_linear_operator
from .batched import _LOCKSTEP_TYPES, _check_block, _columns, _lane_index, _lane_tol, _lockstep_ops
from .cg import CGInfo
from .restart import run_chunked


def default_gram_rcond(dtype) -> float:
    """The dtype-adaptive Gram pseudo-inverse cutoff: 1e-10 in float64,
    1e-4 in float32 and below (tighter cutoffs stall or diverge on the
    float32 Gram matrices' rounding)."""
    return 1e-10 if torch.promote_types(dtype, torch.float32) == torch.float64 else 1e-4


def _spd_pinv_apply(W: torch.Tensor, Y: torch.Tensor, rcond: float) -> torch.Tensor:
    """W⁺ Y for a (near-)SPD R x R Gram matrix through eigh with a relative
    eigenvalue cutoff: zero (not infinite) response along dead directions."""
    dt = torch.promote_types(W.dtype, torch.float32)  # eigh needs >= float32
    Wp = (0.5 * (W + W.T)).to(dt)  # Gram matrices are symmetric up to rounding
    w, V = torch.linalg.eigh(Wp)
    wmax = torch.max(torch.abs(w))
    keep = w > rcond * torch.clamp_min(wmax, torch.finfo(dt).tiny)
    inv = torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)
    return (V @ (inv[:, None] * (V.T @ Y.to(dt)))).to(Y.dtype)


@dataclasses.dataclass(frozen=True)
class BlockCGState:
    """The block loop's carry: (N, R) column blocks, the (R, R) Gram ρ."""

    k: torch.Tensor  # (R,) per-lane iteration counters (frozen at convergence)
    done: torch.Tensor  # (R,) bool
    X: torch.Tensor  # (N, R)
    r: torch.Tensor  # (N, R)
    p: torch.Tensor  # (N, R)
    rho: torch.Tensor  # (R, R) Rᵀ Z
    rnorm: torch.Tensor  # (R,) per-lane ‖r‖²
    hist: torch.Tensor  # (maxiter+1, R)

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.shape[0] - 1)


def _block_ops(op, M):
    """(matvec_multi, precond, with_m): the lockstep loop's multi-RHS SpMV
    where the layout has one, else the operator column by column."""
    if isinstance(op, _LOCKSTEP_TYPES):
        return _lockstep_ops(op, M)
    precond = (lambda Rv: Rv) if M is None else _columns(M)
    return _columns(op.matvec), precond, M is not None


def _block_init(matvec_multi, precond, with_m, Bt, X0t, maxiter) -> BlockCGState:
    r0 = Bt - matvec_multi(X0t)
    z0 = precond(r0)
    rnorm0 = torch.sum(r0 * r0, dim=0)
    rho0 = r0.T @ (z0 if with_m else r0)
    R = Bt.shape[1]
    hist = torch.full((maxiter + 1, R), float("nan"), dtype=rnorm0.dtype, device=Bt.device)
    hist[0] = rnorm0
    return BlockCGState(
        k=torch.zeros(R, dtype=torch.int32, device=Bt.device),
        done=torch.zeros(R, dtype=torch.bool, device=Bt.device),
        X=X0t, r=r0, p=z0, rho=rho0, rnorm=rnorm0, hist=hist,
    )


def _block_step(matvec_multi, precond, with_m, s: BlockCGState, tol, maxiter: int,
                rcond: float) -> BlockCGState:
    """One block iteration; writes ``s.hist`` in place.  Every lane's
    vectors move while any lane is live (the shared space); once none is,
    the step is a no-op, as the JAX loop runs no further step."""
    active = (~s.done) & (s.k < maxiter)
    go = active.any()
    Q = matvec_multi(s.p)
    alpha = _spd_pinv_apply(s.p.T @ Q, s.rho, rcond)  # (R, R)
    X = s.X + s.p @ alpha
    Rv = s.r - Q @ alpha
    # pre-update termination per lane (cg_step's semantics)
    done_new = torch.isnan(s.rnorm) | (torch.sqrt(s.rnorm) <= tol)
    Z = precond(Rv)
    rnorm_next = torch.sum(Rv * Rv, dim=0)
    rho_next = Rv.T @ (Z if with_m else Rv)
    beta = _spd_pinv_apply(s.rho, rho_next, rcond)  # (R, R)
    P = Z + s.p @ beta
    k = torch.where(active, s.k + 1, s.k)
    idx = _lane_index(k)
    s.hist.index_put_(idx, torch.where(active, rnorm_next, s.hist[idx]))
    return BlockCGState(
        k=k, done=torch.where(active, done_new, s.done),
        X=torch.where(go, X, s.X), r=torch.where(go, Rv, s.r), p=torch.where(go, P, s.p),
        rho=torch.where(go, rho_next, s.rho), rnorm=torch.where(go, rnorm_next, s.rnorm),
        hist=s.hist,
    )


def _block_replace(matvec_multi, precond, with_m, Bt, s: BlockCGState,
                   every: int) -> BlockCGState:
    """Residual-replacement full restart (r and p) of the whole block, at
    block iterations that are multiples of ``every`` while a lane is live:
    the shared space restarts as one (lanes never freeze mid-space)."""
    active = ~s.done
    fire = active.any() & (torch.max(torch.where(active, s.k, 0)) % every == 0)
    Rt = Bt - matvec_multi(s.X)
    Zt = precond(Rt)
    rnorm_t = torch.sum(Rt * Rt, dim=0)
    rho_t = Rt.T @ (Zt if with_m else Rt)
    idx = _lane_index(s.k)
    s.hist.index_put_(idx, torch.where(fire & active, rnorm_t, s.hist[idx]))
    return BlockCGState(
        k=s.k, done=s.done, X=s.X,
        r=torch.where(fire, Rt, s.r), p=torch.where(fire, Zt, s.p),
        rho=torch.where(fire, rho_t, s.rho), rnorm=torch.where(fire, rnorm_t, s.rnorm),
        hist=s.hist,
    )


def block_cg_solve(
    A: Any,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    tol=0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
    rcond: Optional[float] = None,
    recompute_r_every: int = 0,
) -> Tuple[torch.Tensor, CGInfo]:
    """Solve ``A X[i] = B[i]`` for every row of ``B`` in one shared
    block-Krylov space.

    ``A``: the shared SPD operator.  ``B``: (nrhs, N); dependent lanes are
    harmless (the cutoff retires their directions).  ``X0``: optional
    (nrhs, N).  ``tol``: ABSOLUTE on each lane's ‖r‖₂, scalar or (nrhs,).
    ``M``: an SPD preconditioner apply, per vector.  ``rcond``: the
    relative eigenvalue cutoff of the R x R solves (None:
    :func:`default_gram_rcond`).  ``recompute_r_every`` > 0: a
    residual-replacement full restart every that many block iterations
    (recommended in float32, whose recurrence drifts faster here than in
    scalar CG).  ``maxiter`` defaults to N + 1.

    Returns (X (nrhs, N), CGInfo with a leading nrhs axis); a lane's
    ``iterations`` counts the block iterations it was unconverged for.
    """
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=B.dtype, device=B.device)
    _check_block(B)
    tol_t = _lane_tol(tol, B)
    if X0 is None:
        X0 = torch.zeros_like(B)
    if rcond is None:
        rcond = default_gram_rcond(B.dtype)
    rcond = float(rcond)
    every = int(recompute_r_every)
    mi = int(op.shape[0] + 1 if maxiter is None else maxiter)
    ops = _block_ops(op, M)
    Bt = B.T
    box = [_block_init(*ops, Bt, X0.T, mi)]

    def step():
        box[0] = _block_step(*ops, box[0], tol_t, mi, rcond)

    def replace():
        box[0] = _block_replace(*ops, Bt, box[0], every)

    def live():
        return box[0].live.any()

    run_chunked(step, live, mi, every, replace, done=lambda: ~live())
    s = box[0]
    info = CGInfo(
        iterations=s.k,
        converged=s.done & ~torch.isnan(s.rnorm),
        rho=torch.diagonal(s.rho),
        rnorm_sq=s.rnorm,
        rho_history=s.hist.T,  # (R, maxiter+1), the lockstep layout
    )
    return s.X.T, info
