"""BiCGStab — stabilized bi-conjugate gradients for NONSYMMETRIC systems,
on torch tensors.  Counterpart of ``conjugategradient_tpu/solver/bicgstab.py``,
with the same semantics (van der Vorst 1992):

* both half-steps run in one loop body: 2 operator applies, 2
  preconditioner applies and 6 reductions per iteration; r̂₀ = r₀;
* ``tol`` is ABSOLUTE on the recurrence ‖r‖₂ and is tested after each
  half-step too: when ‖s‖ ≤ tol the iteration ends with x + α·p̂ and s
  (the half-step exit), ‖s‖ as ``rnorm``;
* ``maxiter`` defaults to N (BiCGStab has no N-step termination);
* breakdowns (ρ → 0, r̂ᵀv → 0, tᵀt → 0, overflow) show as a non-finite
  scalar, or ω == 0 or ρ == 0 on a step that did not converge; they end the
  solve with ``breakdown=True`` and the last FINITE iterate, kept through
  masked selects;
* ``BicgstabInfo.rnorm_history`` holds norms (not squares), NaN past the
  end; ``rnorm_true`` is ‖b − A x‖₂ from one extra apply at the exit.

The loop stays on the device as solver/cg.py's does: a step on a state that
is done (or at the cap) is masked field by field, and the host follows the
``done`` flag a few steps behind (solver/restart.py).  It runs on every
operator ``as_linear_operator`` takes; on a CUDA device the blocked-ELL,
DIA and stencil applies are the hand-written kernels.  The three-kernel
fused iteration on full blocked-ELL (solver/fused_bicgstab.py) is reached
with ``fused="always"`` only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.blas import dot
from ..ops.spmv import full_precision_matmul
from ..types import LinearOperator, as_linear_operator
from .cg import FUSED_CHOICES
from .restart import run_chunked


@dataclasses.dataclass(frozen=True)
class BicgstabInfo:
    """Solve metadata, mirroring ``CGInfo``/``MinresInfo``; every field is
    a tensor on the solve's device."""

    iterations: torch.Tensor  # int32 — full BiCGStab steps executed
    converged: torch.Tensor  # bool — tolerance met (not the cap, not a breakdown)
    breakdown: torch.Tensor  # bool — a ρ/ω/NaN breakdown ended the solve
    rnorm: torch.Tensor  # final ‖r‖₂ (‖s‖₂ at a half-step exit)
    rnorm_history: torch.Tensor  # (maxiter+1,) ‖r‖₂ per iteration, NaN-padded
    rnorm_true: torch.Tensor  # ‖b − A x‖₂, recomputed once at exit

    @property
    def residual_norms(self) -> torch.Tensor:
        """Norms (NOT squared, like MinresInfo, unlike CGInfo.rho_history)."""
        return self.rnorm_history


@dataclasses.dataclass(frozen=True)
class BicgstabState:
    """BiCGStab carry; scalars are 0-d tensors on the device."""

    k: torch.Tensor
    done: torch.Tensor
    broke: torch.Tensor  # breakdown flag
    x: torch.Tensor
    r: torch.Tensor
    rhat: torch.Tensor  # fixed shadow residual r̂₀
    p: torch.Tensor
    v: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    rnorm: torch.Tensor
    hist: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def bicgstab_init(op: LinearOperator, b: torch.Tensor, x0: Optional[torch.Tensor],
                  tol: torch.Tensor, maxiter: int,
                  M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> BicgstabState:
    """The initial carry: r₀ = b − A x₀, r̂₀ = r₀, ρ = α = ω = 1; done at
    once when ‖r₀‖ is NaN or within ``tol``."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = (b - op.matvec(x0)).to(b.dtype)
    rnorm0 = torch.sqrt(dot(r0, r0))
    sdt = rnorm0.dtype  # the widened scalar dtype (>= float32)
    dev = b.device
    hist = torch.full((maxiter + 1,), float("nan"), dtype=sdt, device=dev)
    hist[0] = rnorm0
    one = torch.ones((), dtype=sdt, device=dev)
    nan = torch.isnan(rnorm0)
    return BicgstabState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        done=nan | (rnorm0 <= tol), broke=nan,
        x=x0, r=r0, rhat=r0, p=torch.zeros_like(b), v=torch.zeros_like(b),
        rho=one, alpha=one, omega=one, rnorm=rnorm0, hist=hist,
    )


def bicgstab_step(op: LinearOperator, s: BicgstabState, tol: torch.Tensor,
                  M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> BicgstabState:
    """One full BiCGStab iteration (both half-steps), with the half-step
    exit folded in as a select; a no-op once ``done`` is set or k reaches
    maxiter (every field is masked, so the divisions of a finished state
    never reach it)."""
    live = s.live
    apply_m = (lambda t: t) if M is None else M
    dt, xdt = s.r.dtype, s.x.dtype
    # a vector meets a scalar of the recurrence in the scalars' dtype sdt,
    # rounded once to the vectors' dtype after, as JAX promotes a bf16
    # array against a float32 one (minres_step's rule); for float32 and
    # float64 vectors .to(sdt) is a no-op
    sdt = s.rnorm.dtype

    rho = dot(s.rhat, s.r)
    beta = (rho / s.rho) * (s.alpha / s.omega)
    p = (s.r.to(sdt) + beta * (s.p.to(sdt) - s.omega * s.v.to(sdt))).to(dt)
    phat = apply_m(p).to(dt)
    v = op.matvec(phat).to(dt)
    alpha = rho / dot(s.rhat, v)
    sv = (s.r.to(sdt) - alpha * v.to(sdt)).to(dt)  # the half-step residual "s"
    snorm = torch.sqrt(dot(sv, sv))
    x_half = (s.x.to(sdt) + alpha * phat.to(sdt)).to(xdt)
    half_done = snorm <= tol

    shat = apply_m(sv).to(dt)
    t = op.matvec(shat).to(dt)
    omega = dot(t, sv) / dot(t, t)
    x_full = (x_half.to(sdt) + omega * shat.to(sdt)).to(xdt)
    r_full = (sv.to(sdt) - omega * t.to(sdt)).to(dt)
    rnorm_full = torch.sqrt(dot(r_full, r_full))

    # every division above is non-finite exactly when its textbook breakdown
    # holds (ρ → 0, r̂ᵀv → 0, tᵀt → 0), so one finiteness test catches them
    finite = (torch.isfinite(beta) & torch.isfinite(alpha) & torch.isfinite(omega)
              & torch.isfinite(rnorm_full))
    converged_now = half_done | (finite & (rnorm_full <= tol))
    # ρ == 0 with r ≠ 0 is the hard Lanczos breakdown; ω == 0 cannot advance
    # the next iteration (β divides by it)
    broke = (~finite & ~half_done) | (
        finite & ((omega == 0) | (rho == 0)) & ~converged_now)
    rnorm_new = torch.where(half_done, snorm, rnorm_full)

    # on a breakdown keep the last finite iterate; on a half-step exit x_half/s
    keep_old = broke | ~live
    hold = broke | half_done | ~live
    k = s.k + live.to(torch.int32)
    kk = k.long().reshape(1)  # tensor index: no host read
    rnorm = torch.where(keep_old, s.rnorm, rnorm_new)
    hist = s.hist.index_put(
        (kk,), torch.where(live, rnorm, s.hist.gather(0, kk)[0]).reshape(1))

    def keep(new, old):
        return torch.where(keep_old, old, new)

    return BicgstabState(
        k=k,
        done=torch.where(live, converged_now | broke, s.done),
        broke=torch.where(live, broke, s.broke),
        x=keep(torch.where(half_done, x_half, x_full), s.x),
        r=keep(torch.where(half_done, sv, r_full), s.r),
        rhat=s.rhat,
        p=torch.where(hold, s.p, p), v=torch.where(hold, s.v, v),
        rho=keep(rho, s.rho), alpha=keep(alpha, s.alpha), omega=keep(omega, s.omega),
        rnorm=rnorm, hist=hist,
    )


def bicgstab_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
    fused: str = "auto",
) -> Tuple[torch.Tensor, BicgstabInfo]:
    """Solve the (possibly NONSYMMETRIC) system ``A x = b`` with BiCGStab.
    Same surface as :func:`~.cg.cg_solve`.

    ``tol``: absolute, on the recurrence ‖r‖₂ (0 runs to the cap).
    ``maxiter``: full iterations (2 applies each); defaults to N.  ``M``: a
    preconditioner apply ``r -> M⁻¹ r`` (two per iteration; it need not be
    SPD).  ``n``: the dimension, for a callable ``A``.

    ``fused``: ``"auto"`` and ``"never"`` run the portable loop here, as in
    the JAX package; ``"always"`` runs the three-kernel fused iteration
    (solver/fused_bicgstab.py: a float32 or bfloat16 full blocked-ELL
    operator on a CUDA device, float32 vectors, no preconditioner or a
    :func:`~.precond.jacobi_preconditioner`) and raises where it cannot.
    """
    if fused not in FUSED_CHOICES:
        raise ValueError(f"fused must be one of {FUSED_CHOICES}, got {fused!r}")
    full_precision_matmul()
    op = as_linear_operator(A, device=b.device, n=n, dtype=b.dtype)
    maxiter = op.shape[0] if maxiter is None else int(maxiter)

    if fused == "always":
        inv_diag = getattr(M, "inv_diag", None)
        if M is not None and inv_diag is None:
            raise ValueError(
                "fused='always' supports only unpreconditioned or Jacobi "
                "(jacobi_preconditioner) BiCGStab solves")
        from .fused_bicgstab import fused_bicgstab_solve, fused_bicgstab_supported

        if not fused_bicgstab_supported(op, dtype=b.dtype):
            raise ValueError(
                "fused='always' needs a float32 or bfloat16 full blocked-ELL operator "
                "(BlockedEllMatrix) on a CUDA device with square tiles of width "
                "32/64/128/256 and a square padded shape, and float32 vectors "
                "(solver/fused_bicgstab.py)")
        return fused_bicgstab_solve(op, b, x0, tol=tol, maxiter=maxiter, inv_diag=inv_diag)

    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    box = [bicgstab_init(op, b, x0, tol_t, maxiter, M)]

    def step():
        box[0] = bicgstab_step(op, box[0], tol_t, M)

    run_chunked(step, lambda: box[0].live, maxiter, done=lambda: box[0].done)
    s = box[0]
    r_true = b - op.matvec(s.x)
    info = BicgstabInfo(
        iterations=s.k,
        converged=s.done & ~s.broke,
        breakdown=s.broke,
        rnorm=s.rnorm,
        rnorm_history=s.hist,
        rnorm_true=torch.sqrt(dot(r_true, r_true)),
    )
    return s.x, info
