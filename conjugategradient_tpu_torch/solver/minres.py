"""MINRES — minimal-residual solver for symmetric, possibly INDEFINITE
systems, on torch tensors.  Counterpart of
``conjugategradient_tpu/solver/minres.py``, with the same semantics:

* Paige–Saunders Lanczos + Givens recurrence; one operator apply and two
  reductions per iteration; ``(A − shift·I) x = b``, with ``shift`` in r₀
  and in every apply;
* the residual-norm estimate φ̄ (‖r‖₂, or ‖r‖_M = √(rᵀM r) with an SPD
  preconditioner ``M``) is tested against an ABSOLUTE ``tol``;
  ``done = isnan(φ̄) | isnan(β) | φ̄ ≤ tol | β == 0`` (β == 0: the Krylov
  space is exhausted and x is the exact minimizer);
* ``maxiter`` defaults to N; the first step has no v_{k−1} term; γ is
  clamped to the dtype's smallest normal number;
* ``MinresInfo.rnorm_history`` holds norms (not squares), NaN past the end;
  ``converged = done & ~nan``; ``rnorm_true`` is ‖b − (A − shift·I)x‖₂ from
  one extra apply at the exit (where φ̄ keeps shrinking on a singular
  inconsistent system, ``rnorm_true ≫ rnorm`` shows it).

The loop stays on the device as solver/cg.py's does: every scalar of the
recurrence is a 0-d tensor, a step on a state that is done (or at the cap)
is masked field by field, so its 0/0 never reaches the state, and the host
follows the ``done`` flag a few steps behind (solver/restart.py).
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
class MinresInfo:
    """Solve metadata, mirroring ``CGInfo``; every field is a tensor on the
    solve's device."""

    iterations: torch.Tensor  # int32 — loop bodies executed
    converged: torch.Tensor  # bool — tolerance met (not the cap, not NaN)
    rnorm: torch.Tensor  # final estimate φ̄ (‖r‖_M; ‖r‖₂ if M is None)
    rnorm_history: torch.Tensor  # (maxiter+1,) φ̄ per iteration, NaN-padded
    rnorm_true: torch.Tensor  # ‖b − (A − σI)x‖₂, recomputed once at exit

    @property
    def residual_norms(self) -> torch.Tensor:
        """Norm estimates (NOT squared, unlike ``CGInfo.rho_history``)."""
        return self.rnorm_history


@dataclasses.dataclass(frozen=True)
class MinresState:
    """Lanczos + Givens carry; scalars are 0-d tensors on the device."""

    k: torch.Tensor
    done: torch.Tensor
    nan: torch.Tensor  # breakdown flag (M not SPD, overflow)
    x: torch.Tensor
    r1: torch.Tensor  # Lanczos v_{k-1} scaled by its β (un-normalized)
    r2: torch.Tensor  # Lanczos v_k scaled
    y: torch.Tensor  # M r2
    oldb: torch.Tensor  # β_{k-1}
    beta: torch.Tensor  # β_k
    dbar: torch.Tensor
    epsln: torch.Tensor
    phibar: torch.Tensor  # residual-norm estimate
    cs: torch.Tensor
    sn: torch.Tensor
    w: torch.Tensor
    w2: torch.Tensor
    hist: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def minres_init(op: LinearOperator, b: torch.Tensor, x0: Optional[torch.Tensor],
                tol: torch.Tensor, shift: torch.Tensor, maxiter: int,
                M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> MinresState:
    """The initial carry: r₁ = b − (A − σI)x₀, β₁ = √(r₁ᵀ M r₁) (NaN when
    M is not SPD on r₁: a clean breakdown exit before the first step)."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    r1 = (b - op.matvec(x0) + shift * x0).to(b.dtype)
    y0 = r1 if M is None else M(r1)
    beta1 = torch.sqrt(dot(r1, y0))
    sdt = beta1.dtype
    dev = b.device
    hist = torch.full((maxiter + 1,), float("nan"), dtype=sdt, device=dev)
    hist[0] = beta1
    zero = torch.zeros((), dtype=sdt, device=dev)
    nan = torch.isnan(beta1)
    return MinresState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        done=nan | (beta1 <= tol), nan=nan,
        x=x0, r1=r1, r2=r1, y=y0.to(b.dtype),
        oldb=zero, beta=beta1, dbar=zero, epsln=zero, phibar=beta1,
        cs=-torch.ones((), dtype=sdt, device=dev), sn=zero,
        w=torch.zeros_like(b), w2=torch.zeros_like(b), hist=hist,
    )


def minres_step(op: LinearOperator, s: MinresState, tol: torch.Tensor,
                shift: torch.Tensor,
                M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> MinresState:
    """One MINRES iteration; a no-op once ``done`` is set or k reaches
    maxiter (β may be 0 or NaN there: every field is masked, so the
    division by it never reaches the state)."""
    live = s.live
    dt = s.y.dtype
    # a vector meets a scalar of the recurrence in the scalars' dtype sdt,
    # rounded once to the vectors' dtype after, as JAX promotes a bf16
    # array against a float32 one (torch would round the 0-d scalar to
    # bf16 first); for float32 and float64 vectors .to(sdt) is a no-op
    sdt = s.phibar.dtype
    # Lanczos step: v_{k+1} from (r1, r2, y)
    v = (s.y.to(sdt) / s.beta).to(dt)
    y = (op.matvec(v) - shift * v).to(dt)
    noprev = s.oldb == 0  # the first step has no v_{k-1} term
    c1 = torch.where(noprev, 0, s.beta / torch.where(noprev, 1, s.oldb))
    # y − (c1·r1 rounded to dt) stays in sdt, unrounded: XLA:CPU compiles
    # the JAX step so (its default excess precision drops that bf16 round
    # trip from the optimised HLO), and α and the next y read the sdt value
    y = y.to(sdt) - (c1 * s.r1.to(sdt)).to(dt).to(sdt)
    alfa = dot(v, y)
    y = (y - (alfa / s.beta) * s.r2.to(sdt)).to(dt)
    r2 = y
    y_next = r2 if M is None else M(r2).to(dt)
    beta = torch.sqrt(dot(r2, y_next))  # NaN iff M is not SPD

    # Givens QR of the tridiagonal
    delta = s.cs * s.dbar + s.sn * alfa
    gbar = s.sn * s.dbar - s.cs * alfa
    epsln = s.sn * beta
    dbar = -s.cs * beta
    tiny = torch.finfo(s.phibar.dtype).tiny
    gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta * beta), tiny)
    cs = gbar / gamma
    sn = beta / gamma
    phi = cs * s.phibar
    phibar = sn * s.phibar

    # solution update
    w = ((v.to(sdt) - s.epsln * s.w2.to(sdt) - delta * s.w.to(sdt)) / gamma).to(s.w.dtype)
    x = (s.x.to(sdt) + phi * w.to(sdt)).to(s.x.dtype)

    is_nan = torch.isnan(phibar) | torch.isnan(beta)
    done = is_nan | (phibar <= tol) | (beta == 0)
    k = s.k + live.to(torch.int32)
    kk = k.long().reshape(1)  # tensor index: no host read
    hist = s.hist.index_put(
        (kk,), torch.where(live, phibar, s.hist.gather(0, kk)[0]).reshape(1))

    def keep(new, old):
        return torch.where(live, new, old)

    return MinresState(
        k=k, done=keep(done, s.done), nan=keep(is_nan, s.nan),
        x=keep(x, s.x), r1=keep(s.r2, s.r1), r2=keep(r2, s.r2),
        y=keep(y_next, s.y), oldb=keep(s.beta, s.oldb), beta=keep(beta, s.beta),
        dbar=keep(dbar, s.dbar), epsln=keep(epsln, s.epsln),
        phibar=keep(phibar, s.phibar), cs=keep(cs, s.cs), sn=keep(sn, s.sn),
        w=keep(w, s.w), w2=keep(s.w, s.w2), hist=hist,
    )


def minres_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    shift: float = 0.0,
    n: Optional[int] = None,
    fused: str = "auto",
) -> Tuple[torch.Tensor, MinresInfo]:
    """Solve the symmetric system ``(A − shift·I) x = b``; A need not be
    definite.  Same surface as :func:`~.cg.cg_solve`.

    ``tol``: absolute, on the estimate φ̄ (0 runs to the cap).  ``maxiter``:
    defaults to N.  ``M``: an SPD preconditioner apply; an indefinite one
    breaks the Lanczos inner product, which shows as NaN and
    ``converged=False``.  ``n``: the dimension, for a callable ``A``.

    ``fused="auto"`` sends a float32 solve on a blocked-ELL operator (full
    or symmetric storage, float32 or bfloat16 tiles) whose tensors lie on a
    CUDA device, with no preconditioner or a
    :func:`~.precond.jacobi_preconditioner`, to the two-kernel fused
    iteration (solver/fused_minres.py); everything else, and all float64,
    runs the portable loop here.  ``"never"`` forces the
    portable loop; ``"always"`` raises where the fused path cannot run.
    """
    if fused not in FUSED_CHOICES:
        raise ValueError(f"fused must be one of {FUSED_CHOICES}, got {fused!r}")
    full_precision_matmul()
    op = as_linear_operator(A, device=b.device, n=n, dtype=b.dtype)
    maxiter = op.shape[0] if maxiter is None else int(maxiter)

    inv_diag = getattr(M, "inv_diag", None)
    if fused != "never":
        from .fused_minres import fused_minres_solve, fused_minres_supported

        if (M is None or inv_diag is not None) and fused_minres_supported(op, dtype=b.dtype):
            return fused_minres_solve(op, b, x0, tol=tol, maxiter=maxiter,
                                      shift=shift, inv_diag=inv_diag)
        if fused == "always":
            raise ValueError(
                "fused='always' needs a float32 or bfloat16 BlockedEllMatrix or "
                "SymBellMatrix on a CUDA device with square tiles of width "
                "32/64/128/256 and a square padded shape, float32 vectors, and "
                "no preconditioner or a jacobi_preconditioner")

    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    shift_t = torch.as_tensor(shift, dtype=b.dtype, device=b.device)
    box = [minres_init(op, b, x0, tol_t, shift_t, maxiter, M)]

    def step():
        box[0] = minres_step(op, box[0], tol_t, shift_t, M)

    run_chunked(step, lambda: box[0].live, maxiter, done=lambda: box[0].done)
    s = box[0]
    r_true = b - op.matvec(s.x) + shift_t * s.x
    info = MinresInfo(
        iterations=s.k,
        converged=s.done & ~s.nan,
        rnorm=s.phibar,
        rnorm_history=s.hist,
        rnorm_true=torch.sqrt(dot(r_true, r_true)),
    )
    return s.x, info
