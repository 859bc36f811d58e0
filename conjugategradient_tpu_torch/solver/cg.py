"""The CG driver on torch tensors.  Counterpart of
``conjugategradient_tpu/solver/cg.py``, with the same numerical semantics
(SURVEY.md §2.3):

* plain or preconditioned CG, recurrence residual, Hestenes–Stiefel α/β;
* x₀ defaults to 0; ``tol`` is ABSOLUTE on ‖r‖₂ and each iteration tests
  the PRE-update ρ_k (done ⇔ isnan(ρ_k) or √ρ_k ≤ tol), so convergence is
  seen one update late, as in the reference;
* at most N+1 iterations by default; a NaN residual ends the loop but is
  not convergence; ρ_k == 0 forces α = β = 0 so x survives a warm start at
  the solution;
* ``CGInfo.rho_history`` holds ‖r_k‖² per iteration, NaN past the end;
* ``recompute_r_every`` = N > 0: every N iterations a full restart replaces
  the recurrence residual with the true b − A·x and resets the direction
  (solver/restart.py), and ``rho_history[k]`` holds the true ‖r‖² there.

The loop stays on the device: k, done, ρ and the history are tensors, a
step after ``done`` (or at the iteration cap) is a masked no-op, and the
host follows the ``done`` flag through non-blocking copies, a few steps
behind the device (solver/restart.py), so the loop ends at most
``LOOKAHEAD - 1`` steps after convergence — the port of the JAX package's
single jitted ``lax.while_loop``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.blas import dot
from ..ops.spmv import full_precision_matmul
from ..types import LinearOperator, as_linear_operator
from ..utils.tracing import outermost
from .restart import run_chunked

FUSED_CHOICES = ("auto", "never", "always")


@dataclasses.dataclass(frozen=True)
class CGInfo:
    """Solve metadata; every field is a tensor on the solve's device."""

    iterations: torch.Tensor  # int32 — loop bodies executed
    converged: torch.Tensor  # bool — tolerance met (not the cap, not NaN)
    rho: torch.Tensor  # final r·z (== rnorm_sq unpreconditioned)
    rnorm_sq: torch.Tensor  # final ‖r‖²
    rho_history: torch.Tensor  # (maxiter+1,) ‖r_k‖², NaN past the end

    @property
    def residual_norms(self) -> torch.Tensor:
        """‖r_k‖ per iteration: the square root of ``rho_history``."""
        return torch.sqrt(self.rho_history)


@dataclasses.dataclass(frozen=True)
class CGState:
    """Explicit solver carry ``(x, r, p, rho, k)``; ``maxiter`` is
    ``hist.numel() - 1``."""

    k: torch.Tensor
    done: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor  # r·z (== r·r unpreconditioned)
    rnorm_sq: torch.Tensor  # r·r, the termination/history observable
    hist: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def cg_init(
    A: LinearOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    maxiter: int = 0,
) -> CGState:
    """r₀ = b − A·x₀, p₀ = z₀ = M⁻¹r₀."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - A.matvec(x0)
    z0 = r0 if M is None else M(r0)
    rnorm0 = dot(r0, r0)
    rho0 = rnorm0 if M is None else dot(r0, z0)
    hist = torch.full((maxiter + 1,), float("nan"), dtype=rnorm0.dtype,
                      device=b.device)
    hist[0] = rnorm0
    return CGState(
        k=torch.zeros((), dtype=torch.int32, device=b.device),
        done=torch.zeros((), dtype=torch.bool, device=b.device),
        x=x0, r=r0, p=z0, rho=rho0, rnorm_sq=rnorm0, hist=hist,
    )


def cg_step(
    A: LinearOperator,
    state: CGState,
    tol: torch.Tensor,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    dot_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = dot,
) -> CGState:
    """One CG iteration; a no-op once ``done`` is set or k reaches maxiter
    (the device-resident loop runs a few masked steps past the end).

    ``dot_fn`` computes the step's three dots (pᵀAp, ‖r‖², rᵀz), so a
    caller can put in a dot of its own, such as one that sums over shards."""
    live = state.live
    # a vector meets α or β in the scalars' dtype sdt and is rounded once to
    # its own dtype after, as JAX promotes a bf16 array against a float32
    # one (minres_step's rule); for float32 and float64 vectors .to(sdt) is
    # a no-op
    sdt = state.rho.dtype
    q = A.matvec(state.p)
    pap = dot_fn(state.p, q)
    exact = state.rho == 0
    alpha = torch.where(exact, 0, state.rho / torch.where(exact, 1, pap))
    p_s = state.p.to(sdt)
    x = torch.where(live, (state.x.to(sdt) + alpha * p_s).to(state.x.dtype), state.x)
    r = torch.where(live, (state.r.to(sdt) - alpha * q.to(sdt)).to(state.r.dtype), state.r)
    # termination tests the PRE-update residual (CG.hpp:401-402)
    done = torch.isnan(state.rnorm_sq) | (torch.sqrt(state.rnorm_sq) <= tol)
    z = r if M is None else M(r)
    rnorm_next = dot_fn(r, r)
    rho_next = rnorm_next if M is None else dot_fn(r, z)
    beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, state.rho))
    p = torch.where(live, (z.to(sdt) + beta * p_s).to(state.p.dtype), state.p)
    k = state.k + live.to(torch.int32)
    kk = k.long().reshape(1)  # tensor index: no host read
    hist = state.hist.index_put(
        (kk,), torch.where(live, rnorm_next, state.hist.gather(0, kk)[0]).reshape(1)
    )
    return CGState(
        k=k,
        done=torch.where(live, done, state.done),
        x=x, r=r, p=p,
        rho=torch.where(live, rho_next, state.rho),
        rnorm_sq=torch.where(live, rnorm_next, state.rnorm_sq),
        hist=hist,
    )


def cg_replace(
    A: LinearOperator,
    state: CGState,
    b: torch.Tensor,
    every: int,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> CGState:
    """The restart step (JAX ``solver/cg.py`` ``replace``): r ← b − A·x,
    p ← M⁻¹r, ρ and ‖r‖² from the true residual and ``hist[k]`` ← the true
    ‖r‖² — masked on the device to iterations k that are multiples of
    ``every`` of a solve that is not done (no ``k < maxiter`` term: a solve
    capped exactly on a boundary still reports its true residual)."""
    mask = (~state.done) & (state.k % every == 0)
    r_true = b - A.matvec(state.x)
    rnorm = dot(r_true, r_true)
    z = r_true if M is None else M(r_true)
    rho = rnorm if M is None else dot(r_true, z)
    kk = state.k.long().reshape(1)
    hist = state.hist.index_put(
        (kk,), torch.where(mask, rnorm, state.hist.gather(0, kk)[0]).reshape(1)
    )
    return CGState(
        k=state.k, done=state.done, x=state.x,
        r=torch.where(mask, r_true, state.r),
        p=torch.where(mask, z, state.p),
        rho=torch.where(mask, rho, state.rho),
        rnorm_sq=torch.where(mask, rnorm, state.rnorm_sq),
        hist=hist,
    )


@outermost("cg.solve")
def cg_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
    recompute_r_every: int = 0,
    fused: str = "auto",
) -> Tuple[torch.Tensor, CGInfo]:
    """Solve the SPD system ``A x = b`` with (preconditioned) CG.

    ``A``: an operator, a dense or sparse matrix, or an ``x -> A x``
    callable with ``n=`` (the system's dimension), as ``as_linear_operator``
    takes them.

    ``fused="auto"`` sends a blocked-ELL solve with float32 vectors (float32
    or bfloat16 tiles) whose tensors lie on a CUDA device to the two-kernel
    fused iteration (solver/fused.py),
    including Jacobi PCG when ``M`` comes from
    :func:`~.precond.jacobi_preconditioner`, and an unpreconditioned float32
    :class:`StencilOperator` solve on a CUDA device to the fused stencil
    iteration (solver/fused_stencil.py); ``"never"`` forces the portable
    loop; ``"always"`` requires a fused path and raises where none can run.
    ``recompute_r_every`` (residual replacement) works on all of them.
    """
    if fused not in FUSED_CHOICES:
        raise ValueError(f"fused must be one of {FUSED_CHOICES}, got {fused!r}")
    every = int(recompute_r_every)
    full_precision_matmul()
    op = as_linear_operator(A, device=b.device, n=n, dtype=b.dtype)
    N = op.shape[0]
    maxiter = N + 1 if maxiter is None else int(maxiter)

    from .fused import fused_bell_cg_solve, fused_bell_pcg_solve, fused_supported
    from .fused_stencil import fused_stencil_cg_solve, fused_stencil_supported

    inv_diag = getattr(M, "inv_diag", None)
    if fused != "never" and (M is None or inv_diag is not None):
        if fused_supported(op, dtype=b.dtype):
            if M is None:
                return fused_bell_cg_solve(op, b, x0, tol=tol, maxiter=maxiter,
                                           recompute_r_every=every)
            return fused_bell_pcg_solve(op, b, inv_diag, x0, tol=tol,
                                        maxiter=maxiter, recompute_r_every=every)
        # no fused stencil PCG: a preconditioned stencil runs the portable loop
        if M is None and fused_stencil_supported(op, dtype=b.dtype):
            return fused_stencil_cg_solve(op, b, x0, tol=tol, maxiter=maxiter,
                                          recompute_r_every=every)
    if fused == "always":
        raise ValueError(
            "fused='always' needs either a float32 or bfloat16 BlockedEllMatrix or "
            "SymBellMatrix on a CUDA device with square tiles of width "
            "32/64/128/256 and a square padded shape, float32 vectors, and no "
            "preconditioner or a jacobi_preconditioner; or a float32 "
            "StencilOperator on a CUDA device with float32 vectors and no "
            "preconditioner"
        )

    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    box = [cg_init(op, b, x0, M=M, maxiter=maxiter)]

    def step():
        box[0] = cg_step(op, box[0], tol_t, M=M)

    def replace():
        box[0] = cg_replace(op, box[0], b, every, M=M)

    run_chunked(step, lambda: box[0].live, maxiter, every, replace,
                done=lambda: box[0].done)
    s = box[0]
    info = CGInfo(
        iterations=s.k,
        converged=s.done & ~torch.isnan(s.rnorm_sq),
        rho=s.rho,
        rnorm_sq=s.rnorm_sq,
        rho_history=s.hist,
    )
    return s.x, info


def accuracy(A: Any, b: torch.Tensor, x: torch.Tensor,
             n: Optional[int] = None) -> torch.Tensor:
    """|Σ(b−Ax)² / Σx²| — the reference's ``accuracy()`` (a ratio of
    SQUARED norms, CG.hpp:463-515), printed by the tester as rel_error."""
    op = as_linear_operator(A, device=b.device, n=n, dtype=b.dtype)
    res = b - op.matvec(x)
    return torch.abs(dot(res, res) / dot(x, x))


def expected_step_count(
    A: Any,
    accuracy: float,
    n: Optional[int] = None,
    lanczos_iters: int = 30,
    seed: int = 0,
    device=None,
) -> int:
    """Predicted CG iteration count to reduce the A-norm error by
    ``accuracy``: κ from a short Lanczos run on the device
    (precond.estimate_spectral_bounds, unpadded), then the classic bound
    k = ⌈ln(2/ε) / ln((√κ+1)/(√κ−1))⌉.  ``n``: the dimension of a callable
    ``A``, whose vectors go to ``device`` (None: ``DEFAULT_DEVICE``)."""
    if not (0 < accuracy < 1):
        raise ValueError(f"accuracy must be in (0, 1), got {accuracy}")
    from .precond import estimate_spectral_bounds

    full_precision_matmul()
    # the raw Ritz interval: Chebyshev's padding would inflate kappa
    lam_min, lam_max = estimate_spectral_bounds(A, n=n, iters=lanczos_iters, seed=seed,
                                                safety=1.0, min_margin=1.0, device=device)
    kappa = max(lam_max / lam_min, 1.0)
    sk = math.sqrt(kappa)
    if sk <= 1.0 + 1e-12:
        return 1
    k = math.log(2.0 / accuracy) / math.log((sk + 1.0) / (sk - 1.0))
    return max(int(math.ceil(k)), 1)


def memory_footprint(n: int, nnz: int, dtype=torch.float32, index_bytes: int = 4) -> int:
    """The reference's analytic workspace estimate
    ``(2·NNZ + 4·N)·sizeof(DT) + 2·N·sizeof(int)`` (CG.hpp:555-558), kept
    for parity; an operator's own bytes are its ``memory_footprint()``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (2 * nnz + 4 * n) * itemsize + 2 * n * index_bytes
