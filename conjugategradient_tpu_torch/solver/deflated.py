"""Deflated and recycling CG — spectral deflation for sequences of solves.
Counterpart of ``conjugategradient_tpu/solver/deflated.py``.

With a basis ``W`` spanning approximations of A's k lowest eigenmodes,
every search direction is kept A-orthogonal to ``W`` through the projector

    Pᵀ z = z − W E⁻¹ (AW)ᵀ z,        E = Wᵀ A W  (k×k, Cholesky-factored)

so CG runs at condition λ_max/λ_{k+1} instead of λ_max/λ_1 (Saad, Yeung,
Erhel & Guyomarc'h, SIAM J. Sci. Comput. 21(5), 2000).  A step adds one
(n, k)ᵀ(n,) product, one k×k Cholesky solve and one (n, k)(k,) product to
the SpMV (full-precision float32 products: TF32 is off).

The basis comes from :func:`make_deflation_basis` (a Lanczos pass, or
LOBPCG with a preconditioner, keeping the k lowest Ritz vectors), from
:func:`harvest_deflation_basis` (the Lanczos process that m plain CG
iterations on a right-hand side induce), or from any (n, k) block through
:func:`deflation_basis_from_vectors`.

Semantics: :func:`~.cg.cg_solve`'s loop (recurrence residual,
Hestenes–Stiefel α/β, the tolerance tested on the pre-update ‖r_k‖², the
N+1 cap, the NaN exit, the ρ == 0 guard) with the projector applied to the
preconditioned residual in the direction update, the initial guess
Galerkin-corrected so that Wᵀr₀ = 0, a divergence guard and the best
iterate returned (:func:`deflated_cg_solve`).  E is factored with
``torch.linalg.cholesky_ex``: an A-degenerate W gives a NaN factor, and the
solve then takes its NaN exit, as in the JAX package, instead of raising
when the basis is built.  The loops are masked steps driven by
``restart.run_chunked``; the harvest's tridiagonal is read and solved on the
host once, after its m steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.spmv import full_precision_matmul
from ..types import as_linear_operator
from .batched import _columns
from .cg import CGInfo
from .restart import run_chunked


@dataclasses.dataclass(frozen=True)
class DeflationBasis:
    """Precomputed deflation data: the basis, its image, and chol(WᵀAW).

    Build once per operator (:func:`make_deflation_basis`,
    :func:`deflation_basis_from_vectors`) and reuse it across every
    :func:`deflated_cg_solve` against the same A.
    """

    W: torch.Tensor  # (n, k)
    AW: torch.Tensor  # (n, k)
    E_chol: torch.Tensor  # (k, k) lower Cholesky factor of WᵀAW

    @property
    def k(self) -> int:
        return int(self.W.shape[1])


def _solve_E(basis: DeflationBasis, y: torch.Tensor) -> torch.Tensor:
    """E⁻¹ y through the precomputed Cholesky factor (k×k)."""
    return torch.cholesky_solve(y[:, None], basis.E_chol, upper=False)[:, 0]


def _project(basis: DeflationBasis, z: torch.Tensor) -> torch.Tensor:
    """Pᵀ z = z − W E⁻¹ (AW)ᵀ z, the projector A-orthogonal to W."""
    mu = _solve_E(basis, basis.AW.T @ z)
    return z - basis.W @ mu


def deflation_basis_from_vectors(A: Any, W: torch.Tensor,
                                 n: Optional[int] = None) -> DeflationBasis:
    """A :class:`DeflationBasis` from any full-rank (n, k) block.

    AW is computed column by column through the operator's own matvec and
    E = WᵀAW factored by Cholesky; an A-degenerate W gives a NaN factor
    (and NaN at solve time), not an error — orthonormalize first if unsure.
    ``A``: an operator, or what ``as_linear_operator`` takes (W's device
    and dtype).
    """
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=W.dtype, device=W.device)
    AW = _columns(op.matvec)(W)
    E = W.T @ AW
    L, info = torch.linalg.cholesky_ex(0.5 * (E + E.T))
    # the JAX Cholesky of a matrix that is not positive definite: NaN in
    # the lower triangle
    E_chol = torch.where(info != 0, torch.tril(torch.full_like(L, float("nan"))), L)
    return DeflationBasis(W=W, AW=AW, E_chol=E_chol)


def make_deflation_basis(
    A: Any,
    k: int = 8,
    lanczos_iters: Optional[int] = None,
    n: Optional[int] = None,
    seed: int = 0,
    v0: Optional[torch.Tensor] = None,
    method: str = "lanczos",
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    maxiter: Optional[int] = None,
    *,
    device=None,
) -> DeflationBasis:
    """The k LOWEST Ritz vectors of A as a deflation basis.

    ``method="lanczos"`` (default): ``lanczos_iters`` (default
    ``max(2k, k+10)``) reorthogonalized Lanczos steps on the device
    (:func:`~.eigs.lanczos_eigs`), the k smallest Ritz vectors kept.
    ``method="lobpcg"``: :func:`~.lobpcg.lobpcg_eigs` instead, with any of
    the package's preconditioners as ``M``, so the basis converges at
    M⁻¹A's rate; ``maxiter`` caps its iterations (default 50).  There a
    ``v0`` is the first column of the starting block, whose other columns
    are the second (n, k) block drawn from ``np.random.default_rng(seed)``
    (LOBPCG draws its initial directions from the first); the JAX package
    draws that block with ``jax.random``, so the two packages start from
    different blocks.  ``device``: where a callable ``A``'s vectors go.
    """
    op = as_linear_operator(A, n=n, device=device)
    m_rows = op.shape[0]
    if method == "lobpcg":
        from .lobpcg import lobpcg_eigs

        if lanczos_iters is not None:
            raise ValueError(
                "lanczos_iters applies to method='lanczos'; cap the LOBPCG "
                "iterations with maxiter= instead")
        X0 = None
        if v0 is not None:
            # the caller's direction (a prior solve's residual, typically)
            # and a random complement
            v0 = torch.as_tensor(v0, device=op.device)
            block = np.random.default_rng(seed).standard_normal((2, m_rows, k))[1]
            X0 = torch.as_tensor(block, dtype=v0.dtype, device=op.device)
            X0[:, 0] = v0
        res = lobpcg_eigs(op, k=k, M=M, which="smallest", X0=X0,
                          maxiter=50 if maxiter is None else int(maxiter), seed=seed)
        return deflation_basis_from_vectors(op, res.vectors)
    if method != "lanczos":
        raise ValueError(f"method must be 'lanczos' or 'lobpcg', got {method!r}")
    if M is not None:
        raise ValueError(
            "M (preconditioned harvesting) requires method='lobpcg' — "
            "the Lanczos pass is unpreconditioned")
    from .eigs import lanczos_eigs

    m = int(min(lanczos_iters if lanczos_iters is not None else max(2 * k, k + 10), m_rows))
    if not 0 < k <= m:
        raise ValueError(f"need 0 < k <= lanczos_iters, got k={k}, m={m}")
    res = lanczos_eigs(op, k=k, which="smallest", iters=m, seed=seed, v0=v0,
                       return_vectors=True)
    return deflation_basis_from_vectors(op, res.vectors)


def basis_quality(A: Any, basis: DeflationBasis, n: Optional[int] = None) -> torch.Tensor:
    """Relative Ritz residuals ‖A wᵢ − θᵢ wᵢ‖ / θᵢ per basis column.

    The deflation payoff tracks this number: columns ≲ 0.1 behave nearly
    like exact eigenvectors; columns near 1 contribute nothing.  If the
    gain disappoints, raise ``lanczos_iters`` (or harvest from a longer
    solve) until this drops.
    """
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=basis.W.dtype, device=basis.W.device)
    W = basis.W
    AW = _columns(op.matvec)(W)
    wnorm2 = torch.sum(W * W, dim=0)
    theta = torch.sum(W * AW, dim=0) / wnorm2
    res = torch.linalg.vector_norm(AW - W * theta[None, :], dim=0)
    return res / (theta * torch.sqrt(wnorm2))


def _cg_harvest(op, b: torch.Tensor, m: int):
    """m plain-CG iterations recording the Lanczos process they induce.

    CG and Lanczos build the same Krylov space: the normalized residuals
    are the Lanczos vectors (up to sign (−1)ʲ) and the CG coefficients give
    the tridiagonal (Saad, Iterative Methods, §6.7.3).  A fixed m-step loop
    with no done test and no host read; the ρ == 0 guard freezes α at 0.
    Returns (V (m, n) scaled residuals, alphas, betas, x_m)."""
    n = b.shape[0]
    dt = torch.promote_types(b.dtype, torch.float32)
    dev = b.device
    V = torch.zeros((m, n), dtype=dt, device=dev)
    al = torch.zeros((m,), dtype=dt, device=dev)
    be = torch.zeros((m,), dtype=dt, device=dev)
    x = torch.zeros((n,), dtype=dt, device=dev)
    r = b.to(dt)
    p = r
    rho = torch.sum(r * r)
    for j in range(m):
        V[j] = (1.0 if j % 2 == 0 else -1.0) * r / torch.sqrt(rho)
        q = op.matvec(p)
        pap = torch.sum(p * q)
        exact = rho == 0
        alpha = torch.where(exact, 0, rho / torch.where(exact, 1, pap))
        x = x + alpha * p
        r = r - alpha * q
        rho_next = torch.sum(r * r)
        beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, rho))
        p = r + beta * p
        al[j] = alpha
        be[j] = beta
        rho = rho_next
    return V, al, be, x


def harvest_deflation_basis(
    A: Any,
    b: torch.Tensor,
    k: int = 8,
    m: Optional[int] = None,
    n: Optional[int] = None,
    return_x: bool = False,
):
    """Run m CG iterations on ``A x = b`` (x0 = 0) and harvest the k lowest
    Ritz vectors from the iteration's own coefficients: the first solve of
    a sequence pays for every later solve's deflation with no extra matvecs
    beyond the k that form AW.

    ``m`` defaults to ``max(4k, 2k+20)``; quality improves with m like
    Lanczos convergence to the low end of the spectrum (check
    :func:`basis_quality`).  The α and β come to the host once, after the
    m steps; the tridiagonal, truncated at the first α == 0 (exact
    convergence), is solved there in float64.  ``return_x=True`` also
    returns the pass's own m-th iterate, ``(basis, x_m)``: warm-start the
    first solve with it (``deflated_cg_solve(..., x0=x_m)``).
    """
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=b.dtype, device=b.device)
    m = int(min(max(4 * k, 2 * k + 20) if m is None else m, op.shape[0]))
    if not 0 < k <= m:
        raise ValueError(f"need 0 < k <= m, got k={k}, m={m}")
    V, al, be, x_m = _cg_harvest(op, b, m)
    al = al.double().cpu().numpy()
    be = be.double().cpu().numpy()
    # truncate where CG reached exact convergence (alpha frozen at 0)
    alive = np.flatnonzero(al == 0)
    mm = max(int(alive[0]) if len(alive) else m, 1)
    diag = 1.0 / al[:mm]
    diag[1:] += be[: mm - 1] / al[: mm - 1]
    off = np.sqrt(be[: mm - 1]) / al[: mm - 1]
    T = np.diag(diag)
    if mm > 1:
        T = T + np.diag(off, 1) + np.diag(off, -1)
    _, Y = np.linalg.eigh(T)
    kk = min(k, mm)
    Yk = torch.as_tensor(Y[:, :kk], dtype=V.dtype, device=V.device)
    W = (V[:mm].T @ Yk).to(op.dtype)
    basis = deflation_basis_from_vectors(op, W)
    if return_x:
        return basis, x_m.to(b.dtype)
    return basis


def _pdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    acc = torch.promote_types(u.dtype, torch.float32)
    return torch.sum(u.to(acc) * v.to(acc)).to(u.dtype)


def deflated_cg_solve(
    A: Any,
    b: torch.Tensor,
    basis: DeflationBasis,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
) -> Tuple[torch.Tensor, CGInfo]:
    """(P)CG with the k lowest modes deflated out of the iteration.

    The call shape and loop semantics of :func:`~.cg.cg_solve` plus
    ``basis`` (from :func:`make_deflation_basis`,
    :func:`harvest_deflation_basis` or
    :func:`deflation_basis_from_vectors`; reuse it across solves).  Two
    departures from the plain loop: the solve STOPS (``converged=False``)
    once ‖r‖² grows 10⁶× above its running minimum without meeting the
    tolerance — past its stagnation floor the projector's E⁻¹ amplifies
    rounding noise, where plain CG merely stagnates — and the returned x is
    the best iterate by ‖r‖, which is the last one on every healthy solve.
    Steps after the stop (or the cap) are masked: they leave the
    iteration count, x, the best x, the minimum, the history and both flags
    as they are.
    """
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=b.dtype, device=b.device)
    N = op.shape[0]
    maxiter = int(N + 1 if maxiter is None else maxiter)
    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    x0 = torch.zeros_like(b) if x0 is None else x0
    precond = (lambda r: r) if M is None else M
    W, AW = basis.W, basis.AW

    # Galerkin initial correction: x0 += W E⁻¹ Wᵀ r0, so that Wᵀ r0 = 0
    r = b - op.matvec(x0)
    mu = _solve_E(basis, W.T @ r)
    x = x0 + W @ mu
    r = r - AW @ mu
    z = precond(r)
    p = _project(basis, z)
    rnorm0 = _pdot(r, r)
    rho0 = rnorm0 if M is None else _pdot(r, z)
    hist = torch.full((maxiter + 1,), float("nan"), dtype=rnorm0.dtype, device=b.device)
    hist[0] = rnorm0
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    c = {"k": torch.zeros((), dtype=torch.int32, device=b.device), "done": false,
         "divg": false, "x": x, "r": r, "p": p, "rho": rho0, "rnorm": rnorm0,
         "x_best": x, "rnorm_min": rnorm0}

    def live():
        return (c["k"] < maxiter) & ~c["done"] & ~c["divg"]

    def step():
        on = live()
        q = op.matvec(c["p"])
        pap = _pdot(c["p"], q)
        rho, rnorm = c["rho"], c["rnorm"]
        exact = rho == 0
        alpha = torch.where(exact, 0, rho / torch.where(exact, 1, pap))
        x = c["x"] + alpha * c["p"]
        r = c["r"] - alpha * q
        # the pre-update tolerance test (cg.py semantics) and the
        # divergence guard: 1e6 on ‖r‖² (1000x in norm) over the running
        # best, far above any healthy CG transient
        tol_met = torch.sqrt(rnorm) <= tol_t
        diverged = (rnorm > 1e6 * c["rnorm_min"]) & ~tol_met
        done = torch.isnan(rnorm) | tol_met | diverged
        z = precond(r)
        rnorm_next = _pdot(r, r)
        rho_next = rnorm_next if M is None else _pdot(r, z)
        beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, rho))
        p = _project(basis, z) + beta * c["p"]
        k = c["k"] + on.to(torch.int32)
        kk = k.long().reshape(1)  # tensor index: no host read
        hist.index_put_((kk,), torch.where(on, rnorm_next, hist.gather(0, kk)[0]).reshape(1))
        better = rnorm_next < c["rnorm_min"]
        new = {"x": x, "r": r, "p": p, "rho": rho_next, "rnorm": rnorm_next,
               "x_best": torch.where(better, x, c["x_best"]),
               "rnorm_min": torch.where(better, rnorm_next, c["rnorm_min"]),
               "done": done & ~diverged, "divg": c["divg"] | diverged}
        for key, val in new.items():
            c[key] = torch.where(on, val, c[key])
        c["k"] = k

    run_chunked(step, live, maxiter, done=lambda: c["done"] | c["divg"])
    # the best iterate: the last one on healthy solves, the pre-divergence
    # solution when the guard fired
    use_best = c["rnorm_min"] < c["rnorm"]
    x = torch.where(use_best, c["x_best"], c["x"])
    rnorm_out = torch.where(use_best, c["rnorm_min"], c["rnorm"])
    info = CGInfo(
        iterations=c["k"],
        # the divergence guard is a failure stop, never a convergence
        converged=c["done"] & ~torch.isnan(rnorm_out) & ~c["divg"],
        rho=c["rho"],
        rnorm_sq=rnorm_out,
        rho_history=hist,
    )
    return x, info
