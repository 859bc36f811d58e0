"""LOBPCG — preconditioned block eigensolver for SPD operators.
Counterpart of ``conjugategradient_tpu/solver/lobpcg.py``.

Locally Optimal Block Preconditioned Conjugate Gradient (Knyazev): a
k-column block iterated with a preconditioner — the same ``M`` callables
the linear solves take (Jacobi, block-Jacobi, Chebyshev, multigrid, AMG,
FSAI) — converging to the extreme eigenpairs at a rate set by M⁻¹A's
spectrum, not A's.

Each iteration re-orthonormalizes the search basis [X, W, P] by a full QR
and applies A to the orthonormal Q directly (3k matvecs), so rank collapse
near convergence degrades to harmless orthonormal completions instead of
NaNs from an ill-conditioned Gram factor.  The block matvec is the layout's
multi-RHS SpMV where it has one (``solver/batched._MULTI``: blocked-ELL in
both storages, SELL, DIA in both storages; plain torch, as the JAX forms
are XLA), every other operator one matvec a column; ``M`` is applied column
by column.  The (3k)² Rayleigh–Ritz is ``torch.linalg.eigh`` on the
device, whose result check reads the host once an iteration.

The loop: masked steps driven by ``restart.run_chunked``; a step once
every pair has converged (or at the cap) leaves the carry and the fixed
(maxiter + 1, k) histories as they are.  A non-finite Ritz matrix or Gram
is not handed to ``eigh`` or the Cholesky factorization, which raise on it
here where the JAX ones return NaN: the step gives NaN instead, so NaN in
gives NaN out and the loop runs to its cap, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ops.spmv import full_precision_matmul
from ..types import as_linear_operator
from .batched import _LOCKSTEP_TYPES, _columns, _lockstep_ops
from .eigs import DEFAULT_RTOL, EigsResult
from .restart import run_chunked


def _block_matvec(op) -> Callable[[torch.Tensor], torch.Tensor]:
    """(n, R) block matvec: the layout's multi-RHS SpMV when it has one,
    else the operator's matvec column by column."""
    if isinstance(op, _LOCKSTEP_TYPES):
        mv, _, _ = _lockstep_ops(op, None)
        return mv
    return _columns(op.matvec)


def _normalize_cols(X: torch.Tensor, tiny: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(X, dim=0)
    return X / torch.maximum(nrm, tiny)[None, :]


def _finite_eigh(T: torch.Tensor):
    """``torch.linalg.eigh`` of a symmetric matrix, or NaN values and
    vectors where T holds a non-finite entry (given the identity instead,
    so that ``eigh`` does not raise)."""
    bad = ~torch.isfinite(T).all()
    eye = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    w, C = torch.linalg.eigh(torch.where(bad, eye, T))
    return torch.where(bad, float("nan"), w), torch.where(bad, float("nan"), C)


def _lobpcg_loop(op, bop, M, X0, P0, tol: float, k: int, maxiter: int, largest: bool,
                 absolute: bool):
    """The LOBPCG iteration on the device.

    Standard (``bop is None``) or generalized (``A x = λ B x``)
    Rayleigh–Ritz: with B, the (3k)² pencil ``T y = θ G y`` (G = QᵀBQ) is
    reduced through a Cholesky congruence ``L⁻¹ T L⁻ᵀ`` so that the solve
    stays a plain ``eigh``; the Ritz block comes out B-orthonormal.
    Returns (lam, X, rn, theta, iters, lam_hist, rn_hist) with the
    histories in fixed (maxiter+1, k) buffers (entry 0 = the initial
    Rayleigh–Ritz)."""
    mv = _block_matvec(op)
    dt = torch.promote_types(X0.dtype, torch.float32)
    dev = X0.device
    tiny = torch.tensor(torch.finfo(dt).tiny ** 0.5, dtype=dt, device=dev)
    X0 = X0.to(dt)
    P0 = P0.to(dt)
    tol_t = torch.tensor(tol, dtype=dt, device=dev)

    def a_apply(Y):
        return mv(Y.to(op.dtype)).to(dt)

    if bop is None:
        b_apply = None
    else:
        bmv = _block_matvec(bop)

        def b_apply(Y):
            return bmv(Y.to(bop.dtype)).to(dt)

    if M is None:
        m_apply = None
    else:
        m_cols = _columns(M)

        def m_apply(R):
            return m_cols(R).to(dt)

    def select(w, C):
        # eigh returns ascending; pick the wanted end, in the wanted order
        if largest:
            return w[-k:].flip(0), C[:, -k:].flip(1)
        return w[:k], C[:, :k]

    def rayleigh_ritz(Q, AQ):
        """Ritz pairs of the pencil (QᵀAQ, QᵀBQ), a plain eigh when B = I.
        Returns (w, C, BQ): the coefficient columns C are G-orthonormal;
        BQ is reused for the generalized residual A X − B X Λ."""
        T = Q.T @ AQ
        T = 0.5 * (T + T.T)
        if b_apply is None:
            w, C = _finite_eigh(T)
            return w, C, None
        BQ = b_apply(Q)
        G = Q.T @ BQ
        G = 0.5 * (G + G.T)
        # Cholesky congruence: G = LLᵀ, eigh(L⁻¹ T L⁻ᵀ), C = L⁻ᵀ C'.  A
        # failed factorization (NaN, or G not positive definite) poisons
        # the factor's lower triangle, as the JAX Cholesky returns it
        m = Q.shape[1]
        L, info = torch.linalg.cholesky_ex(G + tiny * torch.eye(m, dtype=dt, device=dev))
        L = torch.where(info != 0, torch.tril(torch.full_like(L, float("nan"))), L)
        Ti = torch.linalg.solve_triangular(L, T, upper=False)
        Ti = torch.linalg.solve_triangular(L, Ti.T, upper=False).T
        w, Cp = _finite_eigh(0.5 * (Ti + Ti.T))
        C = torch.linalg.solve_triangular(L.T, Cp, upper=True)
        return w, C, BQ

    def ritz_update(Q, AQ):
        """One Rayleigh–Ritz: (lam, Cx, X, R, rn, wmax)."""
        w, C, BQ = rayleigh_ritz(Q, AQ)
        lam, Cx = select(w, C)
        X = Q @ Cx
        AX = AQ @ Cx
        if BQ is None:
            R = AX - X * lam[None, :]
        else:
            R = AX - (BQ @ Cx) * lam[None, :]
        rn = torch.linalg.vector_norm(R, dim=0)
        return lam, Cx, X, R, rn, torch.abs(w).max()

    def scale_of(theta):
        return torch.ones((), dtype=dt, device=dev) if absolute else theta

    # the initial Rayleigh–Ritz on span(X0)
    Xq, _ = torch.linalg.qr(X0, mode="reduced")
    lam, _, X, R, rn, wmax = ritz_update(Xq, a_apply(Xq))
    theta = torch.maximum(wmax, tiny)
    lam_h = torch.full((maxiter + 1, k), float("nan"), dtype=dt, device=dev)
    rn_h = torch.full((maxiter + 1, k), float("nan"), dtype=dt, device=dev)
    lam_h[0] = lam
    rn_h[0] = rn
    box = {"X": X, "P": P0, "lam": lam, "R": R, "rn": rn, "theta": theta,
           "it": torch.zeros((), dtype=torch.int32, device=dev)}
    rows = torch.arange(k, device=dev)

    def live():
        return (box["it"] < maxiter) & ~torch.all(box["rn"] <= tol_t * scale_of(box["theta"]))

    def step():
        c = box
        on = live()
        W = c["R"] if m_apply is None else m_apply(c["R"])
        W = _normalize_cols(W, tiny)
        P = _normalize_cols(c["P"], tiny)
        S = torch.cat([c["X"], W, P], dim=1)
        Q, _ = torch.linalg.qr(S, mode="reduced")  # (n, 3k) orthonormal; QR absorbs rank loss
        lam_new, Cx, X_new, R_new, rn_new, wmax = ritz_update(Q, a_apply(Q))
        # the locally optimal direction block: the new Ritz vectors minus
        # their component in span(X) — Q[:, :k] spans X exactly (the QR is
        # unpivoted), so zeroing the first k coefficient rows removes it
        Cp = Cx.clone()
        Cp[:k] = 0
        P_new = Q @ Cp
        theta_new = torch.maximum(c["theta"], wmax)
        it = c["it"] + on.to(torch.int32)
        slot = it.long().expand(k)  # tensor index: no host read
        lam_h.index_put_((slot, rows), torch.where(on, lam_new, lam_h[slot, rows]))
        rn_h.index_put_((slot, rows), torch.where(on, rn_new, rn_h[slot, rows]))
        for key, new in (("X", X_new), ("P", P_new), ("lam", lam_new), ("R", R_new),
                         ("rn", rn_new), ("theta", theta_new)):
            c[key] = torch.where(on, new, c[key])
        c["it"] = it

    run_chunked(step, live, maxiter, done=lambda: ~live())
    return box["lam"], box["X"], box["rn"], box["theta"], box["it"], lam_h, rn_h


def lobpcg_eigs(
    A: Any,
    k: int = 4,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    which: str = "smallest",
    X0: Optional[Any] = None,
    tol: float = DEFAULT_RTOL,
    maxiter: int = 100,
    n: Optional[int] = None,
    seed: int = 0,
    dtype=None,
    B: Any = None,
    tol_absolute: bool = False,
    return_history: bool = False,
    *,
    device=None,
):
    """k extreme eigenpairs of an SPD operator (or pencil) by preconditioned
    LOBPCG.

    Solves ``A x = λ x``, or ``A x = λ B x`` when ``B`` is given.

    Args:
      A: anything ``as_linear_operator`` takes; a callable needs ``n=`` and
        gets its vectors on ``device`` (None: ``DEFAULT_DEVICE``).
      k: block size = number of eigenpairs; needs ``3k <= n`` (the search
        basis is [X, W, P]).
      M: SPD preconditioner apply ``r -> M⁻¹r`` (any of the package's);
        None: unpreconditioned.
      which: ``"smallest"`` or ``"largest"``.
      X0: optional (n, k) initial block; random from ``seed`` otherwise.
      tol: pair i has converged when ‖A xᵢ − λᵢ (B) xᵢ‖ ≤ tol · θ_max, θ_max
        the largest Ritz value seen; with ``tol_absolute=True``, when
        ‖·‖ ≤ tol (scipy's convention).
      maxiter: iteration cap (each iteration: 3k A-matvecs, k M-applies,
        3k B-matvecs when generalized, one (n, 3k) QR, one (3k)² eigh).
      dtype: given to ``as_linear_operator`` for scipy and callable input
        (a callable defaults to float32 without it).
      B: optional SPD right-hand operator (the same input as ``A``); the
        Ritz vectors come out B-orthonormal.
      return_history: also return ``(lam_history, rnorm_history)``,
        (iters + 1, k) float64 arrays, entry 0 the initial Rayleigh–Ritz.

    X0 and the initial direction block P0 are drawn from
    ``np.random.default_rng(seed)`` (X0 first, when it is not given), as
    the JAX package draws them.  Returns :class:`~.eigs.EigsResult`
    (``iters``: the LOBPCG iterations run), plus the two histories when
    ``return_history``.  Deterministic for fixed inputs and seed.
    """
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be 'smallest' or 'largest', got {which!r}")
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    if maxiter < 1:
        raise ValueError(f"need maxiter >= 1, got {maxiter}")
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=dtype, device=device)
    m_rows = op.shape[0]
    if 3 * k > m_rows:
        raise ValueError(
            f"LOBPCG needs 3k <= n (basis [X, W, P]); got k={k}, "
            f"n={m_rows} — use a dense eigensolver at this size")
    bop = None
    if B is not None:
        bop = as_linear_operator(B, n=m_rows, dtype=dtype, device=op.device)
        if bop.shape[0] != m_rows:
            raise ValueError(f"B must match A's dimension {m_rows}, got {bop.shape[0]}")
    rng = np.random.default_rng(seed)
    if X0 is None:
        X0 = torch.as_tensor(rng.standard_normal((m_rows, k)), dtype=op.dtype, device=op.device)
    else:
        X0 = torch.as_tensor(X0, device=op.device)
        if tuple(X0.shape) != (m_rows, k):
            raise ValueError(f"X0 must have shape ({m_rows}, {k}), got {tuple(X0.shape)}")
    # a random initial P (orthonormalized in the loop) keeps the basis full
    # rank on the first iteration without an [X, W]-only special case
    P0 = torch.as_tensor(rng.standard_normal((m_rows, k)), dtype=op.dtype, device=op.device)

    lam, X, rn, theta, it, lam_h, rn_h = _lobpcg_loop(
        op, bop, M, X0, P0, float(tol), k, int(maxiter), which == "largest",
        bool(tol_absolute))
    lam_np = lam.double().cpu().numpy()
    rn_np = rn.double().cpu().numpy()
    scale = 1.0 if tol_absolute else max(float(theta), 1e-300)
    iters = int(it)
    result = EigsResult(
        values=lam_np,
        vectors=X.to(op.dtype),
        residuals=rn_np,
        converged=rn_np <= tol * scale,
        iters=iters,
    )
    if not return_history:
        return result
    return (result, lam_h[: iters + 1].double().cpu().numpy(),
            rn_h[: iters + 1].double().cpu().numpy())
