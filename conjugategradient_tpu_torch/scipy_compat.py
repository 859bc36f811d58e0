"""``scipy.sparse.linalg``-compatible front end.  Counterpart of
``conjugategradient_tpu/scipy_compat.py``.

Python users arrive from ``scipy.sparse.linalg``; this module speaks its
signatures and return conventions, so a call site migrates by changing
one import:

    from conjugategradient_tpu_torch.scipy_compat import cg
    x, info = cg(A_scipy, b, rtol=1e-8)    # info == 0 on convergence

Differences from the reference-parity API (``solver.cg.cg_solve``):

* termination is scipy's: ``‖r_k‖₂ <= max(rtol·‖b‖₂, atol)``, tested on the
  recurrence residual, against the reference's absolute tolerance;
* the return is scipy's ``(x, info)``: ``info = 0`` converged, ``> 0`` the
  iteration count at which the cap stopped the solve, ``< 0`` a breakdown
  (NaN residual); x is a torch tensor on the solve's device;
* ``A`` may be anything ``as_linear_operator`` takes, scipy.sparse matrices
  included, and the solve keeps every vector on the device: ``device``
  (keyword only) is where an input without a device of its own (a scipy
  matrix, a numpy array, a callable) goes, None meaning ``DEFAULT_DEVICE``;
  a torch operator or tensor keeps its own;
* ``callback(xk)`` is supported (xk a numpy array) but steps the solve one
  iteration at a time with host reads between; leave it None for the
  device-resident loop.

A numpy-backed scipy ``LinearOperator`` (or any callable that does not map
a torch tensor to a torch tensor) is refused at setup with ``TypeError``,
given as ``A`` or as ``M``: the solves keep their vectors on the device,
and such a matvec cannot take them there.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .solver.cg import cg_solve
from .types import DEFAULT_DEVICE, LinearOperator, as_linear_operator

__all__ = ["cg", "bicgstab", "minres", "lobpcg", "eigsh"]


def _home(A: Any, device) -> torch.device:
    """Where the solve runs: ``device`` if given; else a torch operator's
    or tensor's own device; else ``DEFAULT_DEVICE``."""
    if device is not None:
        return torch.device(device)
    if isinstance(A, (LinearOperator, torch.Tensor)):
        return A.device
    return torch.device(DEFAULT_DEVICE)


def _as_vector(v, dev, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(v, device=dev)
    return t if dtype is None else t.to(dtype)


def _check_traceable(fn, n, dtype, device, what: str) -> None:
    """scipy users hand over numpy-backed LinearOperators, whose matvec
    cannot take the device tensors the solves keep: one trial apply on a
    zero vector fails at setup with a message that says so, instead of a
    conversion error (or a numpy result) from inside the loop.  Errors of
    another kind from a matvec that does take tensors propagate as they
    are."""
    try:
        y = fn(torch.zeros(n, dtype=dtype, device=device))
    except TypeError as e:
        raise TypeError(
            f"{what} does not take torch tensors ({type(e).__name__}: {e}); a "
            "numpy-backed scipy LinearOperator cannot run inside the solve, which "
            "keeps every vector on the device — pass a scipy.sparse matrix, a dense "
            "array, or a callable written with torch") from e
    if not isinstance(y, torch.Tensor):
        raise TypeError(
            f"{what} returned {type(y).__module__}.{type(y).__name__}, not a torch "
            "tensor; a numpy-backed scipy LinearOperator cannot run inside the solve, "
            "which keeps every vector on the device — pass a scipy.sparse matrix, a "
            "dense array, or a callable written with torch")


def _setup(A, b, x0, M, device):
    """(op, b, x0, M_fn) as every linear solve here takes them: n from b,
    so that a matrix-free A needs no explicit dimension."""
    dev = _home(A, device)
    b = _as_vector(b, dev)
    if b.ndim != 1:
        raise ValueError(f"b must be 1-D, got shape {tuple(b.shape)}")
    op = as_linear_operator(A, n=int(b.shape[0]), device=dev)
    if b.shape[0] != op.shape[0]:
        raise ValueError(f"b has shape {tuple(b.shape)}, expected ({op.shape[0]},)")
    b = b.to(op.device)
    _check_traceable(op.matvec, op.shape[0], b.dtype, b.device, "A")
    if x0 is not None:
        x0 = _as_vector(x0, b.device, b.dtype)
    # scipy's M approximates A^-1 and is applied as M @ r: a callable,
    # anything with .matvec, or what as_linear_operator takes
    M_fn = None
    if M is not None:
        if callable(M) and not hasattr(M, "matvec"):
            M_fn = M
        else:
            M_fn = as_linear_operator(M, n=op.shape[0], device=b.device).matvec
        _check_traceable(M_fn, op.shape[0], b.dtype, b.device, "M")
    return op, b, x0, M_fn


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def cg(
    A: Any,
    b,
    x0=None,
    *,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Any] = None,
    callback: Optional[Callable] = None,
    device=None,
) -> Tuple[torch.Tensor, int]:
    """Drop-in for ``scipy.sparse.linalg.cg`` (see the module docstring)."""
    op, b, x0, M_fn = _setup(A, b, x0, M, device)
    bnorm = float(torch.linalg.vector_norm(b))
    tol = max(float(rtol) * bnorm, float(atol))
    n = op.shape[0]
    mi = int(n * 10 if maxiter is None else maxiter)  # scipy's default: 10n

    if callback is None:
        x, info = cg_solve(op, b, x0, tol=tol, maxiter=mi, M=M_fn)
        if bool(torch.isnan(info.rnorm_sq)):
            return x, -1
        return x, 0 if bool(info.converged) else mi

    return _cg_callback_loop(op, b, x0, tol, mi, M_fn, callback)


def _cg_callback_loop(op, b, x0, tol, mi, M_fn, callback):
    # one step at a time, so that xk can be observed each iteration
    from .solver.cg import cg_init, cg_step

    state = cg_init(op, b, x0, M=M_fn, maxiter=mi)
    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    for _ in range(mi):
        if float(torch.sqrt(state.rnorm_sq)) <= tol:
            return state.x, 0
        if bool(torch.isnan(state.rnorm_sq)):
            return state.x, -1
        state = cg_step(op, state, tol_t, M=M_fn)
        callback(_host(state.x))
    if float(torch.sqrt(state.rnorm_sq)) <= tol:
        return state.x, 0
    return state.x, mi


def minres(
    A: Any,
    b,
    x0=None,
    *,
    shift: float = 0.0,
    rtol: float = 1e-5,
    maxiter: Optional[int] = None,
    M: Optional[Any] = None,
    callback: Optional[Callable] = None,
    device=None,
) -> Tuple[torch.Tensor, int]:
    """Drop-in for ``scipy.sparse.linalg.minres``: symmetric indefinite
    systems ``(A − shift·I) x = b`` (solver/minres.py).

    The conventions of :func:`cg`: scipy's ``(x, info)``, termination
    ``φ̄_k <= rtol·‖b‖₂`` on the recurrence estimate (‖r‖₂ for ``M=None``,
    else the M-norm), maxiter default 5n (scipy's), ``callback(xk)``
    through the step-at-a-time path.  ``show``/``check`` are not
    reproduced (prints and a symmetry probe)."""
    from .solver.minres import minres_init, minres_solve, minres_step

    op, b, x0, M_fn = _setup(A, b, x0, M, device)
    n = op.shape[0]
    tol = float(rtol) * float(torch.linalg.vector_norm(b))
    mi = int(5 * n if maxiter is None else maxiter)  # scipy's default: 5n

    if callback is None:
        x, info = minres_solve(op, b, x0, tol=tol, maxiter=mi, M=M_fn, shift=shift)
        if bool(torch.isnan(info.rnorm)):
            return x, -1
        return x, 0 if bool(info.converged) else mi

    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    shift_t = torch.as_tensor(shift, dtype=b.dtype, device=b.device)
    state = minres_init(op, b, x0, tol_t, shift_t, mi, M_fn)
    for _ in range(mi):
        if bool(state.nan):
            return state.x, -1
        if bool(state.done):
            return state.x, 0
        state = minres_step(op, state, tol_t, shift_t, M_fn)
        callback(_host(state.x))
    if bool(state.nan):
        return state.x, -1
    return state.x, 0 if bool(state.done) else mi


def bicgstab(
    A: Any,
    b,
    x0=None,
    *,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Any] = None,
    callback: Optional[Callable] = None,
    device=None,
) -> Tuple[torch.Tensor, int]:
    """Drop-in for ``scipy.sparse.linalg.bicgstab``: NONSYMMETRIC systems
    (solver/bicgstab.py).

    The conventions of :func:`cg`: scipy's ``(x, info)``, termination
    ``‖r_k‖₂ <= max(rtol·‖b‖₂, atol)`` on the recurrence residual (after
    each half-step too, like scipy), maxiter default 10n (scipy's),
    ``callback(xk)`` through the step-at-a-time path.  A breakdown returns
    scipy's ``info = -10``."""
    from .solver.bicgstab import bicgstab_init, bicgstab_solve, bicgstab_step

    op, b, x0, M_fn = _setup(A, b, x0, M, device)
    n = op.shape[0]
    tol = max(float(rtol) * float(torch.linalg.vector_norm(b)), float(atol))
    mi = int(10 * n if maxiter is None else maxiter)  # scipy's default: 10n

    if callback is None:
        x, info = bicgstab_solve(op, b, x0, tol=tol, maxiter=mi, M=M_fn)
        if bool(info.breakdown):
            return x, -10  # scipy's bicgstab breakdown code
        return x, 0 if bool(info.converged) else mi

    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    state = bicgstab_init(op, b, x0, tol_t, mi, M_fn)
    for _ in range(mi):
        if bool(state.broke):
            return state.x, -10
        if bool(state.done):
            return state.x, 0
        state = bicgstab_step(op, state, tol_t, M_fn)
        callback(_host(state.x))
    if bool(state.broke):
        return state.x, -10
    return state.x, 0 if bool(state.done) else mi


def gmres(
    A: Any,
    b,
    x0=None,
    *,
    rtol: float = 1e-5,
    atol: float = 0.0,
    restart: Optional[int] = None,
    maxiter: Optional[int] = None,
    M: Optional[Any] = None,
    callback: Optional[Callable] = None,
    callback_type: Optional[str] = None,
    device=None,
) -> Tuple[torch.Tensor, int]:
    """Drop-in for ``scipy.sparse.linalg.gmres`` (solver/gmres.py).

    scipy's conventions: ``(x, info)`` with ``info = 0`` on success and
    ``info = maxiter`` (cycles) when the budget runs out; termination
    ``‖r‖₂ <= max(rtol·‖b‖₂, atol)``; ``restart`` defaults to scipy's 20;
    ``maxiter`` counts RESTART CYCLES (the native ``gmres_solve(maxiter=)``
    counts inner steps), defaulting so that the inner steps total about
    10n.  Deviations: RIGHT preconditioning (the residual tested is the
    true ``b − A x``), and ``callback(xk)`` once per restart cycle
    (callback_type "x"; the per-inner-step "pr_norm" and "legacy" modes
    are refused)."""
    from .solver.gmres import gmres_solve

    if callback is not None and callback_type not in (None, "x"):
        raise ValueError(
            "callback_type 'pr_norm'/'legacy' is not supported (per-inner-step "
            "state never leaves the device-resident cycle); use callback_type='x' "
            "(one callback per restart cycle)")
    op, b, x0, M_fn = _setup(A, b, x0, M, device)
    n = op.shape[0]
    if restart is not None and int(restart) < 1:
        raise ValueError(f"restart must be >= 1, got {restart}")
    rst = min(20 if restart is None else int(restart), n)
    cycles = max(1, -(-10 * n // rst)) if maxiter is None else int(maxiter)
    tol = max(float(rtol) * float(torch.linalg.vector_norm(b)), float(atol))

    if callback is None:
        x, info = gmres_solve(op, b, x0, tol=tol, maxiter=cycles * rst, restart=rst, M=M_fn)
        if bool(info.breakdown):
            return x, -1
        return x, 0 if bool(info.converged) else cycles

    # one cycle at a time, so that xk can be observed; warm-starting from
    # x is the restart (each call recomputes r)
    x = x0
    for _ in range(cycles):
        x, info = gmres_solve(op, b, x, tol=tol, maxiter=rst, restart=rst, M=M_fn)
        callback(_host(x))
        if bool(info.breakdown):
            return x, -1
        if bool(info.converged):
            return x, 0
    return x, cycles


def lobpcg(
    A: Any,
    X,
    B: Any = None,
    M: Optional[Any] = None,
    Y=None,
    tol: Optional[float] = None,
    maxiter: Optional[int] = None,
    largest: bool = True,
    verbosityLevel: int = 0,
    retLambdaHistory: bool = False,
    retResidualNormsHistory: bool = False,
    restartControl: int = 20,
    *,
    device=None,
):
    """Drop-in for ``scipy.sparse.linalg.lobpcg`` (solver/lobpcg.py).

    scipy's conventions: ``X`` is the required (n, k) initial block (its
    column count sets the number of pairs), eigenvalues come back
    descending for ``largest=True`` and ascending otherwise, convergence is
    the ABSOLUTE test ``‖A xᵢ − λᵢ (B) xᵢ‖ ≤ tol`` with scipy's default
    ``tol = n · sqrt(eps)``, maxiter defaults to 20, and the history returns
    are lists of (k,) arrays (entry 0 the initial Rayleigh–Ritz).  ``B`` and
    ``M`` (applied as ``M @ r``) take anything ``as_linear_operator``
    takes.  The values and vectors are numpy arrays.

    Intentional differences: ``Y`` (constraint subspace) is not supported
    (the deflation surface, ``make_deflation_basis`` /
    ``deflated_cg_solve``, serves orthogonality constraints);
    ``verbosityLevel`` and ``restartControl`` are no-ops (the [X, W, P]
    basis is re-orthonormalized by a full QR every iteration).
    """
    if Y is not None:
        raise NotImplementedError(
            "lobpcg(Y=...) constraint subspaces are not supported; project the "
            "operator or use the deflation surface (make_deflation_basis / "
            "deflated_cg_solve) instead")
    from .solver.lobpcg import lobpcg_eigs

    dev = _home(A, device)
    X = _as_vector(X, dev)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D (n, k), got shape {tuple(X.shape)}")
    n, k = int(X.shape[0]), int(X.shape[1])
    op = as_linear_operator(A, n=n, dtype=X.dtype, device=dev)
    X = X.to(op.device)
    _check_traceable(op.matvec, n, X.dtype, X.device, "A")

    M_fn = None
    if M is not None:
        if callable(M) and not hasattr(M, "matvec"):
            M_fn = M
        else:
            M_fn = as_linear_operator(M, n=n, dtype=X.dtype, device=X.device).matvec
        _check_traceable(M_fn, n, X.dtype, X.device, "M")

    if tol is None:
        tol = n * float(np.sqrt(torch.finfo(X.dtype).eps))
    mi = 20 if maxiter is None else int(maxiter)  # scipy's default: 20

    result, lam_h, rn_h = lobpcg_eigs(
        op, k=k, M=M_fn, which="largest" if largest else "smallest", X0=X,
        tol=float(tol), maxiter=mi, B=B, dtype=X.dtype, tol_absolute=True,
        return_history=True, device=X.device)
    w = result.values
    v = _host(result.vectors)
    out = [w, v]
    if retLambdaHistory:
        out.append([row for row in lam_h])
    if retResidualNormsHistory:
        out.append([row for row in rn_h])
    return tuple(out) if len(out) > 2 else (w, v)


def eigsh(
    A: Any,
    k: int = 6,
    M: Any = None,
    sigma: Optional[float] = None,
    which: str = "LM",
    v0=None,
    ncv: Optional[int] = None,
    maxiter: Optional[int] = None,
    tol: float = 0,
    return_eigenvectors: bool = True,
    Minv: Any = None,
    OPinv: Any = None,
    mode: str = "normal",
    *,
    device=None,
):
    """Drop-in for ``scipy.sparse.linalg.eigsh`` on SPD operators.

    scipy/ARPACK's conventions on the supported surface: eigenvalues
    ASCENDING whatever ``which``; ``"LM"``/``"LA"`` the largest,
    ``"SM"``/``"SA"`` the smallest (the same pairs on the SPD domain);
    convergence ``‖A xᵢ − λᵢ xᵢ‖ ≤ tol·|λᵢ|``; ``ncv`` seeds the Krylov
    dimension (ARPACK's default ``min(n, max(2k+1, 20))``); ``v0`` starts the
    iteration.  The values and vectors are numpy arrays.

    Standard problems run reorthogonalized Lanczos passes on the device
    (:func:`~.solver.eigs.lanczos_eigs`), doubling the Krylov dimension
    until every requested pair converges, with explicit deflation between
    passes to resolve repeated eigenvalues (``maxiter`` caps the Krylov
    dimension; default: the whole space).  Generalized problems (``M`` =
    the SPD mass matrix, ``A x = λ M x``) run LOBPCG
    (:func:`~.solver.lobpcg.lobpcg_eigs`), where ``maxiter`` caps its
    iterations (default 200).  When the budget runs out before every pair
    meets the test, scipy's own ``ArpackNoConvergence`` is raised, carrying
    the converged eigenvalues.

    Intentional differences: ``tol=0`` (ARPACK: machine precision) means
    ``sqrt(eps)`` of the operator's dtype; shift-invert (``sigma``,
    ``Minv``, ``OPinv``, ``mode != "normal"``) and ``"BE"`` (both ends)
    are not supported.
    """
    if sigma is not None or Minv is not None or OPinv is not None or mode != "normal":
        raise NotImplementedError(
            "shift-invert (sigma/Minv/OPinv/mode) is not supported: the "
            "small end converges directly with which='SM' (Lanczos) or "
            "via preconditioned LOBPCG (scipy_compat.lobpcg / "
            "lobpcg_eigs(M=...)) — no factorization needed")
    if which not in ("LM", "LA", "SM", "SA"):
        raise NotImplementedError(
            f"which={which!r} is not supported (use 'LM'/'LA'/'SM'/'SA'; "
            "'BE' needs two calls, one per end)")
    from .solver.eigs import lanczos_eigs
    from .solver.lobpcg import lobpcg_eigs

    op = as_linear_operator(A, device=_home(A, device))
    n = op.shape[0]
    k = int(k)
    if not 0 < k < n:
        raise ValueError(f"k={k} must satisfy 0 < k < n={n}")
    end = "largest" if which in ("LM", "LA") else "smallest"
    eps = float(torch.finfo(op.dtype).eps)
    rtol = float(tol) if tol else float(np.sqrt(eps))

    def _pair_converged(res):
        # ARPACK's per-pair test ‖A xᵢ − λᵢ xᵢ‖ ≤ tol·|λᵢ|, recomputed here
        # because lobpcg_eigs's own flag scales by the LARGEST Ritz value
        vals = np.asarray(res.values, np.float64)
        resid = np.asarray(res.residuals, np.float64)
        return vals.size >= k and bool(
            np.all(resid <= rtol * np.maximum(np.abs(vals), 1e-300)))

    def _lobpcg(tol_inner=None, absolute=False, X0=None, mi_default=200):
        return lobpcg_eigs(
            op, k=k, B=None if M is None else op_m, which=end,
            tol=rtol if tol_inner is None else tol_inner,
            tol_absolute=absolute, X0=X0,
            maxiter=mi_default if maxiter is None else int(maxiter))

    def _lobpcg_to_pair_tol():
        # lobpcg_eigs's test scales by the largest Ritz value; the ARPACK
        # contract is per pair: one warm-restarted round at the ABSOLUTE
        # tolerance rtol·min|λᵢ| closes the gap
        res = _lobpcg()
        if not _pair_converged(res):
            vals = np.abs(np.asarray(res.values, np.float64))
            if vals.size and vals.min() > 0:
                res = _lobpcg(tol_inner=rtol * float(vals.min()), absolute=True,
                              X0=res.vectors)
        return res

    if M is not None:
        op_m = as_linear_operator(M, n=n, dtype=op.dtype, device=op.device)
        res = _lobpcg_to_pair_tol()
    else:
        vals, vecs = _eigsh_lanczos_deflated(op, lanczos_eigs, _lobpcg_to_pair_tol, k, end,
                                             rtol, ncv, maxiter, v0, n)
        res = None

    if res is not None:
        vals = np.asarray(res.values, np.float64)
        if not _pair_converged(res):
            _raise_no_convergence(res.values, res.residuals, k, rtol, n)
        vecs = None if not return_eigenvectors else _host(res.vectors)

    # scipy returns ascending for eigsh whichever end converged
    order = np.argsort(vals)
    w = vals[order]
    if not return_eigenvectors:
        return w
    return w, np.asarray(vecs)[:, order]


def _raise_no_convergence(vals, resids, k, rtol, n):
    vals = np.asarray(vals, np.float64)
    conv = np.asarray(resids, np.float64) <= rtol * np.maximum(np.abs(vals), 1e-300)
    w_ok = np.sort(vals[conv[: vals.size]])
    from scipy.sparse.linalg import ArpackNoConvergence

    raise ArpackNoConvergence(
        f"eigsh: only {int(conv.sum())}/{k} pairs converged to "
        f"tol={rtol:g} within the iteration budget (raise maxiter/"
        "ncv, or precondition via lobpcg_eigs(M=...))",
        w_ok, np.empty((n, 0)))


def _eigsh_lanczos_deflated(op, lanczos_eigs, lobpcg_fallback, k, end, rtol, ncv, maxiter,
                            v0, n):
    """The eigsh standard-problem engine: adaptive Lanczos passes with
    EXPLICIT DEFLATION between passes.

    One Krylov vector cannot resolve eigenvalue MULTIPLICITY: a pass finds
    at most one copy of a repeated eigenvalue.  After each pass the
    accepted eigenvectors V are shifted out of the wanted end (``A ±
    σ·VVᵀ``, σ spanning the spectral range) and the next pass, from a fresh
    random start (seeded by the attempt), finds what the subspace hid.
    Passes repeat until one adds nothing to the k best (two passes without
    multiplicity: find and verify).  Every accepted pair is re-checked
    against the UNDEFLATED operator on the host: the Rayleigh quotient and
    the exact ‖A v − ρ v‖ ≤ rtol·|ρ| after orthogonalization against the
    accepted basis.
    """
    m0 = int(ncv) if ncv is not None else min(n, max(2 * k + 1, 20))
    m0 = max(m0, 2 * k)
    m_cap = min(n, int(maxiter)) if maxiter is not None else n
    m_cap = max(m_cap, min(2 * k, n))
    v0t = None if v0 is None else torch.as_tensor(v0, device=op.device)

    def adaptive(target, seed, use_v0):
        m = m0
        while True:
            r = lanczos_eigs(target, k=k, which=end, iters=min(m, m_cap),
                             v0=v0t if use_v0 else None, seed=seed, rtol=rtol, n=n,
                             device=op.device)
            vs = np.asarray(r.values, np.float64)
            ok = (vs.size >= k and bool(np.all(
                np.asarray(r.residuals, np.float64)
                <= rtol * np.maximum(np.abs(vs), 1e-300))))
            if ok or m >= m_cap:
                return r
            m = min(2 * m, m_cap)

    # spectral-range probe for the deflation shift (one short pass at the
    # opposite end; Ritz extremes are interior, hence the safety factor)
    other = "largest" if end == "smallest" else "smallest"
    probe = lanczos_eigs(op, k=1, which=other, iters=min(30, n), n=n, return_vectors=False,
                         device=op.device)
    span = float(np.abs(np.asarray(probe.values, np.float64)).max())
    sgn = 1.0 if end == "smallest" else -1.0

    found_w: list = []
    V = np.zeros((n, 0), dtype=np.float64)

    for attempt in range(k + 2):
        # the shift must clear the whole spectral range, so that every
        # accepted eigenvalue leaves the wanted end
        sigma = 4.0 * max(span, max((abs(w) for w in found_w), default=0.0), 1.0)
        if V.shape[1]:
            Vt = torch.as_tensor(V, dtype=op.dtype, device=op.device)

            def mv(x, _V=Vt):
                return op.matvec(x) + (sgn * sigma) * (_V @ (_V.T @ x))

            # wrapped with the operator's dtype and device: the Krylov pass
            # then runs in op.dtype (a bare callable defaults to float32,
            # below the exact float64 acceptance residual) and on op's device
            target = as_linear_operator(mv, n=n, dtype=op.dtype, device=op.device)
        else:
            target = op
        r = adaptive(target, seed=attempt, use_v0=attempt == 0)
        vs = np.asarray(r.values, np.float64)
        rs = np.asarray(r.residuals, np.float64)
        improved = False
        for i in range(vs.size):
            lam = float(vs[i])
            # deflated copies of found pairs need no eigenvalue filter: their
            # vectors fail the new-direction check, and a mixed candidate
            # faces the exact undeflated residual test
            if rs[i] > rtol * max(abs(lam), 1e-300):
                continue
            v = _host(r.vectors[:, i]).astype(np.float64)
            if V.shape[1]:
                v = v - V @ (V.T @ v)
                nrm = float(np.linalg.norm(v))
                if nrm < 0.5:  # the direction of an accepted vector
                    continue
                v = v / nrm
            # exact acceptance against the UNDEFLATED operator
            av = _host(op.matvec(torch.as_tensor(v, dtype=op.dtype,
                                                 device=op.device))).astype(np.float64)
            rho = float(v @ av)
            if float(np.linalg.norm(av - rho * v)) > rtol * max(abs(rho), 1e-300):
                continue
            # does it enter the k best?
            if len(found_w) >= k:
                kth = (max(sorted(found_w)[:k]) if end == "smallest"
                       else min(sorted(found_w)[-k:]))
                better = rho < kth if end == "smallest" else rho > kth
                if not better:
                    continue
            found_w.append(rho)
            V = np.concatenate([V, v[:, None]], axis=1)
            improved = True
        if len(found_w) >= k and not improved:
            break
        if not improved and len(found_w) < k:
            break  # another identical pass will not help; fall back

    if len(found_w) < k:
        # invariant-subspace starvation the deflation passes could not
        # feed (or a genuinely unconverged end): block iteration when a 3k
        # basis fits, dense diagonalization when n is tiny
        if 3 * k <= n:
            res = lobpcg_fallback()
            vals = np.asarray(res.values, np.float64)
            resid = np.asarray(res.residuals, np.float64)
            if vals.size < k or bool(np.any(resid > rtol * np.maximum(np.abs(vals), 1e-300))):
                _raise_no_convergence(vals, resid, k, rtol, n)
            return vals, _host(res.vectors).astype(np.float64)
        eye = torch.eye(n, dtype=op.dtype, device=op.device)
        dense = torch.stack([op.matvec(eye[:, j].contiguous()) for j in range(n)], dim=1)
        w_all, v_all = np.linalg.eigh(_host(dense).astype(np.float64))
        sl = slice(0, k) if end == "smallest" else slice(n - k, n)
        return w_all[sl], v_all[:, sl]

    order = np.argsort(np.asarray(found_w))
    order = order[:k] if end == "smallest" else order[-k:]
    return np.asarray(found_w)[order], V[:, order]
