"""Pure-NumPy float64 replica of the reference CG — the parity oracle.

This is an executable transcription of SURVEY.md §2.3's semantics (derived
from CG.hpp:255-454), used as the golden model in tests: the JAX solver must
reproduce its residual history iteration-for-iteration (to float64 roundoff
on CPU; to a documented tolerance ladder in f32 on TPU).

Deliberately boring: no JAX, no cleverness — numpy f64 only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class OracleResult:
    x: np.ndarray
    iterations: int
    converged: bool
    rho_history: np.ndarray  # ‖r_k‖² for k = 0..iterations


def csr_matvec_np(data, indices, indptr, x):
    """Row-serial CSR SpMV, matching VectorOperations.hpp:455-462 order."""
    n = len(indptr) - 1
    y = np.zeros(n, dtype=np.result_type(data, x))
    for i in range(n):
        s = 0.0
        for j in range(indptr[i], indptr[i + 1]):
            s += data[j] * x[indices[j]]
        y[i] = s
    return y


def csr_matvec_np_fast(data, indices, indptr, x):
    """Vectorized equivalent (identical up to summation order within a row)."""
    n = len(indptr) - 1
    prods = data * x[indices]
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    y = np.zeros(n, dtype=prods.dtype)
    np.add.at(y, row_ids, prods)
    return y


def reference_cg(
    matvec: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
) -> OracleResult:
    """Unpreconditioned CG with the reference's exact control flow:

    * r is the recurrence residual (CG.hpp:392), never recomputed;
    * α = ρ/pᵀAp, β = ρ₊/ρ (Hestenes–Stiefel, CG.hpp:386,414);
    * each body tests the pre-update ρ_k: done ⇔ isnan(√ρ_k) or √ρ_k ≤ tol
      (CG.hpp:401-402, deterministic reading of the race per SURVEY §2.3(5));
    * do-while cap: at most N+1 bodies (CG.hpp:436).
    """
    b = np.asarray(b, dtype=np.float64)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n + 1
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, dtype=np.float64).copy()

    r = b - matvec(x)
    p = r.copy()
    rho = float(r @ r)
    hist = [rho]

    k = 0
    done = False
    while k < maxiter and not done:
        q = matvec(p)
        pap = np.float64(p @ q)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = np.float64(rho) / pap  # 0/0 -> NaN like the device path
        x = x + alpha * p
        r = r - alpha * q
        done = bool(np.isnan(rho) or np.sqrt(rho) <= tol)
        rho_next = float(r @ r)
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.float64(rho_next) / np.float64(rho)
        p = r + beta * p
        rho = rho_next
        hist.append(rho)
        k += 1

    return OracleResult(
        x=x, iterations=k, converged=done, rho_history=np.array(hist)
    )


def reference_pcg(
    matvec: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    minv: Callable[[np.ndarray], np.ndarray],
    x0: Optional[np.ndarray] = None,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
) -> OracleResult:
    """PCG oracle with the same termination placement (on ‖r‖², not r·z)."""
    b = np.asarray(b, dtype=np.float64)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n + 1
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, dtype=np.float64).copy()

    r = b - matvec(x)
    z = minv(r)
    p = z.copy()
    rho = float(r @ z)
    rnorm = float(r @ r)
    hist = [rnorm]

    k = 0
    done = False
    while k < maxiter and not done:
        q = matvec(p)
        pap = np.float64(p @ q)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = np.float64(rho) / pap
        x = x + alpha * p
        r = r - alpha * q
        done = bool(np.isnan(rnorm) or np.sqrt(rnorm) <= tol)
        z = minv(r)
        rnorm = float(r @ r)
        rho_next = float(r @ z)
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.float64(rho_next) / np.float64(rho)
        p = z + beta * p
        rho = rho_next
        hist.append(rnorm)
        k += 1

    return OracleResult(x=x, iterations=k, converged=done, rho_history=np.array(hist))


def accuracy_np(matvec, b, x) -> float:
    """The reference's squared-norm-ratio error metric (CG.hpp:463-515).

    x == 0 yields NaN/inf like the device counterpart, not a Python
    ZeroDivisionError."""
    res = b - matvec(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        return abs(float(np.float64(res @ res) / np.float64(x @ x)))
