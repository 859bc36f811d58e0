"""Preconditioners.  Counterpart of ``conjugategradient_tpu/solver/precond.py``.

A preconditioner is a callable ``r -> M⁻¹ r`` on device tensors: Jacobi
(one elementwise multiply, folded into the fused PCG kernels through its
``inv_diag``), block-Jacobi (the inverted diagonal blocks applied as a DIA
product with 2b − 1 diagonals for b ≤ 16, on the card the DIA kernel, else
one batched contraction), and the Chebyshev polynomial (``degree − 1``
matvecs of the operator).  ``estimate_spectral_bounds`` gives Chebyshev its
interval from a short Lanczos run on the device (:func:`lanczos_tridiag`),
which ``solver/eigs.py`` and ``expected_step_count`` share.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..types import DIAMatrix, as_linear_operator


def jacobi_preconditioner(A: Any, eps: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """M⁻¹ r = r / diag(A).  ``eps`` guards against (near-)zero diagonals.

    The returned apply carries ``inv_diag`` so ``cg_solve`` can send a
    Jacobi solve to the fused PCG kernels, which fold the apply into the
    direction update and the ρ reduction.
    """
    op = as_linear_operator(A)
    d = op.diagonal()
    if eps:
        d = torch.where(d.abs() > eps, d, torch.sign(d) * eps + (d == 0) * eps)
    inv_d = 1.0 / d

    def apply(r: torch.Tensor) -> torch.Tensor:
        return inv_d * r

    apply.inv_diag = inv_d
    return apply


def identity_preconditioner() -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda r: r


def _diagonal_blocks_host(op: Any, b: int) -> np.ndarray:
    """A's diagonal b×b blocks as a host float64 (nb, b, b) array, once at
    setup.  Rows past n pad with identity so the inversion stays
    well-posed."""
    from ..types import CSRMatrix, DenseOperator, SellMatrix, StencilOperator

    n = op.shape[0]
    nb = -(-n // b)
    blocks = np.zeros((nb, b, b), dtype=np.float64)
    pad = np.arange(n, nb * b)
    blocks[pad // b, pad % b, pad % b] = 1.0

    def host(t) -> np.ndarray:
        return t.detach().cpu().numpy()

    def scatter(rows, cols, vals):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        keep = rows // b == cols // b
        r, c, v = rows[keep], cols[keep], np.asarray(vals, np.float64)[keep]
        np.add.at(blocks, (r // b, r % b, c % b), v)

    if isinstance(op, CSRMatrix):
        scatter(host(op.row_ids), host(op.indices), host(op.data))
    elif isinstance(op, SellMatrix):
        rows = np.arange(n, dtype=np.int64)
        scatter(rows, rows, host(op.diag))
        row_perm = np.argsort(host(op.pos).astype(np.int64), kind="stable")
        cols_flat = host(op.cols_flat).astype(np.int64)
        vals_flat = host(op.vals_flat).astype(np.float64)
        start = base = 0
        for nb_, k in op.bucket_meta:
            if k == 0:
                start += nb_
                continue
            r = np.repeat(row_perm[start: start + nb_], k)
            # padding slots carry value 0: harmless in the scatter-add
            scatter(r, cols_flat[base: base + nb_ * k], vals_flat[base: base + nb_ * k])
            start += nb_
            base += nb_ * k
    elif isinstance(op, DIAMatrix):
        diags = host(op.diags).astype(np.float64)
        for d, off in enumerate(op.offsets):
            if abs(off) >= b:
                continue
            i = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
            scatter(i, i + off, diags[d, i])
    elif isinstance(op, StencilOperator):
        nx, ny, nz = op.grid_shape
        i = np.arange(n, dtype=np.int64)
        scatter(i, i, np.full(n, op.center))
        # the only index-adjacent coupling is the z±1 neighbour, absent
        # across a z-line boundary; x/y neighbours land in-block only if b > nz
        for stride in (1, nz, ny * nz):
            if stride >= n:
                continue
            j = i[: n - stride]
            if stride == 1:
                j = j[(j + 1) % nz != 0]
            elif stride == nz:
                j = j[(j // nz + 1) % ny != 0]
            vals = np.full(len(j), op.off)
            scatter(j, j + stride, vals)
            scatter(j + stride, j, vals)
    elif isinstance(op, DenseOperator):
        a = host(op.a).astype(np.float64)
        for i in range(nb):
            lo, hi = i * b, min((i + 1) * b, n)
            blocks[i, : hi - lo, : hi - lo] = a[lo:hi, lo:hi]
    else:
        raise TypeError(
            f"block_jacobi_preconditioner cannot extract diagonal blocks "
            f"from {type(op).__name__}; build it from a CSR/SELL/DIA/dense/"
            "stencil operator or pass an explicit preconditioner"
        )
    return blocks


def block_jacobi_preconditioner(
    A: Any, block_size: int = 8, n: Optional[int] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Block-Jacobi: M = block-diag(A) with ``block_size``×``block_size``
    blocks, extracted and inverted on the host in float64 once.

    ``block_size=1`` is :func:`jacobi_preconditioner`.  Up to 16 the apply
    is a DIA product: row k of the block-diagonal inverse has its entries
    on the 2b − 1 diagonals −(b−1)…(b−1), W[δ, k] = inv[k//b, k%b, k%b+δ]
    where that column lies in the block and inside the matrix, else 0; as
    a ``DIAMatrix`` on the operator's device it runs the DIA kernel on the
    card (float32; at most 31 diagonals, kernel 7's by-value route).
    Larger blocks apply as one batched (nb, b, b)×(nb, b) contraction.
    The apply carries ``inv_blocks`` (host float64 for the DIA form, the
    device blocks for the contraction) and ``block_size``.
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    op = as_linear_operator(A, n=n)
    if block_size == 1:
        return jacobi_preconditioner(op)
    m = op.shape[0]
    blocks = _diagonal_blocks_host(op, block_size)
    inv_np = np.linalg.inv(blocks)
    npad = inv_np.shape[0] * block_size

    if block_size <= 16:
        bsz = block_size
        k = np.arange(m)
        i_blk, a_row = k // bsz, k % bsz
        offsets = tuple(range(-(bsz - 1), bsz))
        W = np.zeros((len(offsets), m), dtype=np.float64)
        for d, delta in enumerate(offsets):
            jcol = a_row + delta
            # columns past m meet the zero padding of the JAX apply
            ok = (jcol >= 0) & (jcol < bsz) & (k + delta < m)
            W[d, ok] = inv_np[i_blk[ok], a_row[ok], jcol[ok]]
        wop = DIAMatrix(torch.from_numpy(W).to(op.dtype).to(op.device), offsets, (m, m),
                        int(np.count_nonzero(W)))

        def apply(r: torch.Tensor) -> torch.Tensor:
            return wop.matvec(r).to(r.dtype)

        apply.inv_blocks = inv_np
    else:
        inv_blocks = torch.from_numpy(inv_np).to(op.dtype).to(op.device)

        def apply(r: torch.Tensor) -> torch.Tensor:
            rp = torch.nn.functional.pad(r, (0, npad - m)) if npad != m else r
            y = torch.einsum("nij,nj->ni", inv_blocks.to(r.dtype), rp.reshape(-1, block_size))
            return y.reshape(-1)[:m]

        apply.inv_blocks = inv_blocks

    apply.block_size = block_size
    return apply


def lanczos_tridiag(op: Any, v0: torch.Tensor, k: int):
    """k Lanczos steps with full reorthogonalization, every scalar on the
    device (no host read per step).  The counterpart of the JAX package's
    ``_lanczos_tridiag_device``: the recurrence runs in at least float32,
    only the matvec's input drops to ``op.dtype``; on breakdown (β at or
    below 1e-12 in float64, 1e-6 below, the dtype's noise floor) the
    recurrence freezes, emitting zero β and zero vectors, so the caller
    truncates at the first zero β.  Returns (V (k, m), alphas, betas)."""
    dt = torch.promote_types(v0.dtype, torch.float32)
    v0 = v0.to(dt)
    m = v0.shape[0]
    v = v0 / torch.linalg.vector_norm(v0)
    breakdown_tol = 1e-12 if dt == torch.float64 else 1e-6
    V = torch.zeros((k, m), dtype=dt, device=v0.device)
    alphas = torch.zeros(k, dtype=dt, device=v0.device)
    betas = torch.zeros(k, dtype=dt, device=v0.device)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dt, device=v0.device)
    for j in range(k):
        V[j] = v
        w = op.matvec(v.to(op.dtype)).to(dt)
        alpha = torch.dot(v, w)
        w = w - alpha * v - beta * v_prev
        # rows past j are zero, so the whole basis costs nothing extra
        w = w - V.T @ (V @ w)
        beta_new = torch.linalg.vector_norm(w)
        safe = beta_new > breakdown_tol
        beta_kept = torch.where(safe, beta_new, 0.0)
        alphas[j] = alpha
        betas[j] = beta_kept
        v_prev, v = v, torch.where(safe, w / torch.where(safe, beta_new, 1.0), 0.0)
        beta = beta_kept
    return V, alphas, betas


def estimate_spectral_bounds(
    A: Any,
    n: Optional[int] = None,
    iters: int = 30,
    seed: int = 0,
    safety: float = 1.1,
    min_margin: float = 4.0,
    *,
    device=None,
):
    """(λ_min, λ_max) of an SPD operator for Chebyshev setup, from the
    extreme Ritz values of ``iters`` Lanczos steps: Ritz values lie inside
    the spectrum, so λ_max is inflated by ``safety`` and λ_min deflated by
    ``min_margin`` (and kept at least λ_max·1e-8).  The basis is capped at
    ~1 GB of device memory.  ``device``: where a callable ``A``'s vectors
    go (None: ``DEFAULT_DEVICE``)."""
    from .eigs import _lanczos_ritz

    op = as_linear_operator(A, n=n, device=device)
    m = op.shape[0]
    itemsize = torch.empty((), dtype=op.dtype).element_size()
    k = int(min(iters, max(3, (1 << 30) // (itemsize * m))))
    _, _, ritz, _, _, _ = _lanczos_ritz(op, k, n, seed, None)
    lam_max = float(ritz[-1]) * safety
    lam_min = max(float(ritz[0]) / min_margin, lam_max * 1e-8)
    return lam_min, lam_max


def chebyshev_preconditioner(
    A: Any,
    lam_min: float,
    lam_max: float,
    degree: int = 8,
    n: Optional[int] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Chebyshev polynomial preconditioner M⁻¹ ≈ p(A) ≈ A⁻¹ on
    [lam_min, lam_max]: ``degree`` steps of the Chebyshev semi-iteration on
    A z = r from z = 0, the first without a matvec, so an apply costs
    ``degree − 1`` matvecs (on the card the operator's kernel).  A fixed
    linear operator, so PCG theory applies."""
    if degree < 2:
        raise ValueError(f"degree must be >= 2, got {degree}")
    if not (0 < lam_min < lam_max):
        raise ValueError(
            f"need 0 < lam_min < lam_max, got [{lam_min}, {lam_max}] "
            "(an inverted/non-positive interval makes M indefinite)"
        )
    op = as_linear_operator(A, n=n)
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta

    def apply(r: torch.Tensor) -> torch.Tensor:
        rho_old = 1.0 / sigma1
        z = r / theta
        z_old = torch.zeros_like(r)
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            resid = r - op.matvec(z)
            z, z_old = rho * (2.0 * resid / delta + rho_old * (z - z_old)) + z, z
            rho_old = rho
        return z

    return apply
