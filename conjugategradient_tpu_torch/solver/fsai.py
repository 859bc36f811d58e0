"""FSAI — factorized sparse approximate inverse preconditioner.
Counterpart of ``conjugategradient_tpu/solver/fsai.py``: the same host
factor, bit for bit, applied as two SpMVs on the device.

``M⁻¹ = Gᵀ G ≈ A⁻¹`` where ``G`` is a sparse lower-triangular approximation
of the inverse Cholesky factor ``L⁻¹`` of ``A = L Lᵀ`` (Kolotilina–Yeremin
FSAI).  Its apply is two sparse products, with no triangular solve, on the
layouts the solver already streams (DIA, blocked-ELL, SELL, CSR; on the
card DIA and blocked-ELL factors launch their kernels), and the
minimization is well-posed for every SPD ``A`` (every principal submatrix
is SPD).  The setup is batched small dense solves, done once on the host.

Definition: for each row ``i`` with lower-triangular pattern
``S_i = {j ≤ i}`` taken from the pattern of ``tril(|A|^power)``, solve

    A[S_i, S_i] ĝ = e_i            (the unit vector at i's position)

and scale ``g_i = ĝ / sqrt(ĝ[i])`` so that ``diag(G A Gᵀ) = 1``.  This G
minimizes ``‖I − G L‖_F`` over the pattern.  Rows are grouped by pattern
size and solved as one ``np.linalg.solve`` batch per size; the A[S,S]
gather is one vectorized ``searchsorted`` against the CSR key array.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..types import BlockedEllMatrix, CSRMatrix, DIAMatrix, SellMatrix
from ..types.base import DEFAULT_DEVICE, as_numpy_dtype

# cap on elements per batched-solve gather buffer (k*k*m floats); groups
# larger than this are chunked so setup memory stays bounded (~128 MB f64)
_GATHER_CHUNK_ELEMS = 1 << 24


def _lower_pattern(A_sp, power: int):
    """CSR boolean pattern of tril(|A|^power) with the diagonal forced in.

    Rows come out with sorted column indices, so each row's last pattern
    entry is the diagonal — the position the batched solves' RHS targets.
    """
    import scipy.sparse as sp

    n = A_sp.shape[0]
    B = A_sp.copy().tocsr()
    B.data = np.ones_like(B.data, dtype=np.int8)
    P = B
    for _ in range(power - 1):
        P = (P @ B).tocsr()
        P.data = np.ones_like(P.data, dtype=np.int8)
    P = sp.tril(P, format="csr") + sp.eye(n, format="csr", dtype=np.int8)
    P = P.tocsr()
    P.sum_duplicates()
    P.sort_indices()
    return P.indptr.astype(np.int64), P.indices.astype(np.int64)


def _gather_submatrices(keys, data, n, cols):
    """vals[a, b, c] = A[cols[a, b], cols[a, c]] for a (m, k) column batch.

    ``keys = row*n + col`` over A's CSR entries is globally sorted (CSR row
    order, sorted indices within rows), so one searchsorted resolves every
    (row, col) probe; misses read 0 — pattern slots absent from A are
    exactly the least-squares zeros of the FSAI normal equations.
    """
    m, k = cols.shape
    q = cols[:, :, None] * n + cols[:, None, :]
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, len(keys) - 1)
    hit = keys[pos_c] == q
    return np.where(hit, data[pos_c], 0.0)


def _solve_rows(sub, diag_fallback):
    """Batched solve A_S ĝ = e_last with per-row scaling and SPD guards.

    Returns the scaled g rows (m, k).  Rows whose local solve is singular
    or whose pivot ĝ[last] ≤ 0 (numerically indefinite submatrix) fall
    back to the scalar-Jacobi row g = e_i / sqrt(a_ii).
    """
    m, k = sub.shape[:2]
    rhs = np.zeros((m, k), dtype=sub.dtype)
    rhs[:, -1] = 1.0
    try:
        g = np.linalg.solve(sub, rhs[..., None])[..., 0]
    except np.linalg.LinAlgError:
        g = np.empty((m, k), dtype=sub.dtype)
        for a in range(m):
            try:
                g[a] = np.linalg.solve(sub[a], rhs[a])
            except np.linalg.LinAlgError:
                g[a] = np.nan
    pivot = g[:, -1]
    ok = np.isfinite(pivot) & (pivot > 0)
    scale = np.where(ok, 1.0 / np.sqrt(np.where(ok, pivot, 1.0)), 0.0)
    g = g * scale[:, None]
    if not np.all(ok):
        bad = ~ok
        g[bad] = 0.0
        g[bad, -1] = 1.0 / np.sqrt(diag_fallback[bad])
    return g


def _build_g_host(A_sp, power: int) -> "Any":
    """Host FSAI setup: scipy CSR A → scipy CSR G (lower triangular)."""
    import scipy.sparse as sp

    n = A_sp.shape[0]
    indptr, indices = _lower_pattern(A_sp, power)
    row_len = np.diff(indptr)

    A_csr = A_sp.tocsr()
    A_csr.sum_duplicates()
    A_csr.sort_indices()
    a_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A_csr.indptr))
    keys = a_rows * n + A_csr.indices.astype(np.int64)
    data = A_csr.data.astype(np.float64)
    diag = A_csr.diagonal().astype(np.float64)
    if np.any(diag <= 0):
        raise ValueError(
            "fsai_preconditioner needs an SPD matrix; found a non-positive "
            f"diagonal entry (min diag = {diag.min()})"
        )

    g_flat = np.zeros(indptr[-1], dtype=np.float64)
    for k in np.unique(row_len):
        rows_k = np.nonzero(row_len == k)[0]
        k = int(k)
        # (m, k) column indices of each same-size pattern row
        cols = indices[(indptr[rows_k][:, None] + np.arange(k)[None, :])]
        chunk = max(1, _GATHER_CHUNK_ELEMS // (k * k))
        for lo in range(0, len(rows_k), chunk):
            sel = slice(lo, lo + chunk)
            sub = _gather_submatrices(keys, data, n, cols[sel])
            g = _solve_rows(sub, diag[rows_k[sel]])
            flat_idx = indptr[rows_k[sel]][:, None] + np.arange(k)[None, :]
            g_flat[flat_idx.ravel()] = g.ravel()

    return sp.csr_matrix((g_flat, indices, indptr.copy()), shape=(n, n))


def _device_operator(G_sp, layout: str, dtype, bm: int = 8, bn: int = 128,
                     device=DEFAULT_DEVICE):
    """scipy CSR → device operator in the requested (or auto-chosen) layout,
    as ``io.loader.load_matrix`` switches, minus the symmetric layouts (a
    triangular factor is never symmetric)."""
    from ..io.loader import choose_layout

    G_sp = G_sp.tocsr()
    G_sp.sum_duplicates()
    G_sp.sort_indices()
    data, indices, indptr = G_sp.data, G_sp.indices, G_sp.indptr
    shape = tuple(G_sp.shape)
    dt = as_numpy_dtype(dtype)
    if layout == "auto":
        layout = choose_layout(indices, indptr, shape, bm=bm, bn=bn)
    if layout == "csr":
        return CSRMatrix.from_arrays(data, indices, indptr, shape, dtype=dt, device=device)
    if layout == "sell":
        return SellMatrix.from_csr_host(data.astype(dt), indices, indptr, shape, device=device)
    if layout == "bell":
        return BlockedEllMatrix.from_csr_host(
            data.astype(dt), indices, indptr, shape, bm=bm, bn=bn, device=device
        )
    if layout == "dia":
        return DIAMatrix.from_csr_host(data.astype(dt), indices, indptr, shape, device=device)
    raise ValueError(
        f"unknown layout {layout!r} (want 'auto', 'csr', 'sell', 'bell' or 'dia')"
    )


def fsai_preconditioner(
    A: Any,
    power: int = 1,
    layout: str = "auto",
    dtype=None,
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the FSAI(power) preconditioner ``r ↦ Gᵀ (G r)`` for SPD ``A``.

    Args:
      A: assembled SPD matrix — CSRMatrix, scipy.sparse, or dense ndarray
        (matrix-free stencils have no pattern to mine — use
        multigrid_preconditioner there).
      power: sparsity pattern = tril(pattern(|A|^power)).  1 (default) is
        classic FSAI-0 on A's own lower triangle; 2 roughly squares the
        pattern for a stronger (costlier) factor.
      layout: device layout for G and Gᵀ ("auto" picks per pattern, like
        io.loader.load_matrix; the two factors are chosen independently).
      dtype: device dtype for the factors (default: A's dtype, or float32
        for inputs without one).
      device: where the factors live (default: A's device for a
        ``CSRMatrix``, else ``DEFAULT_DEVICE``).

    Returns the apply with the attributes ``G`` / ``Gt`` (device
    operators), ``G_host`` (the scipy CSR factor), ``nnz`` and ``power``.
    M⁻¹ = GᵀG is SPD by construction (G has a positive diagonal), so
    cg_solve's PCG theory applies.
    """
    from .amg import _to_scipy_csr

    if power < 1:
        raise ValueError(f"power must be >= 1, got {power}")
    if dtype is None:
        dtype = getattr(A, "dtype", None) or np.float32
    if device is None:
        device = A.device if isinstance(A, CSRMatrix) else DEFAULT_DEVICE
    A_sp = _to_scipy_csr(A)
    if A_sp.shape[0] != A_sp.shape[1]:
        raise ValueError(f"A must be square, got shape {A_sp.shape}")

    G_sp = _build_g_host(A_sp, power)
    G = _device_operator(G_sp, layout, dtype, device=device)
    Gt = _device_operator(G_sp.T.tocsr(), layout, dtype, device=device)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return Gt.matvec(G.matvec(r))

    apply.G = G
    apply.Gt = Gt
    apply.G_host = G_sp
    apply.nnz = int(G_sp.nnz)
    apply.power = power
    return apply
