"""Algebraic multigrid (smoothed aggregation) preconditioner.  Counterpart
of ``conjugategradient_tpu/solver/amg.py``: the same host setup, bit for
bit, and the same V-cycle on device tensors.

:func:`~.multigrid.multigrid_preconditioner` covers the matrix-free
regular grid; this module is its counterpart for assembled sparse SPD
operators, the reference's domain.  Smoothed aggregation (Vanek, Mandel,
Brezina) builds its hierarchy from the matrix graph alone:

* **Setup runs once on the host** (numpy and scipy.sparse): a symmetric
  strength graph, greedy aggregation (the native pass of
  ``native/amg_agg.cpp`` where the library is built, else the Python pass;
  both give the same aggregates), the tentative prolongator (piecewise
  constant, or the per-aggregate QR of a near-nullspace), one Jacobi
  smoothing pass ``P = (I - omega D^-1 A) P0``, the Galerkin coarse
  operators ``A_{l+1} = P^T A_l P``, down to a coarsest level that is
  inverted densely.
* **The apply runs on the device**: each level's operator is DIA where the
  level is banded and dense enough (``_level_operator``; on the card its
  products launch the DIA kernel), CSR otherwise (a sorted segmented sum);
  the transfers are CSR products with P^T and P, or a sorted segment sum
  and a gather over the aggregate map for the unsmoothed piecewise-constant
  P; the coarsest solve is one full-precision matmul with the dense
  inverse.  There is no host read in the apply.

Symmetry contract (a PCG requirement, tested): equal pre- and
post-smoothing, restriction = prolongation transpose, symmetric Galerkin
coarse operators, so the materialized M^-1 is symmetric positive definite
to roundoff.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.spmv import full_precision_matmul, segment_sum
from ..types import CSRMatrix, DIAMatrix
from ..types.base import DEFAULT_DEVICE, as_numpy_dtype
from .multigrid import _cheb_smooth_steps


def _to_scipy_csr(A: Any):
    import scipy.sparse as sp

    if isinstance(A, CSRMatrix):
        n, m = A.shape
        return sp.csr_matrix(
            (
                np.asarray(A.data.cpu().numpy(), dtype=np.float64),
                np.asarray(A.indices.cpu().numpy()),
                np.asarray(A.indptr.cpu().numpy()),
            ),
            shape=(n, m),
        )
    if sp.issparse(A):
        return A.tocsr().astype(np.float64)
    if isinstance(A, np.ndarray) and A.ndim == 2:
        return sp.csr_matrix(A.astype(np.float64))
    raise TypeError(
        "smoothed_aggregation_preconditioner needs an assembled sparse "
        f"matrix (CSRMatrix / scipy.sparse / dense ndarray), got "
        f"{type(A).__name__}; for matrix-free stencils use "
        "multigrid_preconditioner"
    )


def _strength_graph(A, theta: float):
    """Symmetric strength-of-connection filter: keep off-diagonal (i, j)
    with |a_ij| > theta * sqrt(a_ii * a_jj)."""
    import scipy.sparse as sp

    d = np.abs(A.diagonal())
    d_safe = np.where(d > 0, d, 1.0)
    C = sp.coo_matrix(A)
    mask = C.row != C.col
    scale = np.sqrt(d_safe[C.row] * d_safe[C.col])
    strong = mask & (np.abs(C.data) > theta * scale)
    S = sp.csr_matrix(
        (np.ones(strong.sum()), (C.row[strong], C.col[strong])), shape=A.shape
    )
    return S


def _aggregate(S) -> Tuple[np.ndarray, int]:
    """Greedy standard aggregation (Vanek pass 1-3) over the strength
    graph.  Returns (agg[i] = aggregate id, n_aggregates); every node is
    assigned (isolated nodes become singletons).

    Takes the native pass (native/amg_agg.cpp through ``io/native``) when
    the library is built, else :func:`_aggregate_py`; the two give the same
    aggregates (same visit order and tie-breaks; tests hold them equal)."""
    try:
        from ..io.native import amg_aggregate_native

        return amg_aggregate_native(S.indptr, S.indices, S.shape[0])
    except (RuntimeError, ImportError):
        pass
    return _aggregate_py(S)


def _aggregate_py(S) -> Tuple[np.ndarray, int]:
    """Pure-Python reference implementation of :func:`_aggregate`."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, dtype=np.int64)
    # pass 1: a node whose strong neighborhood is untouched seeds an
    # aggregate containing itself + all its strong neighbors
    next_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if len(nbrs) and np.all(agg[nbrs] == -1):
            agg[i] = next_agg
            agg[nbrs] = next_agg
            next_agg += 1
    # pass 2: attach leftovers to the aggregate of a strong neighbor
    # (first assigned one in column order)
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        assigned = nbrs[agg[nbrs] != -1] if len(nbrs) else nbrs
        if len(assigned):
            agg[i] = agg[assigned[0]]
    # pass 3: whatever remains (isolated / all-weak nodes) seeds singletons
    for i in range(n):
        if agg[i] == -1:
            agg[i] = next_agg
            next_agg += 1
    return agg, next_agg


def _rho_dinv_a_bound(A) -> float:
    """Gershgorin bound on rho(D^-1 A): max_i sum_j |a_ij| / a_ii."""
    d = np.abs(A.diagonal())
    d_safe = np.where(d > 0, d, 1.0)
    rowsum = np.abs(A).sum(axis=1).A1 if hasattr(np.abs(A).sum(axis=1), "A1") \
        else np.asarray(np.abs(A).sum(axis=1)).ravel()
    return float(np.max(rowsum / d_safe))


def _csr_device(A_sp, dtype, device) -> CSRMatrix:
    A_sp = A_sp.tocsr()
    A_sp.sum_duplicates()
    return CSRMatrix.from_arrays(
        A_sp.data, A_sp.indices, A_sp.indptr,
        tuple(A_sp.shape), dtype=as_numpy_dtype(dtype), device=device,
    )


def _level_layout(A_sp, max_diags: int = 96, min_density: float = 0.25) -> str:
    """"dia" when a level touches at most ``max_diags`` diagonals and fills
    at least ``min_density`` of them, else "csr" (``level_layout="auto"``).
    The aggregate numbering follows node order, so PDE-graph coarse levels
    stay banded and usually qualify too."""
    A_csr = A_sp.tocsr()
    n = A_csr.shape[0]
    if A_csr.shape[0] == A_csr.shape[1] and A_csr.nnz:
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(A_csr.indptr))
        nd = len(np.unique(A_csr.indices - row_ids))
        if nd <= max_diags and A_csr.nnz >= min_density * nd * n:
            return "dia"
    return "csr"


def _level_operator(A_sp, dtype, layout: str, device=DEFAULT_DEVICE):
    """Device operator for one AMG level: DIA where :func:`_level_layout`
    says so under ``layout="auto"`` (no index arrays and no gathers in the
    smoothing products; float32 on the card takes the DIA kernel), CSR
    otherwise."""
    if layout == "auto" and _level_layout(A_sp) == "dia":
        A_csr = A_sp.tocsr()
        return DIAMatrix.from_csr_host(
            A_csr.data, A_csr.indices, A_csr.indptr,
            tuple(A_csr.shape), dtype=as_numpy_dtype(dtype), device=device,
        )
    return _csr_device(A_sp, dtype, device)


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """The 6 rigid-body modes of a 3-D elastic body — the near-nullspace
    every elasticity stiffness matrix shares (3 translations + 3
    rotations about the centroid).  ``coords`` is (n_nodes, 3) node
    positions; dof ordering is node-major, dof-minor (the convention of
    problems.elasticity3d_coo).  Pass the result as
    ``smoothed_aggregation_preconditioner(..., near_nullspace=...)``.
    """
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be (n_nodes, 3), got {coords.shape}")
    c = coords - coords.mean(axis=0)
    nn = c.shape[0]
    B = np.zeros((3 * nn, 6))
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    B[0::3, 0] = 1.0  # translations
    B[1::3, 1] = 1.0
    B[2::3, 2] = 1.0
    B[1::3, 3] = -z   # rotation about x: (0, -z, y)
    B[2::3, 3] = y
    B[0::3, 4] = z    # rotation about y: (z, 0, -x)
    B[2::3, 4] = -x
    B[0::3, 5] = -y   # rotation about z: (-y, x, 0)
    B[1::3, 5] = x
    return B


def _block_condense(A_sp, bs: int):
    """Condense a dof matrix to its node graph: entry (p, q) = sum of
    |a_ij| over the bs x bs block — the strength proxy block-SA
    aggregation runs on (node-major, dof-minor ordering assumed)."""
    import scipy.sparse as sp

    C = A_sp.tocoo()
    nn = A_sp.shape[0] // bs
    M = sp.csr_matrix(
        (np.abs(C.data), (C.row // bs, C.col // bs)), shape=(nn, nn)
    )
    M.sum_duplicates()
    return M


def _tentative_prolongator(agg: np.ndarray, n_agg: int, B: np.ndarray):
    """Near-nullspace tentative prolongator (Vanek's block P0): per
    aggregate, the economy QR of B's rows on that aggregate — Q becomes
    the aggregate's P0 columns (locally orthonormal), R its rows of the
    COARSE near-nullspace, so ``P0 @ B_coarse == B`` exactly and the
    coarse level preserves the modes the smoother can't damp.

    Aggregates smaller than k keep only min(|agg|, k) columns (the QR
    rank), so coarse column counts vary per aggregate.  QR is batched
    per distinct aggregate size (np.linalg.qr over stacks) — no Python
    loop over aggregates.  Returns (P0 csr, B_coarse)."""
    import scipy.sparse as sp

    n, k = B.shape
    sizes = np.bincount(agg, minlength=n_agg)
    order = np.argsort(agg, kind="stable")  # rows grouped by aggregate
    starts = np.zeros(n_agg + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    k_a = np.minimum(sizes, k)              # columns kept per aggregate
    col_starts = np.zeros(n_agg + 1, dtype=np.int64)
    np.cumsum(k_a, out=col_starts[1:])
    n_coarse = int(col_starts[-1])
    B_coarse = np.zeros((n_coarse, k))

    rows_idx, cols_idx, vals = [], [], []
    for s in np.unique(sizes):
        if s == 0:
            continue
        aggs = np.flatnonzero(sizes == s)
        # (m, s) row indices of each size-s aggregate, in aggregate order
        rows = order[starts[aggs][:, None] + np.arange(s)]
        Q, R = np.linalg.qr(B[rows])        # batched: (m,s,kk), (m,kk,k)
        kk = min(int(s), k)
        B_coarse[col_starts[aggs][:, None] + np.arange(kk)] = R
        cols = col_starts[aggs][:, None, None] + np.arange(kk)[None, None]
        rows_idx.append(np.broadcast_to(rows[:, :, None], Q.shape).ravel())
        cols_idx.append(np.broadcast_to(cols, Q.shape).ravel())
        vals.append(Q.ravel())
    P0 = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows_idx), np.concatenate(cols_idx))),
        shape=(n, n_coarse),
    )
    return P0, B_coarse


def _build_hierarchy(
    A0,
    *,
    theta: float,
    smooth_prolongator: bool,
    coarse_size: int,
    max_levels: int,
    near_nullspace: Optional[np.ndarray] = None,
    blocksize: int = 1,
) -> Tuple[List[dict], Any]:
    """Host-side hierarchy construction.

    Returns ``(level_mats, A_coarse)``: per fine level a dict with the
    scipy CSR operator ``A``, the prolongator ``P`` actually used
    (smoothed or the tentative one), ``smoothed`` (whether P carries the
    Jacobi smoothing pass), ``csr_transfers`` (False only for the
    constant-vector unsmoothed case, where transfers may run as a pure
    gather/segment sum), and the aggregate map ``agg``/``n_agg``; plus
    the coarsest-level scipy CSR.

    ``near_nullspace`` (n x k, PyAMG's ``B``): algebraically smooth modes
    the hierarchy must preserve — the tentative prolongator becomes the
    per-aggregate QR of these modes (``rigid_body_modes`` for
    elasticity), and each coarse level inherits the R factors.  None
    keeps the classic piecewise-constant P0.

    ``blocksize`` (dofs per node, e.g. 3 for 3-D elasticity):
    strength-of-connection and aggregation run on the BLOCK-condensed
    node graph and node aggregates expand to their dofs.  Needed with a
    k-column near-nullspace: dof-level aggregates hold only a few dofs,
    too few for k columns each, so the hierarchy would barely coarsen;
    node aggregates hold bs * nodes dofs.  Coarse levels inherit
    blocksize=k while every aggregate kept the full k columns."""
    import scipy.sparse as sp

    B_l = None
    if near_nullspace is not None:
        B_l = np.asarray(near_nullspace, dtype=np.float64)
        if B_l.ndim == 1:
            B_l = B_l[:, None]
        if B_l.shape[0] != A0.shape[0]:
            raise ValueError(
                f"near_nullspace rows {B_l.shape[0]} != matrix size "
                f"{A0.shape[0]}")
        if not np.all(np.isfinite(B_l)):
            raise ValueError("near_nullspace must be finite")
    blocksize = int(blocksize)
    if blocksize < 1:
        raise ValueError(f"blocksize must be >= 1, got {blocksize}")
    if A0.shape[0] % blocksize:
        raise ValueError(
            f"matrix size {A0.shape[0]} not divisible by "
            f"blocksize {blocksize}")

    level_mats: List[dict] = []
    A_l = A0
    bs_l = blocksize
    for lvl in range(max_levels - 1):
        if A_l.shape[0] <= coarse_size:
            break
        # aggregation graph: the dof matrix, or its block-condensed node
        # graph (entry (p, q) = sum |a_ij| over the bs x bs block)
        if bs_l > 1 and A_l.shape[0] % bs_l == 0:
            G = _block_condense(A_l, bs_l)
        else:
            bs_l = 1
            G = A_l
        # Vanek's per-level theta decay: smoothed Galerkin coarse entries
        # spread and shrink, so a fixed theta empties the strength graph
        # a few levels down (singleton cascades)
        S = _strength_graph(G, theta * 0.5**lvl)
        agg, n_agg = _aggregate(S)
        if n_agg > 0.8 * G.shape[0]:
            # still stalled: keep EVERY off-diagonal (PyAMG's SA default
            # is theta=0 for exactly this robustness reason)
            S = _strength_graph(G, 0.0)
            agg, n_agg = _aggregate(S)
        if n_agg >= G.shape[0]:
            break  # no coarsening possible — stop here
        if bs_l > 1:
            agg = np.repeat(agg, bs_l)  # node aggregates -> their dofs
        if B_l is not None:
            P0, B_next = _tentative_prolongator(agg, n_agg, B_l)
            if P0.shape[1] >= A_l.shape[0]:
                break  # k columns per aggregate stopped shrinking the level
            # coarse dofs come k-per-aggregate; keep block aggregation
            # going while that structure is uniform
            bs_next = (B_l.shape[1]
                       if P0.shape[1] == n_agg * B_l.shape[1] else 1)
        else:
            B_next = None
            bs_next = 1
            P0 = sp.csr_matrix(
                (np.ones(A_l.shape[0]), (np.arange(A_l.shape[0]), agg)),
                shape=(A_l.shape[0], n_agg),
            )
        smooth_this = smooth_prolongator
        if smooth_this:
            rho = _rho_dinv_a_bound(A_l)
            d = A_l.diagonal()
            d_safe = np.where(np.abs(d) > 0, d, 1.0)
            Dinv = sp.diags(1.0 / d_safe)
            P = P0 - (4.0 / 3.0 / rho) * (Dinv @ (A_l @ P0))
        else:
            P = P0
        A_next = (P.T @ (A_l @ P)).tocsr()
        A_next.sum_duplicates()
        A_next.eliminate_zeros()
        if smooth_this and A_next.nnz > 2.5 * max(A_l.nnz, 1):
            # Densification guard: on scale-free/hub graphs the smoothed
            # prolongator spreads every hub row into its aggregate's
            # columns and the Galerkin product goes dense.  Fall back to
            # the unsmoothed (piecewise-constant) P for THIS level —
            # transfers become a pure gather/segment sum and the coarse
            # graph stays aggregate-sparse.
            smooth_this = False
            P = P0
            A_next = (P.T @ (A_l @ P)).tocsr()
            A_next.sum_duplicates()
            A_next.eliminate_zeros()
        level_mats.append({
            "A": A_l.tocsr(),
            "P": P.tocsr(),
            "smoothed": smooth_this,
            # the pure gather/segment-sum transfer shortcut is only valid
            # for the constant-vector P0 (one unit entry per row)
            "csr_transfers": smooth_this or B_l is not None,
            "agg": agg,
            "n_agg": n_agg,
        })
        A_l = A_next
        B_l = B_next
        bs_l = bs_next
    return level_mats, A_l.tocsr()


def _inv_diag_device(A_sp, omega: float, dtype, device=DEFAULT_DEVICE) -> torch.Tensor:
    d = A_sp.diagonal()
    return torch.as_tensor(omega / np.where(np.abs(d) > 0, d, 1.0), dtype=dtype,
                           device=device)


def _cheb_interval(A_sp, cheb_lower: float) -> Tuple[float, float]:
    """Chebyshev smoothing interval for one level: the polynomial targets
    eigenvalues of D^-1 A in [cheb_lower * rho, rho] with rho the
    Gershgorin bound — the standard SA-AMG choice (the coarse grid owns
    the low modes, the smoother the upper spectrum)."""
    rho = _rho_dinv_a_bound(A_sp)
    return cheb_lower * rho, rho


def _device_levels(level_mats, dtype, level_layout: str, omega: float,
                   smoother: str = "jacobi", cheb_lower: float = 1.0 / 6.0,
                   device=DEFAULT_DEVICE):
    """The host level matrices as the device entries the V-cycle closes
    over.  An unsmoothed piecewise-constant level keeps its aggregate map
    as a gather index (``agg``) and, for the restriction's segment sum,
    the rows sorted by aggregate (``order``, stable: each aggregate's rows
    in node order) with each aggregate's size (``sizes``)."""
    levels = []
    for m in level_mats:
        entry = {
            "A": _level_operator(m["A"], dtype, level_layout, device),
            "inv_diag": _inv_diag_device(m["A"], omega, dtype, device),
        }
        if smoother == "chebyshev":
            # raw 1/d (no omega damping — the polynomial owns the step
            # sizes) and the smoothing interval, fixed at build time
            entry["inv_diag_raw"] = _inv_diag_device(m["A"], 1.0, dtype, device)
            entry["cheb_ab"] = _cheb_interval(m["A"], cheb_lower)
        if m.get("csr_transfers", m["smoothed"]):
            entry["P"] = _csr_device(m["P"], dtype, device)
            entry["PT"] = _csr_device(m["P"].T.tocsr(), dtype, device)
        else:
            agg = m["agg"]
            entry["agg"] = torch.as_tensor(agg, dtype=torch.int64, device=device)
            entry["order"] = torch.as_tensor(np.argsort(agg, kind="stable"),
                                             dtype=torch.int64, device=device)
            entry["sizes"] = torch.as_tensor(np.bincount(agg, minlength=m["n_agg"]),
                                             dtype=torch.int64, device=device)
        levels.append(entry)
    return levels


def _make_cheb_smoothers(entry, nu: int):
    """Per-level Chebyshev pre/post smoothing closures.  The factors
    (I - alpha_k D^-1 A) all commute (polynomials in the same matrix),
    so equal-degree pre/post smoothing keeps the V-cycle symmetric — the
    PCG requirement — exactly like equal Jacobi sweep counts."""
    a, b = entry["cheb_ab"]
    step1, coeffs = _cheb_smooth_steps(a, b, nu)
    dinv = entry["inv_diag_raw"]
    A = entry["A"]

    def smooth_from_zero(b_vec):
        d = step1 * (dinv * b_vec)
        u = d
        for c_d, c_z in coeffs:
            z = dinv * (b_vec - A.matvec(u))
            d = c_d * d + c_z * z
            u = u + d
        return u

    def smooth(u, b_vec):
        z = dinv * (b_vec - A.matvec(u))
        d = step1 * z
        u = u + d
        for c_d, c_z in coeffs:
            z = dinv * (b_vec - A.matvec(u))
            d = c_d * d + c_z * z
            u = u + d
        return u

    return smooth_from_zero, smooth


def _coarse_solver(A_coarse_sp, *, dense_cap: int, dtype, level_layout: str,
                   omega: float, nu: int, device=DEFAULT_DEVICE):
    """Coarsest-level solve: the dense inverse when it fits ``dense_cap``,
    applied by one full-precision matmul; else damped-Jacobi sweeps
    (self-adjoint, so the cycle stays symmetric: the stalled-hierarchy
    fallback).  Returns ``(coarse_apply, coarse_residual, meta)``."""
    n_coarse = A_coarse_sp.shape[0]
    if n_coarse <= dense_cap:
        coarse_dense = A_coarse_sp.toarray()
        inv_coarse = torch.as_tensor(np.linalg.inv(coarse_dense), dtype=dtype, device=device)
        A_coarse = torch.as_tensor(coarse_dense, dtype=dtype, device=device)

        def coarse_apply(b):
            return torch.matmul(inv_coarse, b)

        def coarse_residual(b, z):
            return b - torch.matmul(A_coarse, z)

        meta = {"stalled": False, "n": n_coarse, "nnz": n_coarse * n_coarse}
        return coarse_apply, coarse_residual, meta

    # The graph refused to coarsen to dense size (slow-coarsening
    # scale-free patterns); a dense inverse would take O(n^2) memory, so
    # damped-Jacobi sweeps are the coarsest "solve" — a weaker
    # preconditioner that keeps the cycle symmetric.
    from ..utils.logging import get_logger

    get_logger().warning(
        "AMG hierarchy stalled at n=%d (> dense cap %d); using "
        "Jacobi sweeps as the coarsest solve", n_coarse, dense_cap,
    )
    coarse_jacobi = {
        "A": _level_operator(A_coarse_sp, dtype, level_layout, device),
        "inv_diag": _inv_diag_device(A_coarse_sp, omega, dtype, device),
    }

    def coarse_apply(b):
        u = coarse_jacobi["inv_diag"] * b
        for _ in range(2 * nu - 1):
            u = u + coarse_jacobi["inv_diag"] * (
                b - coarse_jacobi["A"].matvec(u)
            )
        return u

    def coarse_residual(b, z):
        return b - coarse_jacobi["A"].matvec(z)

    meta = {"stalled": True, "n": n_coarse,
            "nnz": int(coarse_jacobi["A"].nnz)}
    return coarse_apply, coarse_residual, meta


def _make_vcycle(levels, coarse_apply, nu: int, smoother: str = "jacobi"):
    """The V-cycle recursion over the device level entries."""

    if smoother == "chebyshev":
        cheb = [_make_cheb_smoothers(e, nu) for e in levels]

    def pre_smooth(l, entry, b):
        if smoother == "chebyshev":
            return cheb[l][0](b)
        u = entry["inv_diag"] * b  # first sweep from the zero guess
        for _ in range(nu - 1):
            u = u + entry["inv_diag"] * (b - entry["A"].matvec(u))
        return u

    def post_smooth(l, entry, u, b):
        if smoother == "chebyshev":
            return cheb[l][1](u, b)
        for _ in range(nu):
            u = u + entry["inv_diag"] * (b - entry["A"].matvec(u))
        return u

    def restrict(entry, r):
        if "PT" in entry:
            return entry["PT"].matvec(r)
        # sorted segments: each aggregate's rows summed in node order, with
        # no atomics (the result is the same on every run)
        return segment_sum(r.index_select(0, entry["order"]), entry["sizes"])

    def prolong(entry, e):
        if "P" in entry:
            return entry["P"].matvec(e)
        return e.index_select(0, entry["agg"])

    def v_cycle(l: int, b: torch.Tensor) -> torch.Tensor:
        if l == len(levels):
            return coarse_apply(b)
        entry = levels[l]
        u = pre_smooth(l, entry, b)
        r = b - entry["A"].matvec(u)
        e = v_cycle(l + 1, restrict(entry, r))
        u = u + prolong(entry, e)
        return post_smooth(l, entry, u, b)

    return v_cycle


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def smoothed_aggregation_preconditioner(
    A: Any,
    *,
    theta: float = 0.08,
    nu: int = 2,
    omega: float = 2.0 / 3.0,
    smooth_prolongator: bool = True,
    cycles: int = 1,
    coarse_size: int = 400,
    max_levels: int = 20,
    dense_cap: Optional[int] = None,
    level_layout: str = "auto",
    smoother: str = "jacobi",
    cheb_lower: float = 1.0 / 6.0,
    near_nullspace: Optional[np.ndarray] = None,
    blocksize: int = 1,
    dtype=None,
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``M^-1 r`` = ``cycles`` smoothed-aggregation AMG V-cycles.

    Args:
      A: assembled SPD operator — ``CSRMatrix``, ``scipy.sparse``, or a
        dense ndarray (setup converts to scipy CSR on the host).
      theta: strength threshold (|a_ij| > theta*sqrt(a_ii a_jj)); 0.08 is
        the usual smoothed-aggregation default — raise it toward 0.25 for
        anisotropic problems so weak cross-couplings don't pollute
        aggregates.
      nu: pre- AND post-smoothing damped-Jacobi sweeps (kept equal: the
        V-cycle must stay symmetric for PCG).
      omega: Jacobi damping relative to ``rho(D^-1 A) <= 2``; the classic
        2/3.
      smooth_prolongator: one Jacobi pass on the tentative piecewise-
        constant prolongator (``P = (I - omega_P D^-1 A) P0`` with
        ``omega_P = (4/3)/rho_bound``) — the "smoothed" in smoothed
        aggregation.  False gives plain (unsmoothed) aggregation: cheaper
        transfers (a gather and a segment sum, no P product) but
        iteration counts grow with problem size.
      cycles: V-cycles per apply.
      coarse_size: dense-solve threshold for the coarsest level.
      max_levels: hierarchy depth cap.
      dense_cap: largest coarsest level the dense inverse may take
        (default ``max(coarse_size, 4000)``); a hierarchy that stalls
        above it falls back to damped-Jacobi sweeps as the coarsest solve
        (self-adjoint, so the cycle stays symmetric) with a logged
        warning — slow-coarsening scale-free graphs hit this.
      level_layout: "auto" (default) stores each level's operator in the
        DIA layout when it is banded-dense enough (no gathers in the
        smoothing products); "csr" forces the CSR segmented sum
        everywhere.
      smoother: "jacobi" (default) — nu damped-Jacobi sweeps each side —
        or "chebyshev": the degree-``nu`` preconditioned Chebyshev
        semi-iteration on D^-1 A over [cheb_lower*rho, rho] (Gershgorin
        rho per level).  Same matvec count per sweep set, the minimax
        error polynomial over the upper spectrum (Adams, Brezina, Hu,
        Tuminaro).  The polynomial factors commute, so equal-degree
        pre/post smoothing keeps the cycle symmetric for PCG; ``omega`` is
        ignored.
      cheb_lower: lower end of the Chebyshev interval as a fraction of
        the Gershgorin bound (only read when smoother="chebyshev");
        default 1/6.
      near_nullspace: optional (n, k) algebraically smooth modes the
        hierarchy must preserve (PyAMG's ``B``) — the tentative
        prolongator becomes the per-aggregate QR of these modes and each
        coarse level inherits the R factors, so ``P @ B_coarse == B``
        exactly.  For elasticity pass :func:`rigid_body_modes` (k=6);
        None (default) keeps the piecewise-constant tentative
        prolongator.
      blocksize: dofs per node (3 for 3-D elasticity) — strength and
        aggregation run on the block-condensed NODE graph.  Needed with a
        k-column near_nullspace.
      dtype: device dtype of the apply (default: A's dtype for a
        ``CSRMatrix``, else ``torch.get_default_dtype()``, the counterpart
        of the JAX package's x64 switch).
      device: where the apply runs (default: A's device for a
        ``CSRMatrix``, else ``DEFAULT_DEVICE``).

    Returns an ``apply`` closure for ``cg_solve(..., M=apply)``, carrying
    ``n_levels``, ``level_sizes`` and ``operator_complexity``.  Setup is
    one host pass over the matrix per level (scipy triple products); reuse
    the closure across solves.

    Every stage is also defined for a nonsymmetric A (|a_ij|-based
    symmetrized strength, D^-1 A sweeps, Galerkin ``P^T A P``, a dense
    inverse at the coarsest level), so the cycle serves as a RIGHT
    preconditioner for ``gmres_solve``/``bicgstab_solve`` on mildly
    nonsymmetric systems.  The cycle is then itself nonsymmetric: do not
    hand it to ``cg_solve``/``minres_solve``.  As convection dominates,
    raise ``theta`` and/or set ``smooth_prolongator=False``.
    """
    if nu < 1:
        raise ValueError(f"nu must be >= 1, got {nu}")
    if cycles < 1:
        raise ValueError(f"cycles must be >= 1, got {cycles}")
    if not (0.0 < omega < 2.0):
        raise ValueError(f"omega must be in (0, 2), got {omega}")
    if level_layout not in ("auto", "csr"):
        raise ValueError(f"level_layout must be 'auto' or 'csr', got {level_layout!r}")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(
            f"smoother must be 'jacobi' or 'chebyshev', got {smoother!r}")
    if not (0.0 < cheb_lower < 1.0):
        raise ValueError(f"cheb_lower must be in (0, 1), got {cheb_lower}")
    if dtype is None:
        dtype = A.dtype if isinstance(A, CSRMatrix) else torch.get_default_dtype()
    dtype = _torch_dtype(dtype)
    if device is None:
        device = A.device if isinstance(A, CSRMatrix) else DEFAULT_DEVICE
    A0 = _to_scipy_csr(A)
    if A0.shape[0] != A0.shape[1]:
        raise ValueError(f"AMG needs a square operator, got {A0.shape}")

    # ---- host setup ------------------------------------------------------
    level_mats, A_coarse_sp = _build_hierarchy(
        A0, theta=theta, smooth_prolongator=smooth_prolongator,
        coarse_size=coarse_size, max_levels=max_levels,
        near_nullspace=near_nullspace, blocksize=blocksize,
    )
    if dense_cap is None:
        dense_cap = max(coarse_size, 4000)

    # ---- device apply ----------------------------------------------------
    full_precision_matmul()
    levels = _device_levels(level_mats, dtype, level_layout, omega,
                            smoother=smoother, cheb_lower=cheb_lower, device=device)
    coarse_apply, coarse_residual, coarse_meta = _coarse_solver(
        A_coarse_sp, dense_cap=dense_cap, dtype=dtype,
        level_layout=level_layout, omega=omega, nu=nu, device=device,
    )
    v_cycle = _make_vcycle(levels, coarse_apply, nu, smoother=smoother)

    def apply(rhs: torch.Tensor) -> torch.Tensor:
        z = v_cycle(0, rhs)
        for _ in range(cycles - 1):
            if levels:
                r = rhs - levels[0]["A"].matvec(z)
            else:
                r = coarse_residual(rhs, z)
            z = z + v_cycle(0, r)
        return z

    n_coarse = coarse_meta["n"]
    apply.n_levels = len(levels) + 1
    apply.level_sizes = tuple([lv["A"].shape[0] for lv in levels] + [n_coarse])
    coarse_nnz = coarse_meta["nnz"]
    apply.operator_complexity = float(
        sum(int(lv["A"].nnz) for lv in levels) + coarse_nnz
    ) / max(int(levels[0]["A"].nnz) if levels else coarse_nnz, 1)
    return apply
