"""Row-sharded LOBPCG, the distributed preconditioned block eigensolver.
Counterpart of ``conjugategradient_tpu/parallel/sharded_lobpcg.py``.

Each shard owns a contiguous row block of A (blocked-ELL tiles from
:func:`~.partition.partition_csr_rows`) and the matching (m, ·) slabs of
the X, W and P blocks.  An iteration's collectives:

* ONE all_gather of the (m, 3k) search block for the block product, the
  tile stream read once for all 3k columns (``_local_bell_matvec_multi``,
  plain on every device as the JAX form is XLA);
* the (3k)² Gram blocks summed over the shards: the tall-skinny QR is the
  JAX package's **CholQR²** (Gram, Cholesky with a ridge of eps·tr(G),
  triangular solve, twice), and the Rayleigh–Ritz projection QᵀAQ is the
  same sum; the one-card LOBPCG takes a Householder QR instead;
* the (k,) residual norms' sum.

Everything (3k)² — the Cholesky factors, ``eigh``, the coefficient solves —
is computed from the summed blocks, once a process (in an in-process group
once for all its shards, the bits of each process of a
``DistributedGroup`` computing it alone).

Padded rows are kept EXACTLY zero in X, W and P by a per-shard mask, so the
Gram and projection matrices, and the Ritz values, are those of the true
n × n operator.  The loop is masked steps under ``restart.run_chunked``,
as the one-card LOBPCG's; a Cholesky that fails or an ``eigh`` of a
non-finite matrix gives NaN (the JAX functions return NaN where torch's
raise), so NaN in gives NaN out and the loop runs to its cap.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..ops.spmv import full_precision_matmul
from ..solver.eigs import DEFAULT_RTOL, EigsResult
from ..solver.lobpcg import _finite_eigh
from ..solver.restart import run_chunked
from .local_ops import _local_bell_matvec_multi
from .partition import make_row_mesh
from .sharded_cg import _local_precond, _owned_rows, _split

__all__ = ["sharded_lobpcg_eigs"]


def _chol_qr(group, Ss, ridge: float):
    """One CholQR pass over the row-sharded tall-skinny block: G = Σ SᵀS
    over the shards, the ridge ``ridge·tr(G)`` on its diagonal (CholQR's
    collapsed directions keep a finite factor; the second pass restores
    orthonormality), Qᵢ = Sᵢ L⁻ᵀ on each shard."""
    G = group.psum([S.T @ S for S in Ss])
    m = G.shape[0]
    G = 0.5 * (G + G.T) + ridge * torch.trace(G) * torch.eye(m, dtype=G.dtype,
                                                             device=G.device)
    L, info = torch.linalg.cholesky_ex(G)
    L = torch.where(info != 0, torch.tril(torch.full_like(L, float("nan"))), L)
    return [torch.linalg.solve_triangular(L, S.T, upper=False).T for S in Ss]


def sharded_lobpcg_eigs(
    blocks,
    block_cols,
    k: int = 4,
    *,
    n: int,
    mesh=None,
    axis: str = "rows",
    M_local: Optional[Any] = None,
    which: str = "smallest",
    X0=None,
    tol: float = DEFAULT_RTOL,
    maxiter: int = 100,
    seed: int = 0,
    tol_absolute: bool = False,
) -> EigsResult:
    """k extreme eigenpairs of a row-sharded SPD operator by LOBPCG.

    Args:
      blocks / block_cols: per-shard tiles from
        :func:`~.partition.partition_csr_rows` (leading shard axis).
      k: the block size, the number of pairs; needs ``3k <= n``.
      n: the TRUE size (before padding), so the padded rows are masked out
        of the search space.
      mesh: the shard group (``make_row_mesh(n, device)`` or a
        ``DistributedGroup``); None: every shard on the default device.
        ``axis`` is accepted as the JAX signature has it and not read.
      M_local: a per-shard preconditioner ``r_local -> z_local`` or a
        ``ShardedPreconditioner`` (AMG, FSAI), the objects the sharded
        linear solves take; applied column by column.
      which: ``"smallest"`` or ``"largest"``.
      X0: optional (n_padded, k) start (else drawn from
        ``np.random.default_rng(seed)``, as the JAX function draws it, so
        both packages start from the same block); P0 is drawn after it.
        The padded rows are zeroed either way.
      tol: pair i converges when ‖A xᵢ − λᵢ xᵢ‖ ≤ tol·θ_max (relative) or
        ≤ tol (``tol_absolute=True``).
      maxiter: the iteration cap.

    Returns :class:`~conjugategradient_tpu_torch.solver.eigs.EigsResult`;
    ``vectors`` is the whole (n_padded, k) Ritz block (rows past ``n``
    zero).
    """
    del axis
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be 'smallest' or 'largest', got {which!r}")
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    if maxiter < 1:
        raise ValueError(f"need maxiter >= 1, got {maxiter}")
    if 3 * k > n:
        raise ValueError(f"LOBPCG needs 3k <= n (basis [X, W, P]); got k={k}, n={n}")
    n_shards = int(blocks.shape[0])
    group = mesh if mesh is not None else make_row_mesh(n_shards)
    if n_shards != group.n_shards:
        raise ValueError(f"blocks has {n_shards} shards, mesh has {group.n_shards}")
    bn = int(blocks.shape[-1])
    nrb, bm = int(blocks.shape[1]), int(blocks.shape[-2])
    m_rows = nrb * bm
    n_padded = m_rows * n_shards
    if not (n <= n_padded):
        raise ValueError(f"n={n} exceeds the padded dimension {n_padded}")
    blocks_t = torch.as_tensor(blocks)
    dt = torch.promote_types(blocks_t.dtype, torch.float32)
    np_dt = torch.empty((), dtype=dt).numpy().dtype

    rng = np.random.default_rng(seed)
    if X0 is None:
        X0 = rng.standard_normal((n_padded, k)).astype(np_dt)
    else:
        X0 = np.asarray(X0.detach().cpu() if isinstance(X0, torch.Tensor) else X0).astype(np_dt)
        if X0.shape != (n_padded, k):
            raise ValueError(f"X0 must have shape ({n_padded}, {k}), got {X0.shape}")
    P0 = rng.standard_normal((n_padded, k)).astype(np_dt)
    row_mask = (np.arange(n_padded) < n).astype(np_dt)
    X0 = X0 * row_mask[:, None]
    P0 = P0 * row_mask[:, None]

    full_precision_matmul()
    dev = group.device
    n_own = len(group.shards)
    own_rows, _ = _owned_rows(group, n_padded, "X0")

    def slabs(V):
        return _split(own_rows(V), m_rows)

    blocks_s = own_rows(blocks_t, 1)
    cols_s = own_rows(torch.as_tensor(block_cols).to(torch.int32), 1)
    masks = [mk[:, None] for mk in slabs(row_mask)]
    m_fn = _local_precond(M_local, group, own_rows) if M_local is not None else None

    eps = float(torch.finfo(dt).eps)
    tiny = torch.tensor(torch.finfo(dt).tiny ** 0.5, dtype=dt, device=dev)
    tol_t = torch.tensor(tol, dtype=dt, device=dev)
    largest = which == "largest"

    def a_mv(Vs):  # [(m, R)] -> [(m, R)]
        R = Vs[0].shape[-1]
        full = group.all_gather(Vs).reshape(-1, bn, R)
        return [_local_bell_matvec_multi(blocks_s[i], cols_s[i], full).to(dt)
                for i in range(n_own)]

    def m_apply(Rs):
        if m_fn is None:
            return Rs
        cols = [m_fn([R[:, j].contiguous() for R in Rs]) for j in range(k)]
        return [torch.stack([c[i] for c in cols], dim=1).to(dt) * masks[i]
                for i in range(n_own)]

    def col_norms(Vs):
        return torch.sqrt(group.psum([torch.sum(V * V, dim=0) for V in Vs]))

    def normalize(Vs):
        nrm = torch.maximum(col_norms(Vs), tiny)[None, :]
        return [V / nrm for V in Vs]

    def select(w, C):
        if largest:
            return w[-k:].flip(0), C[:, -k:].flip(1)
        return w[:k], C[:, :k]

    def ritz(Qs):
        AQ = a_mv(Qs)
        T = group.psum([Q.T @ A for Q, A in zip(Qs, AQ)])
        w, C = _finite_eigh(0.5 * (T + T.T))
        lam, Cx = select(w, C)
        X = [Q @ Cx for Q in Qs]
        R = [A @ Cx - x * lam[None, :] for A, x in zip(AQ, X)]
        return lam, Cx, X, R, col_norms(R), torch.abs(w).max()

    def scale_of(theta):
        return torch.ones((), dtype=dt, device=dev) if tol_absolute else theta

    # the initial Rayleigh–Ritz on span(X0)
    Xq = _chol_qr(group, _chol_qr(group, slabs(X0), eps), eps)
    lam, _, X, R, rn, wmax = ritz(Xq)
    box = {"X": X, "P": [p * mk for p, mk in zip(slabs(P0), masks)], "lam": lam, "R": R,
           "rn": rn, "theta": torch.maximum(wmax, tiny),
           "it": torch.zeros((), dtype=torch.int32, device=dev)}

    def live():
        return (box["it"] < maxiter) & ~torch.all(box["rn"] <= tol_t * scale_of(box["theta"]))

    def step():
        c = box
        on = live()
        W = normalize(m_apply(c["R"]))
        P = normalize(c["P"])
        S = [torch.cat([x, w, p], dim=1) for x, w, p in zip(c["X"], W, P)]
        Q = _chol_qr(group, _chol_qr(group, S, eps), eps)
        lam_new, Cx, X_new, R_new, rn_new, wmax = ritz(Q)
        Cp = Cx.clone()
        Cp[:k] = 0
        P_new = [q @ Cp for q in Q]
        for key, new in (("lam", lam_new), ("rn", rn_new),
                         ("theta", torch.maximum(c["theta"], wmax))):
            c[key] = torch.where(on, new, c[key])
        for key, new in (("X", X_new), ("P", P_new), ("R", R_new)):
            c[key] = [torch.where(on, a, b) for a, b in zip(new, c[key])]
        c["it"] = c["it"] + on.to(torch.int32)

    run_chunked(step, live, maxiter, done=lambda: ~live())
    lam_np = box["lam"].double().cpu().numpy()
    rn_np = box["rn"].double().cpu().numpy()
    scale = 1.0 if tol_absolute else max(float(box["theta"]), 1e-300)
    return EigsResult(values=lam_np, vectors=group.assemble(box["X"]).reshape(n_padded, k),
                      residuals=rn_np, converged=rn_np <= float(tol) * scale,
                      iters=int(box["it"]))
