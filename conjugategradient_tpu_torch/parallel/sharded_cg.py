"""Row-sharded CG and MINRES on blocked-ELL: the front end.  Counterpart of
the blocked-ELL single-RHS part of ``conjugategradient_tpu/parallel/
sharded_cg.py`` (``sharded_cg_solve`` and the solve core it configures).

Parallelization contract, as in the JAX package: each shard owns a
contiguous block of rows of A (blocked-ELL tiles with GLOBAL column
blocks, from :func:`~.partition.partition_csr_rows`) and the matching
slices of x, b, r and p; per iteration the SpMV reads the all-gathered
operand and the dots are summed over the shards (``collectives.py``).  The
shard group decides where the shards run: all on one device
(``make_row_mesh``), or one per process of a ``torch.distributed`` group.

Numerical semantics match solver/cg.py and solver/minres.py (and the
float64 oracle): recurrence residual, Hestenes–Stiefel α/β, termination on
the pre-update ‖r‖² against an absolute tol, the N+1 cap, optional Jacobi
preconditioning, optional residual replacement.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..solver.cg import FUSED_CHOICES, CGInfo
from .local_ops import _local_bell_matvec
from .loops import (
    _fused_shards_supported,
    _sharded_fused_cg,
    _sharded_fused_minres,
    _sharded_minres,
    _sharded_pcg,
)
from .partition import make_row_mesh

#: methods of the JAX front end that this package has not ported yet
QUEUED_METHODS = ("pipelined", "sstep", "bicgstab", "gmres")


def _resolve_single_rhs_method(method: str, recompute_r_every: int) -> None:
    """Validate the method and its restart setting (the JAX package's
    checks, for the methods this package runs)."""
    if method in QUEUED_METHODS:
        raise NotImplementedError(
            f"method={method!r} of the sharded solve is not ported yet "
            "(ROADMAP.md section 1, item 12); 'standard' and 'minres' are")
    if method not in ("standard", "minres"):
        raise ValueError(f"unknown method {method!r}")
    if method != "standard" and recompute_r_every:
        raise ValueError(
            f"method={method!r} has no residual-replacement variant "
            "(recompute_r_every must be 0)"
        )


def _solve_info(k, done, rho, rnorm, hist) -> CGInfo:
    return CGInfo(
        iterations=k,
        converged=done & ~torch.isnan(rnorm),
        rho=rho,
        rnorm_sq=rnorm,
        rho_history=hist,
    )


def _sharded_solve(group, blocks, block_cols, b, x0, *, tol, maxiter, inv_diag,
                   fused: bool, method: str, recompute_r_every: int):
    """The solve core, on the OWNED shards: ``blocks`` (n_own, nrb, kmax,
    bm, bn), ``block_cols`` (n_own, nrb, kmax) and the owned rows of the
    vectors (n_own · m); one loop, then x gathered whole."""
    n_own = int(blocks.shape[0])
    m = int(b.shape[0]) // n_own
    bn = int(blocks.shape[-1])
    maxiter = int(group.n_shards * m + 1 if maxiter is None else maxiter)

    def slices(v):
        return None if v is None else [v[i * m:(i + 1) * m] for i in range(n_own)]

    blocks_l = [blocks[i] for i in range(n_own)]
    cols_l = [block_cols[i] for i in range(n_own)]
    b_l, d_l = slices(b), slices(inv_diag)
    x0_l = slices(torch.zeros_like(b) if x0 is None else x0)
    if fused:
        loop = _sharded_fused_minres if method == "minres" else _sharded_fused_cg
        x_l, k, done, rho, rnorm, hist = loop(group, blocks_l, cols_l, b_l, x0_l, tol,
                                              maxiter, bn, inv_diag=d_l)
    else:
        def matvec(i, v_full):
            return _local_bell_matvec(blocks_l[i], cols_l[i], v_full.reshape(-1, bn))

        if method == "minres":
            x_l, k, done, rho, rnorm, hist = _sharded_minres(
                group, matvec, b_l, x0_l, d_l, tol, maxiter)
        else:
            x_l, k, done, rho, rnorm, hist = _sharded_pcg(
                group, matvec, b_l, x0_l, d_l, tol, maxiter, recompute_r_every)
    return group.all_gather(x_l), _solve_info(k, done, rho, rnorm, hist)


def sharded_cg_solve(
    blocks,
    block_cols,
    b,
    x0=None,
    *,
    mesh=None,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    use_fused: str = "auto",
    method: str = "standard",
    recompute_r_every: int = 0,
):
    """Row-sharded (P)CG, or MINRES, over a shard group, blocked-ELL
    operator.

    Args:
      blocks: (n_shards, nrb, kmax, bm, bn) per-shard blocked-ELL tiles
        (from :func:`~.partition.partition_csr_rows`), a tensor or numpy.
      block_cols: (n_shards, nrb, kmax) global column-block ids.
      b: (n_padded,) global right-hand side (zero on the padding rows).
      x0: optional (n_padded,) start; zero by default.
      mesh: the shard group (``make_row_mesh(n, device)``, or a
        ``DistributedGroup``); None runs every shard in this process on
        ``types.base.DEFAULT_DEVICE``.  Only the shards the group owns
        (and their rows of b, x0, inv_diag) go to its device.
      tol: ABSOLUTE tolerance on ‖r‖ (CG) or on the estimate φ̄ (MINRES).
      maxiter: iteration cap; None means n_padded + 1.
      inv_diag: optional (n_padded,) 1/diag(A) for Jacobi PCG (1 on the
        padding rows, to stay inert); MINRES needs it positive.
      use_fused: "auto" runs each shard's iteration on the fused kernels
        (``bell_spmv_dot`` with ``fused_update_dot(_pcg)``, or
        ``minres_shard_spmv_dot`` with ``minres_update_dot``; float32, M
        None or Jacobi) when the operator qualifies
        (``loops._fused_shards_supported``: square tiles, bn and the rows
        per shard multiples of 128, float32, kmax <= 64, on a CUDA device);
        "always" runs them anyway (on CPU tensors: their plain versions,
        the parity path of the tests); "never" runs the portable loop.
      method: "standard" ((P)CG, two psum rounds per iteration) or "minres"
        (symmetric, possibly indefinite A; ``rho_history`` holds φ̄²).
      recompute_r_every: if > 0, replace the recurrence residual with the
        true one AND reset the direction every that many iterations
        (standard method, portable loop only).

    Returns (x, CGInfo); x is the (n_padded,) global solution.
    """
    if use_fused not in FUSED_CHOICES:
        raise ValueError(f"use_fused must be one of {FUSED_CHOICES}, got {use_fused!r}")
    recompute_r_every = int(recompute_r_every)
    _resolve_single_rhs_method(method, recompute_r_every)
    if use_fused == "always" and recompute_r_every:
        raise ValueError(
            "use_fused='always' has no residual-replacement variant — "
            "restarts run the per-shard portable loop (recompute_r_every=0 "
            "to force fused)"
        )
    group = mesh if mesh is not None else make_row_mesh(len(blocks))
    n_shards, nrb, _, bm, _ = blocks.shape
    if n_shards != group.n_shards:
        raise ValueError(f"blocks hold {n_shards} shards, the group {group.n_shards}")
    m = nrb * bm
    if b.shape[0] != n_shards * m:
        raise ValueError(f"b has {b.shape[0]} rows, the shards {n_shards} x {m}")
    # only the shards this process owns go to its device
    lo, hi = group.shards[0], group.shards[-1] + 1
    if tuple(group.shards) != tuple(range(lo, hi)):
        raise ValueError(f"a group must own consecutive shards, got {group.shards}")
    dev = group.device

    def own(v, rows=m):
        return None if v is None else torch.as_tensor(v[lo * rows:hi * rows], device=dev)

    blocks, block_cols = own(blocks, 1), own(block_cols, 1).to(torch.int32)
    b, x0, inv_diag = own(b), own(x0), own(inv_diag)
    fused = (
        not recompute_r_every
        and (use_fused == "always"
             or (use_fused == "auto" and _fused_shards_supported(blocks, b)))
    )
    return _sharded_solve(group, blocks, block_cols, b, x0, tol=tol, maxiter=maxiter,
                          inv_diag=inv_diag, fused=fused, method=method,
                          recompute_r_every=recompute_r_every)
