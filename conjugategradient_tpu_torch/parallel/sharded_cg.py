"""Row-sharded solves: the one solve core and the layout front ends.
Counterpart of the single-RHS part of ``conjugategradient_tpu/parallel/
sharded_cg.py``: :func:`_sharded_solve`, which every layout configures, and
its five 1-D front ends — blocked-ELL, symmetric blocked-ELL, DIA,
symmetric DIA and SELL.

Parallelization contract, as in the JAX package: each shard owns a
contiguous block of rows of A and the matching slices of x, b, r and p;
per iteration the local SpMV reads either the all-gathered operand
(blocked-ELL and SELL, whose column footprint may span every shard; the
symmetric blocked-ELL's cross-shard tiles) or a ring halo of the
bandwidth (DIA and symmetric DIA), and the dots are summed over the shards
(``collectives.py``).  The shard group decides where the shards run: all on
one device (``make_row_mesh``), or one per process of a
``torch.distributed`` group; only the shards a process owns (operator
arrays and vector rows) go to its device.

Methods (``method=``), as the JAX core dispatches them: ``"standard"``
((P)CG, with residual replacement), ``"minres"``, ``"pipelined"`` (one psum
an iteration; Ghysels–Vanroose with a preconditioner), ``"sstep"`` (one
Gram psum per s iterations, unpreconditioned), ``"bicgstab"`` and
``"gmres"`` (nonsymmetric systems; GMRES right-preconditioned, FGMRES with
``gmres_flexible``), and the deflated (P)CG behind ``basis=``.
Preconditioners: ``inv_diag`` (Jacobi) or ``M_local`` (a per-shard apply,
or a :class:`ShardedPreconditioner` whose arrays are row-sharded like the
operator's).  The blocked-ELL front end also runs CG, Jacobi PCG and MINRES
on the fused kernels 6 and 17 (``fused_fn``).

Numerical semantics match the one-device solvers (and the float64 oracle):
recurrence residual, Hestenes–Stiefel α/β, termination on the pre-update
‖r‖² against an absolute tol, the N+1 cap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..solver.cg import FUSED_CHOICES, CGInfo
from ..solver.sstep import _default_rcond as _sstep_default_rcond
from .local_ops import (
    _local_bell_matvec,
    _local_dia_matvec,
    _local_sell_matvec,
    _local_symbell_matvec,
    _local_symdia_matvec,
    _make_dia_mpk_basis,
    _symdia_left_halo,
)
from .loops import (
    _fused_shards_supported,
    _sharded_bicgstab,
    _sharded_deflated_pcg,
    _sharded_fused_cg,
    _sharded_fused_minres,
    _sharded_gmres,
    _sharded_minres,
    _sharded_pcg,
    _sharded_pipelined,
    _sharded_sstep_cg,
)
from .partition import make_row_mesh

METHODS = ("standard", "pipelined", "sstep", "minres", "bicgstab", "gmres")


@dataclasses.dataclass(eq=False)
class ShardedPreconditioner:
    """A per-shard ``M⁻¹`` apply whose OPERATOR DATA is row-sharded.

    ``op_arrays``: host or device arrays; those marked ``"sharded"`` in
    ``op_specs`` (the default for all) have a leading shard axis and each
    process gets only its owned shards' slices, those marked
    ``"replicated"`` go whole to every shard.  ``make_local_apply(arrays)``
    builds one shard's apply ``r_local -> z_local`` from its arrays (the
    sharded ones with the shard axis indexed away); it is called once per
    owned shard and solve.  The JAX class also carries a compile-cache
    token, which this package, compiling nothing, has no use for.
    """

    op_arrays: tuple
    make_local_apply: Callable
    op_specs: Optional[tuple] = None


def _local_precond(M_local, group, own_rows) -> Callable:
    """``M_local`` as the loops' preconditioner: the owned shards' vectors
    in, M⁻¹ applied to each out."""
    if isinstance(M_local, ShardedPreconditioner):
        specs = M_local.op_specs or ("sharded",) * len(M_local.op_arrays)
        for spec in specs:
            if spec not in ("sharded", "replicated"):
                raise ValueError(f"op_specs entries are 'sharded' or 'replicated', got {spec!r}")
        arrays = [own_rows(a, 1) if spec == "sharded"
                  else torch.as_tensor(a, device=group.device)
                  for a, spec in zip(M_local.op_arrays, specs)]
        applies = [M_local.make_local_apply([a[i] if spec == "sharded" else a
                                             for a, spec in zip(arrays, specs)])
                   for i in range(len(group.shards))]
        return lambda vs: [f(v) for f, v in zip(applies, vs)]
    if callable(M_local):
        return lambda vs: [M_local(v) for v in vs]
    raise TypeError("M_local must be a callable (r_local -> z_local) or a "
                    f"ShardedPreconditioner, got {type(M_local).__name__}")


def _resolve_single_rhs_method(method, with_m, recompute_r_every, s, rcond, dtype):
    """Validate the method and its settings (the JAX package's checks), and
    return the s-step block size and cutoff (inert constants for the other
    methods)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method == "sstep" and with_m:
        raise ValueError(f"method={method!r} is unpreconditioned (inv_diag=None)")
    if method not in ("standard", "pipelined") and recompute_r_every:
        raise ValueError(
            f"method={method!r} has no residual-replacement variant "
            "(recompute_r_every must be 0)"
        )
    if method != "sstep":
        return 0, 0.0
    s = int(s)
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    return s, (_sstep_default_rcond(dtype) if rcond is None else float(rcond))


def shard_deflation_basis(basis, n_padded: int, n_shards: int):
    """Row-shard a ``solver/deflated.DeflationBasis`` for the sharded loops.

    Returns ``(W_sh (S, m, k), AW_sh (S, m, k), E_chol (k, k))``: the
    tall-skinny factors split like every other vector (zero padding rows
    are inert in both products) as numpy, the k×k Cholesky factor, which
    every shard holds whole, as the basis keeps it."""
    W = basis.W.detach().cpu().numpy() if isinstance(basis.W, torch.Tensor) else np.asarray(basis.W)
    AW = (basis.AW.detach().cpu().numpy() if isinstance(basis.AW, torch.Tensor)
          else np.asarray(basis.AW))
    n, k = W.shape
    m = n_padded // n_shards
    Wp = np.zeros((n_padded, k), W.dtype)
    Wp[:n] = W
    AWp = np.zeros((n_padded, k), AW.dtype)
    AWp[:n] = AW
    return Wp.reshape(n_shards, m, k), AWp.reshape(n_shards, m, k), basis.E_chol


def _solve_info(k, done, rho, rnorm, hist) -> CGInfo:
    return CGInfo(
        iterations=k,
        converged=done & ~torch.isnan(rnorm),
        rho=rho,
        rnorm_sq=rnorm,
        rho_history=hist,
    )


# ---- the generic single-RHS core -------------------------------------------------

def _sharded_solve(
    family: str,
    op_arrays: Sequence,
    b,
    x0=None,
    *,
    mesh,
    tol: float,
    maxiter: Optional[int],
    inv_diag,
    make_local_matvec: Callable,
    method: str = "standard",
    recompute_r_every: int = 0,
    s: int = 4,
    rcond: Optional[float] = None,
    gmres_restart: int = 30,
    gmres_flexible: bool = False,
    basis=None,
    supports_basis: bool = True,
    fused_fn: Optional[Callable] = None,
    sstep_basis_factory: Optional[Callable] = None,
    M_local=None,
):
    """The ONE sharded single-RHS solve core every layout configures.

    A layout supplies ``op_arrays`` (leading shard axis) and
    ``make_local_matvec(group, op_shards) -> local_matvec``, whose closure
    may compute loop-invariant collectives (the symmetric-DIA diagonal
    halo) and issues the per-application ones (all_gather, ring halo).
    ``op_shards`` are the owned shards' arrays on the group's device, each
    with the owned shards on its leading axis.  Optional hooks:
    ``fused_fn(group, op_shards, b, x0, inv_diag, tol, maxiter)`` replaces
    the whole per-shard loop (the blocked-ELL kernels 6 and 17);
    ``sstep_basis_factory(group, op_shards)`` supplies a matrix-powers basis
    for ``method="sstep"`` (the DIA ring one).  The method, preconditioner,
    restart and deflation checks live here, so every front end enforces
    the same semantics.
    """
    group = mesh
    n_padded = int(b.shape[0])
    n_shards = group.n_shards
    if n_padded % n_shards:
        raise ValueError(f"b has {n_padded} rows, not a multiple of {n_shards} shards")
    maxiter = int(n_padded + 1 if maxiter is None else maxiter)
    with_m = inv_diag is not None
    if M_local is not None:
        if with_m:
            raise ValueError("pass either inv_diag or M_local, not both")
        if method not in ("standard", "minres", "pipelined", "bicgstab", "gmres"):
            raise ValueError(
                "M_local runs the standard, minres, pipelined, bicgstab, "
                f"or gmres per-shard loop (method={method!r})")
        if basis is not None:
            raise ValueError("M_local and basis= (deflation) are exclusive")
        if fused_fn is not None:
            raise ValueError("the fused per-shard loop has no general-M variant — "
                             "disable it when M_local is set")
    recompute_r_every = int(recompute_r_every)
    s_eff, rcond_eff = _resolve_single_rhs_method(
        method, with_m, recompute_r_every, s, rcond, torch.as_tensor(b[:1]).dtype)
    if basis is not None:
        if not supports_basis:
            raise ValueError(f"the {family} front-end has no deflated (basis=) variant")
        if method != "standard" or recompute_r_every:
            raise ValueError(
                "deflation (basis=) runs the standard per-shard loop "
                "(no method=pipelined/sstep, no recompute_r_every)")

    # only the shards this process owns go to its device
    m = n_padded // n_shards
    lo, hi = group.shards[0], group.shards[-1] + 1
    if tuple(group.shards) != tuple(range(lo, hi)):
        raise ValueError(f"a group must own consecutive shards, got {group.shards}")
    dev = group.device

    def own(v, rows=m):
        return None if v is None else torch.as_tensor(v[lo * rows:hi * rows], device=dev)

    op_shards = [own(a, 1) for a in op_arrays]
    precond = own(inv_diag)
    if M_local is not None:
        precond = _local_precond(M_local, group, own)
    deflation = None
    if basis is not None:
        W_sh, AW_sh, E_chol = shard_deflation_basis(basis, n_padded, n_shards)
        deflation = (own(W_sh, 1), own(AW_sh, 1), torch.as_tensor(E_chol, device=dev))
    gmres_m = max(1, min(int(gmres_restart), maxiter, n_padded)) if method == "gmres" else 0
    return _owned_solve(
        group, op_shards, own(b), own(x0), precond, tol=tol, maxiter=maxiter,
        make_local_matvec=make_local_matvec, method=method,
        recompute_r_every=recompute_r_every, s=s_eff, rcond=rcond_eff, gmres_m=gmres_m,
        gmres_flexible=bool(gmres_flexible), deflation=deflation, fused_fn=fused_fn,
        sstep_basis_factory=sstep_basis_factory)


def _owned_solve(group, op_shards, b, x0, precond, *, tol, maxiter, make_local_matvec,
                 method, recompute_r_every, s, rcond, gmres_m, gmres_flexible, deflation,
                 fused_fn, sstep_basis_factory):
    """The dispatch on the OWNED shards: ``b``, ``x0`` and a Jacobi
    ``precond`` hold the owned rows (n_own · m); one loop, then x gathered
    whole."""
    n_own = len(group.shards)
    m = int(b.shape[0]) // n_own

    def slices(v):
        return None if v is None else [v[i * m:(i + 1) * m] for i in range(n_own)]

    b_l = slices(b)
    x0_l = slices(torch.zeros_like(b) if x0 is None else x0)
    pre = precond if callable(precond) else slices(precond)
    if fused_fn is not None:
        out = fused_fn(group, op_shards, b_l, x0_l, pre, tol, maxiter)
    else:
        apply = make_local_matvec(group, op_shards)
        if deflation is not None:
            W, AW, E_chol = deflation
            out = _sharded_deflated_pcg(group, apply, b_l, x0_l, pre, list(W), list(AW),
                                        E_chol, tol, maxiter)
        elif method == "minres":
            out = _sharded_minres(group, apply, b_l, x0_l, pre, tol, maxiter)
        elif method == "bicgstab":
            out = _sharded_bicgstab(group, apply, b_l, x0_l, pre, tol, maxiter)
        elif method == "gmres":
            out = _sharded_gmres(group, apply, b_l, x0_l, pre, tol, maxiter, gmres_m,
                                 flexible=gmres_flexible)
        elif method == "pipelined":
            out = _sharded_pipelined(group, apply, b_l, x0_l, pre, tol, maxiter,
                                     recompute_r_every)
        elif method == "sstep":
            basis_fn = (sstep_basis_factory(group, op_shards)
                        if sstep_basis_factory is not None else None)
            out = _sharded_sstep_cg(group, apply, b_l, x0_l, tol, maxiter, s, rcond,
                                    basis_fn=basis_fn)
        else:
            out = _sharded_pcg(group, apply, b_l, x0_l, pre, tol, maxiter, recompute_r_every)
    x_l, k, done, rho, rnorm, hist = out
    return group.all_gather(x_l), _solve_info(k, done, rho, rnorm, hist)


def _group_for(mesh, n_shards: int):
    group = mesh if mesh is not None else make_row_mesh(n_shards)
    if n_shards != group.n_shards:
        raise ValueError(f"the operator holds {n_shards} shards, the group {group.n_shards}")
    return group


def _gathered(group, vs, bn=None):
    full = group.all_gather(vs)
    return full if bn is None else full.reshape(-1, bn)


# ---- layout front ends (thin configurations of _sharded_solve) -----------------------

def sharded_cg_solve(
    blocks,
    block_cols,
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    ncols_padded: Optional[int] = None,
    use_fused: str = "auto",
    method: str = "standard",
    recompute_r_every: int = 0,
    s: int = 4,
    rcond: Optional[float] = None,
    gmres_restart: int = 30,
    gmres_flexible: bool = False,
    basis=None,
    M_local=None,
):
    """Row-sharded solve over a shard group, blocked-ELL operator.

    Args:
      blocks: (n_shards, nrb, kmax, bm, bn) per-shard blocked-ELL tiles
        (from :func:`~.partition.partition_csr_rows`), a tensor or numpy.
      block_cols: (n_shards, nrb, kmax) global column-block ids.
      b: (n_padded,) global right-hand side (zero on the padding rows).
      x0: optional (n_padded,) start; zero by default.
      mesh: the shard group (``make_row_mesh(n, device)``, or a
        ``DistributedGroup``); None runs every shard in this process on
        ``types.base.DEFAULT_DEVICE``.
      axis, ncols_padded: accepted as the JAX signature has them (the mesh
        axis name, the padded column count); neither is read there or here.
      tol: ABSOLUTE tolerance on ‖r‖ (CG), on the estimate φ̄ (MINRES).
      maxiter: iteration cap; None means n_padded + 1.
      inv_diag: optional (n_padded,) 1/diag(A) for Jacobi preconditioning
        (1 on the padding rows, to stay inert).
      use_fused: "auto" runs CG, Jacobi PCG and MINRES on the fused kernels
        (``bell_spmv_dot`` with ``fused_update_dot(_pcg)``, or
        ``minres_shard_spmv_dot`` with ``minres_update_dot``) when the
        operator qualifies (``loops._fused_shards_supported``: square
        tiles, bn and the rows per shard multiples of 128, float32 b, kmax
        <= 64, on a CUDA device); "always" runs them anyway (on CPU
        tensors: their plain versions, the parity path of the tests);
        "never" runs the portable loop.
      method: "standard", "minres", "pipelined", "sstep", "bicgstab" or
        "gmres" (module doc).
      recompute_r_every: if > 0, replace the recurrence residual with the
        true one AND reset the direction every that many iterations
        (standard and pipelined, portable loops only).
      s / rcond: the s-step block size and Gram cutoff (None: the dtype's
        default); read for method="sstep" only.
      gmres_restart / gmres_flexible: the GMRES cycle length, and FGMRES
        (for an ``M_local`` that is not one fixed linear operator).
      basis: a ``solver/deflated.DeflationBasis``: the deflated per-shard
        (P)CG (standard method; no restart, no fused path).
      M_local: a per-shard preconditioner ``r_local -> z_local`` or a
        :class:`ShardedPreconditioner` (exclusive with ``inv_diag``; no
        fused path).

    Returns (x, CGInfo); x is the (n_padded,) global solution.
    """
    del axis, ncols_padded  # the JAX signature's; neither is read
    if use_fused not in FUSED_CHOICES:
        raise ValueError(f"use_fused must be one of {FUSED_CHOICES}, got {use_fused!r}")
    if use_fused == "always" and basis is not None:
        raise ValueError("use_fused='always' has no deflated variant — the projector runs "
                         "the per-shard portable loop (basis=None to force fused)")
    if use_fused == "always" and recompute_r_every:
        raise ValueError(
            "use_fused='always' has no residual-replacement variant — "
            "restarts run the per-shard portable loop (recompute_r_every=0 "
            "to force fused)"
        )
    if use_fused == "always" and M_local is not None:
        raise ValueError("use_fused='always' has no general-M variant — M_local runs the "
                         "per-shard portable loop (M_local=None to force fused)")
    n_shards, nrb, _, bm, bn = blocks.shape
    group = _group_for(mesh, n_shards)
    if b.shape[0] != n_shards * nrb * bm:
        raise ValueError(f"b has {b.shape[0]} rows, the shards {n_shards} x {nrb * bm}")
    block_cols = torch.as_tensor(block_cols).to(torch.int32)
    fused = False
    if (method in ("standard", "minres") and not recompute_r_every and basis is None
            and M_local is None and use_fused != "never"):
        if use_fused == "always":
            fused = True
        else:
            lo, hi = group.shards[0], group.shards[-1] + 1
            m = nrb * bm
            fused = _fused_shards_supported(
                torch.as_tensor(blocks[lo:hi], device=group.device),
                torch.as_tensor(b[lo * m:hi * m], device=group.device))

    def fused_fn(group, ops, b_l, x0_l, d_l, tol_, maxiter_):
        n_own = len(b_l)
        blocks_l = [ops[0][i] for i in range(n_own)]
        cols_l = [ops[1][i] for i in range(n_own)]
        loop = _sharded_fused_minres if method == "minres" else _sharded_fused_cg
        return loop(group, blocks_l, cols_l, b_l, x0_l, tol_, maxiter_, bn, inv_diag=d_l)

    def make_lm(group, ops):
        blocks_s, cols_s = ops

        def apply(vs):
            full = _gathered(group, vs, bn)
            return [_local_bell_matvec(blocks_s[i], cols_s[i], full) for i in range(len(vs))]

        return apply

    return _sharded_solve(
        "bell", (blocks, block_cols), b, x0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, make_local_matvec=make_lm, method=method,
        recompute_r_every=recompute_r_every, s=s, rcond=rcond, gmres_restart=gmres_restart,
        gmres_flexible=gmres_flexible, basis=basis, fused_fn=fused_fn if fused else None,
        M_local=M_local)


def sharded_symbell_cg_solve(
    diag,
    off,
    off_cols,
    cross,
    cross_rows,
    cross_cols,
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    method: str = "standard",
    recompute_r_every: int = 0,
    s: int = 4,
    rcond: Optional[float] = None,
    gmres_restart: int = 30,
    gmres_flexible: bool = False,
    basis=None,
):
    """Row-sharded solve on SYMMETRIC blocked-ELL storage: intra-shard
    tiles stored once and mirrored into the shard's own rows, cross-shard
    tiles stored fully on the row owner (:func:`~.partition.
    partition_symbell_rows`), so the iteration keeps the full layout's
    collectives (one all_gather, the psum dots) on up to half the operator
    bytes.  Arguments as :func:`sharded_cg_solve` (no fused path); the six
    operator arrays from the partitioner.  Returns ``(x, CGInfo)``."""
    del axis
    n_shards, nrb, _, bn = diag.shape
    group = _group_for(mesh, n_shards)

    def make_lm(group, ops):
        from ..types.bell import mirror_index

        diag_s, off_s, offcols_s, cross_s, crossrows_s, crosscols_s = ops
        mirror = [torch.from_numpy(mirror_index(offcols_s[i].cpu().numpy())).to(group.device)
                  for i in range(len(group.shards))]
        bases = [s_ * nrb for s_ in group.shards]

        def apply(vs):
            full = _gathered(group, vs, bn)
            return [_local_symbell_matvec(diag_s[i], off_s[i], offcols_s[i], mirror[i],
                                          cross_s[i], crossrows_s[i], crosscols_s[i], full,
                                          bases[i])
                    for i in range(len(vs))]

        return apply

    return _sharded_solve(
        "symbell", (diag, off, off_cols, cross, cross_rows, cross_cols), b, x0, mesh=group,
        tol=tol, maxiter=maxiter, inv_diag=inv_diag, make_local_matvec=make_lm,
        method=method, recompute_r_every=recompute_r_every, s=s, rcond=rcond,
        gmres_restart=gmres_restart, gmres_flexible=gmres_flexible, basis=basis)


def _band_width(offsets, rows_per_shard: int) -> int:
    w = max(max((abs(o) for o in offsets), default=1), 1)
    if w > rows_per_shard:
        raise ValueError(
            f"bandwidth {w} exceeds rows_per_shard {rows_per_shard}; "
            "use fewer shards or the blocked-ELL path"
        )
    return w


def _shifted(offsets, w: int, device):
    """The shard's offsets on its haloed window, as a tuple and a tensor."""
    from ..types.dia import _offsets_tensor

    shifted = tuple(o + w for o in offsets)
    return shifted, _offsets_tensor(shifted, device)


def sharded_dia_cg_solve(
    diags_sharded,
    offsets: Tuple[int, ...],
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    method: str = "standard",
    recompute_r_every: int = 0,
    gmres_restart: int = 30,
    gmres_flexible: bool = False,
    s: int = 4,
    rcond: Optional[float] = None,
    basis=None,
):
    """Row-sharded solve with a DIA (banded) operator and a ring-halo
    SpMV: per application one ring halo of the bandwidth w (O(w) rows to
    each neighbour) instead of the all-gather, then kernel 7 (or its plain
    version) on the haloed window.  ``method="sstep"`` rides the
    matrix-powers basis (one widened ring halo a block) when s·w <=
    rows_per_shard.

    Args:
      diags_sharded: (n_shards, ndiag, rows_per_shard) from
        :func:`~.partition.partition_dia_rows`.
      offsets: the diagonal offsets (each |off| <= rows_per_shard).
      Others as :func:`sharded_cg_solve`.
    """
    del axis
    n_shards, _, rows_per_shard = diags_sharded.shape
    group = _group_for(mesh, n_shards)
    offsets = tuple(int(o) for o in offsets)
    w = _band_width(offsets, int(rows_per_shard))
    shifted, shifted_dev = _shifted(offsets, w, group.device)

    def make_lm(group, ops):
        diags_s = ops[0]

        def apply(vs):
            windows = group.ring_halo(vs, w)
            return [_local_dia_matvec(diags_s[i], shifted, shifted_dev, win)
                    for i, win in enumerate(windows)]

        return apply

    def mpk_factory(group, ops):
        return _make_dia_mpk_basis(group, list(ops[0]), offsets, int(s))

    return _sharded_solve(
        "dia", (diags_sharded,), b, x0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, make_local_matvec=make_lm, method=method,
        recompute_r_every=recompute_r_every, gmres_restart=gmres_restart,
        gmres_flexible=gmres_flexible, s=s, rcond=rcond, basis=basis,
        sstep_basis_factory=mpk_factory)


def sharded_symdia_cg_solve(
    diags_sharded,
    offsets: Tuple[int, ...],
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    method: str = "standard",
    recompute_r_every: int = 0,
    gmres_restart: int = 30,
    gmres_flexible: bool = False,
):
    """Row-sharded solve on SYMMETRIC DIA storage (offsets >= 0 only): half
    of :func:`sharded_dia_cg_solve`'s operator bytes at its collective
    count.  The forward terms ride the ring halo of the vector; the mirror
    terms reuse its left side and the left neighbour's diagonal tails,
    fetched once per solve.  ``diags_sharded``: the SymDIAMatrix's
    diagonals through :func:`~.partition.partition_dia_rows`.  Methods
    "standard" and "pipelined" (the matrix-powers basis has no symmetric
    form: use the full DIA layout for s-step)."""
    del axis
    n_shards, _, rows_per_shard = diags_sharded.shape
    group = _group_for(mesh, n_shards)
    offsets = tuple(int(o) for o in offsets)
    if any(o < 0 for o in offsets):
        raise ValueError(f"symmetric DIA stores offsets >= 0 only, got {offsets}")
    w = _band_width(offsets, int(rows_per_shard))
    if method not in ("standard", "pipelined"):
        raise ValueError(
            "sharded symmetric DIA supports method='standard'/'pipelined' "
            f"(got {method!r}); use the full DIA layout for sstep"
        )

    def make_lm(group, ops):
        diags_s = ops[0]
        # loop-invariant: the left neighbours' diagonal tails, once a solve
        dleft = _symdia_left_halo(group, list(diags_s), w)

        def apply(vs):
            windows = group.ring_halo(vs, w)
            return [_local_symdia_matvec(diags_s[i], dleft[i], offsets, win)
                    for i, win in enumerate(windows)]

        return apply

    return _sharded_solve(
        "symdia", (diags_sharded,), b, x0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, make_local_matvec=make_lm, method=method,
        recompute_r_every=recompute_r_every, gmres_restart=gmres_restart,
        gmres_flexible=gmres_flexible, supports_basis=False)


def sharded_sell_cg_solve(
    sell_sharded,
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    method: str = "standard",
    recompute_r_every: int = 0,
    s: int = 4,
    rcond: Optional[float] = None,
    gmres_restart: int = 30,
    gmres_flexible: bool = False,
):
    """Row-sharded solve with a SELL (degree-bucketed) operator, the
    scattered-pattern path: per application the all-gathered operand, one
    flat gather per shard at the stored global columns, the per-bucket
    sums.  ``sell_sharded``: the ``(diag, pos, cols_flat, vals_flat,
    bucket_meta, n_padded)`` tuple of :func:`~.partition.
    partition_sell_rows`.  Others as :func:`sharded_cg_solve` (no
    ``basis=``)."""
    del axis
    diag, pos, cols_flat, vals_flat, meta, n_padded = sell_sharded
    group = _group_for(mesh, int(diag.shape[0]))
    if int(b.shape[0]) != int(n_padded):
        raise ValueError(f"b has {b.shape[0]} rows, the partition {n_padded}")
    meta = tuple((int(nb), int(k)) for nb, k in meta)

    def make_lm(group, ops):
        diag_s, pos_s, cols_s, vals_s = ops
        pos_s, cols_s = pos_s.long(), cols_s.long()

        def apply(vs):
            full = _gathered(group, vs)
            return [_local_sell_matvec(diag_s[i], pos_s[i], cols_s[i], vals_s[i], meta, full,
                                       v) for i, v in enumerate(vs)]

        return apply

    return _sharded_solve(
        "sell", (diag, pos, cols_flat, vals_flat), b, x0, mesh=group, tol=tol,
        maxiter=maxiter, inv_diag=inv_diag, make_local_matvec=make_lm, method=method,
        recompute_r_every=recompute_r_every, s=s, rcond=rcond, gmres_restart=gmres_restart,
        gmres_flexible=gmres_flexible, supports_basis=False)
