"""Row-sharded solves: the solve cores and the layout front ends.
Counterpart of ``conjugategradient_tpu/parallel/sharded_cg.py``:
:func:`_sharded_solve`, which every layout configures, its five 1-D front
ends (blocked-ELL, symmetric blocked-ELL, DIA, symmetric DIA, SELL) and the
2-D blocked-ELL one; :func:`_sharded_solve_batched` and its multi-RHS
front ends (blocked-ELL, SELL, DIA, 2-D); and the checkpointable state API
(:class:`ShardedCGState`, ``sharded_{,dia_,sell_}cg_init`` /
``..._run_cg``, :func:`sharded_state_result`).

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

The 2-D front end (:func:`sharded_cg_solve_2d`) runs the same core over a
p × p block grid (``make_mesh_2d``): the vectors are p row pieces, a
product is one transpose exchange, the block products and one sum over
each block row (``collectives.py``), and no all_gather.

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
from ..solver.restart import run_chunked
from ..solver.sstep import _default_rcond as _sstep_default_rcond
from .local_ops import (
    _bell_products,
    _local_bell_matvec,
    _local_bell_matvec_multi,
    _local_dia_matvec,
    _local_dia_matvec_multi,
    _local_sell_matvec,
    _local_sell_matvec_multi,
    _local_symbell_matvec,
    _local_symdia_matvec,
    _make_dia_mpk_basis,
    _shard_packed,
    _symdia_left_halo,
)
from .loops import (
    PCGCarry,
    _batched_loop,
    _ctx,
    _fused_shards_supported,
    _pcg_body_fn,
    _pcg_init_carry,
    _pcg_replace_fn,
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
from .partition import make_mesh_2d, make_row_mesh

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

    ``collective=True`` is the form of an apply that reaches the other
    shards (the sharded multigrid, AMG and FSAI: the JAX applies run
    collectives inside ``shard_map``): ``make_local_apply(arrays, group)``
    is called once per solve with the owned shards' arrays (the sharded
    ones keep their leading owned-shard axis) and the shard group, and
    returns the apply of every owned shard at once, ``[r_local] ->
    [z_local]``.
    """

    op_arrays: tuple
    make_local_apply: Callable
    op_specs: Optional[tuple] = None
    collective: bool = False


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
        if M_local.collective:
            apply = M_local.make_local_apply(arrays, group)
            return lambda vs: list(apply(list(vs)))
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


def _owned_rows(group, n_rows: int, what: str = "b"):
    """``(own, m)`` for a group over global arrays of ``n_rows`` rows:
    ``own(v, rows=m)`` is the owned shards' part of ``v`` (``rows`` rows a
    shard; None stays None) on the group's device, m the rows a shard."""
    n_shards = group.n_shards
    if n_rows % n_shards:
        raise ValueError(f"{what} has {n_rows} rows, not a multiple of {n_shards} shards")
    lo, hi = group.shards[0], group.shards[-1] + 1
    if tuple(group.shards) != tuple(range(lo, hi)):
        raise ValueError(f"a group must own consecutive shards, got {group.shards}")

    def own(v, rows=n_rows // n_shards):
        return None if v is None else torch.as_tensor(v[lo * rows:hi * rows], device=group.device)

    return own, n_rows // n_shards


def _split(v, m: int):
    """The owned shards' (m, ...) slices of their joined rows, or None."""
    return None if v is None else [v[i * m:(i + 1) * m] for i in range(v.shape[0] // m)]


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
    for ``method="sstep"`` (the DIA ring one).  ``group.own_op`` takes
    each operator array's owned part.  The method, preconditioner,
    restart and deflation checks live here, so every front end enforces
    the same semantics.
    """
    group = mesh
    n_padded = int(b.shape[0])
    own, _ = _owned_rows(group, n_padded)
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
    dev = group.device
    op_shards = [group.own_op(a) for a in op_arrays]
    precond = own(inv_diag)
    if M_local is not None:
        precond = _local_precond(M_local, group, own)
    deflation = None
    if basis is not None:
        W_sh, AW_sh, E_chol = shard_deflation_basis(basis, n_padded, group.n_shards)
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
    m = int(b.shape[0]) // len(group.shards)
    b_l = _split(b, m)
    x0_l = _split(torch.zeros_like(b) if x0 is None else x0, m)
    pre = precond if callable(precond) else _split(precond, m)
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
    return group.assemble(x_l), _solve_info(k, done, rho, rnorm, hist)


def _group_for(mesh, n_shards: int):
    group = mesh if mesh is not None else make_row_mesh(n_shards)
    if n_shards != group.n_shards:
        raise ValueError(f"the operator holds {n_shards} shards, the group {group.n_shards}")
    return group


def _gathered(group, vs, bn=None):
    full = group.all_gather(vs)
    return full if bn is None else full.reshape(-1, bn)


# ---- the layouts' local products, built once a solve --------------------------------

def _bell_matvec(bn: int, multi: bool = False) -> Callable:
    """``make_local_matvec`` of the blocked-ELL shards: one all_gather,
    then each owned shard's tiles against it (kernel 5 or the einsum; with
    ``multi``, the plain multi-RHS product on (m, R) slabs)."""
    def make_lm(group, ops):
        blocks_s, cols_s = ops
        if not multi:
            nrb, _, bm, _ = blocks_s.shape[1:]
            products = _bell_products(blocks_s, cols_s, group.n_shards * nrb * bm)

        def apply(vs):
            full = group.all_gather(vs)
            if multi:
                full = full.reshape(-1, bn, vs[0].shape[-1])
                return [_local_bell_matvec_multi(blocks_s[i], cols_s[i], full)
                        for i in range(len(vs))]
            return products(full.reshape(-1, bn))

        return apply

    return make_lm


def _dia_matvec(offsets, rows_per_shard: int, device, multi: bool = False) -> Callable:
    """``make_local_matvec`` of the DIA shards: one ring halo of the
    bandwidth, then kernel 7 (or its plain version) on each window; with
    ``multi``, the plain multi-RHS product on (m + 2w, R) windows."""
    w = _band_width(offsets, rows_per_shard)
    shifted, shifted_dev = _shifted(offsets, w, device)

    def make_lm(group, ops):
        diags_s = ops[0]

        def apply(vs):
            windows = group.ring_halo(vs, w)
            if multi:
                return [_local_dia_matvec_multi(diags_s[i], shifted, win)
                        for i, win in enumerate(windows)]
            return [_local_dia_matvec(diags_s[i], shifted, shifted_dev, win)
                    for i, win in enumerate(windows)]

        return apply

    return make_lm


def _sell_matvec(meta, multi: bool = False) -> Callable:
    """``make_local_matvec`` of the SELL shards: one all_gather, then each
    owned shard's flat gather and bucket sums (R lanes an index with
    ``multi``)."""
    meta = tuple((int(nb), int(k)) for nb, k in meta)
    local = _local_sell_matvec_multi if multi else _local_sell_matvec

    def make_lm(group, ops):
        diag_s, pos_s, cols_s, vals_s = ops
        pos_s, cols_s = pos_s.long(), cols_s.long()

        def apply(vs):
            full = group.all_gather(vs).reshape((-1,) + tuple(vs[0].shape[1:]))
            return [local(diag_s[i], pos_s[i], cols_s[i], vals_s[i], meta, full, v)
                    for i, v in enumerate(vs)]

        return apply

    return make_lm


def _grid_matvec(bn: int, multi: bool = False) -> Callable:
    """``make_local_matvec`` of the 2-D grid: the transpose exchange hands
    block (i, j) row piece j, each owned block multiplies it (kernel 5 or
    the einsum; the multi-RHS form on (m, R) pieces), and each block row's
    partial products are summed over j in order."""
    def make_lm(group, ops):
        blocks_b, cols_b = ops  # the owned blocks: (rows, cols, nrb, kmax, bm, bn)
        piece_rows = blocks_b.shape[2] * blocks_b.shape[4]
        packs = [[None if multi else _shard_packed(b, c, piece_rows) for b, c in zip(*row)]
                 for row in zip(blocks_b, cols_b)]

        def product(a, c, piece):
            if multi:
                return _local_bell_matvec_multi(blocks_b[a, c], cols_b[a, c],
                                                piece.reshape(-1, bn, piece.shape[-1]))
            return _local_bell_matvec(blocks_b[a, c], cols_b[a, c], piece.reshape(-1, bn),
                                      packs[a][c])

        def apply(vs):
            pieces = group.transpose(vs)
            return group.col_sum([[product(a, c, v) for c, v in enumerate(row)]
                                  for a, row in enumerate(pieces)])

        return apply

    return make_lm


def _grid_for(mesh, blocks):
    """The 2-D group of a solve (default: a p × p grid on the default
    device, p from the blocks), checked against the blocks' grid."""
    p = int(blocks.shape[0])
    group = mesh if mesh is not None else make_mesh_2d(p)
    if not hasattr(group, "transpose"):
        raise ValueError("the 2-D solve needs a 2-D group (make_mesh_2d or "
                         "DistributedGroup.mesh_2d)")
    if tuple(blocks.shape[:2]) != (group.p, group.p):
        raise ValueError(f"blocks hold a {tuple(blocks.shape[:2])} grid, the group "
                         f"{group.p} x {group.p}")
    return group


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

    return _sharded_solve(
        "bell", (blocks, block_cols), b, x0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, make_local_matvec=_bell_matvec(bn), method=method,
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


def sharded_cg_solve_2d(
    blocks,
    block_cols,
    b,
    x0=None,
    *,
    mesh=None,
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
    """(P)CG, and every method of the core, on a p × p 2-D block
    decomposition of A.

    Block (i, j) is A_ij (:func:`~.partition.partition_csr_blocks_2d`);
    the vectors live as p ROW pieces.  Per product: ONE transpose exchange
    hands block (i, j) piece j (n/p values), and ONE sum over each block
    row reduces the partial products (n/p values) — in place of the 1-D
    scheme's n-value all_gather; the dots sum over the row pieces only.
    The loop is the same per-shard machinery as every 1-D front end, so
    restart, Jacobi PCG and the communication-avoiding methods compose
    unchanged.  No deflated (``basis=``) variant, as in the JAX package.

    ``mesh``: a 2-D group (``make_mesh_2d(p, device)``, or
    ``DistributedGroup.mesh_2d(p)`` over p² processes); None: a p × p grid
    on the default device, p from ``blocks``.  Returns ``(x, CGInfo)``.
    """
    group = _grid_for(mesh, blocks)
    bn = int(blocks.shape[-1])
    return _sharded_solve(
        "bell2d", (blocks, block_cols), b, x0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, make_local_matvec=_grid_matvec(bn), method=method,
        recompute_r_every=recompute_r_every, s=s, rcond=rcond, gmres_restart=gmres_restart,
        gmres_flexible=gmres_flexible, supports_basis=False)


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
    make_lm = _dia_matvec(offsets, int(rows_per_shard), group.device)

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
    return _sharded_solve(
        "sell", (diag, pos, cols_flat, vals_flat), b, x0, mesh=group, tol=tol,
        maxiter=maxiter, inv_diag=inv_diag, make_local_matvec=_sell_matvec(meta), method=method,
        recompute_r_every=recompute_r_every, s=s, rcond=rcond, gmres_restart=gmres_restart,
        gmres_flexible=gmres_flexible, supports_basis=False)


# ---- the multi-RHS core and its front ends ----------------------------------------------

def _sharded_solve_batched(
    family: str,
    op_arrays: Sequence,
    B,
    X0=None,
    *,
    mesh,
    tol,
    maxiter: Optional[int],
    inv_diag,
    recompute_r_every: int,
    method: str,
    rcond: Optional[float],
    make_local_matvec_multi: Callable,
):
    """The sharded multi-RHS solve core (shards × lanes): each owned shard
    keeps its operator rows and an (m, R) slab of every lane's vectors; the
    layout supplies ``make_local_matvec_multi(group, op_shards)``, whose
    apply takes and returns the owned shards' slabs.  The loop is
    :func:`~.loops._sharded_lockstep_pcg` (independent lanes) or
    :func:`~.loops._sharded_block_cg` (one shared space): both sum (R,) or
    (R, R) payloads over the shards, so R solves ride one solve's
    collectives."""
    group = mesh
    B = torch.as_tensor(B)
    if B.ndim != 2:
        raise ValueError(f"B must be (nrhs, n_padded), got {tuple(B.shape)}")
    R, n_padded = int(B.shape[0]), int(B.shape[1])
    own, m = _owned_rows(group, n_padded, "B.T")
    maxiter = int(n_padded + 1 if maxiter is None else maxiter)
    tol_t = torch.as_tensor(tol, dtype=B.dtype)
    if tol_t.ndim == 1 and tol_t.shape[0] != R:
        raise ValueError(f"per-lane tol has length {tol_t.shape[0]}, expected {R}")
    recompute_r_every = int(recompute_r_every)
    if recompute_r_every < 0:
        raise ValueError(f"recompute_r_every must be >= 0, got {recompute_r_every}")
    rcond = _sstep_default_rcond(B.dtype) if rcond is None else float(rcond)
    loop = _batched_loop(method, recompute_r_every, rcond)

    def slabs(M):
        return [v.contiguous() for v in _split(own(torch.as_tensor(M).T), m)]

    op_shards = [group.own_op(a) for a in op_arrays]
    apply = make_local_matvec_multi(group, op_shards)
    X_l, k, done, rho, rnorm, hist = loop(
        group, apply, slabs(B), slabs(torch.zeros_like(B) if X0 is None else X0),
        _split(own(inv_diag), m), tol_t.to(group.device), maxiter)
    X = group.assemble(X_l).reshape(n_padded, R).T.contiguous()
    return X, _solve_info(k, done, rho, rnorm, hist)


def sharded_cg_solve_batched(
    blocks,
    block_cols,
    B,
    X0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol=0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    recompute_r_every: int = 0,
    method: str = "lockstep",
    rcond: Optional[float] = None,
):
    """Row-sharded multi-RHS (P)CG on blocked-ELL shards: per iteration
    ONE all_gather moves every lane's p, each shard's tiles are read once
    for all R lanes, and the dots sum (R,) lane vectors over the shards.

    Args:
      blocks / block_cols: per-shard tiles from
        :func:`~.partition.partition_csr_rows`.
      B: (R, n_padded) right-hand sides; X0 optional, the same shape.
      tol: scalar or (R,) per-lane ABSOLUTE tolerances on ‖r‖₂.
      inv_diag: optional (n_padded,) Jacobi diagonal, shared by the lanes.
      method: "lockstep" (independent lanes) or "block" (O'Leary's shared
        Krylov space, solver/blockcg.py: (R, R) Gram blocks summed over the
        shards).
      recompute_r_every: residual-replacement restarts every that many
        iterations (per lane in lockstep, the whole block in block CG).
      rcond: the block method's Gram cutoff (None: the dtype's default).

    Returns (X (R, n_padded), CGInfo with per-lane fields:
    iterations/converged/rho/rnorm_sq (R,), rho_history (R, maxiter+1)).
    """
    del axis
    group = _group_for(mesh, int(blocks.shape[0]))
    block_cols = torch.as_tensor(block_cols).to(torch.int32)
    return _sharded_solve_batched(
        "bell", (blocks, block_cols), B, X0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, recompute_r_every=recompute_r_every, method=method, rcond=rcond,
        make_local_matvec_multi=_bell_matvec(int(blocks.shape[-1]), multi=True))


def sharded_cg_solve_2d_batched(
    blocks,
    block_cols,
    B,
    X0=None,
    *,
    mesh=None,
    tol=0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    recompute_r_every: int = 0,
    method: str = "lockstep",
    rcond: Optional[float] = None,
):
    """Multi-RHS (P)CG on the p × p 2-D block decomposition: the
    transpose exchange and the block-row sum of :func:`sharded_cg_solve_2d`
    move every lane's (m, R) piece at once, and each block's tiles are read
    once for all R lanes; no all_gather.  Arguments as
    :func:`sharded_cg_solve_2d` (blocks from
    :func:`~.partition.partition_csr_blocks_2d`) and
    :func:`sharded_cg_solve_batched` (``B``, per-lane ``tol``,
    ``method``).  Returns (X (R, n_padded), CGInfo with per-lane fields)."""
    group = _grid_for(mesh, blocks)
    block_cols = torch.as_tensor(block_cols).to(torch.int32)
    return _sharded_solve_batched(
        "bell2d", (blocks, block_cols), B, X0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, recompute_r_every=recompute_r_every, method=method, rcond=rcond,
        make_local_matvec_multi=_grid_matvec(int(blocks.shape[-1]), multi=True))


def sharded_sell_cg_solve_batched(
    sell_sharded,
    B,
    X0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol=0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    recompute_r_every: int = 0,
    method: str = "lockstep",
    rcond: Optional[float] = None,
):
    """Row-sharded multi-RHS (P)CG on the SELL layout: the flat gather at
    each shard's stored global columns fetches R contiguous lane values an
    index.  Same contract as :func:`sharded_cg_solve_batched`;
    ``sell_sharded`` is :func:`~.partition.partition_sell_rows`'s tuple."""
    del axis
    diag, pos, cols_flat, vals_flat, meta, n_padded = sell_sharded
    group = _group_for(mesh, int(diag.shape[0]))
    B = torch.as_tensor(B)
    if B.ndim == 2 and int(B.shape[1]) != int(n_padded):
        raise ValueError(f"B has {B.shape[1]} columns, the partition {n_padded}")
    return _sharded_solve_batched(
        "sell", (diag, pos, cols_flat, vals_flat), B, X0, mesh=group, tol=tol,
        maxiter=maxiter, inv_diag=inv_diag, recompute_r_every=recompute_r_every,
        method=method, rcond=rcond, make_local_matvec_multi=_sell_matvec(meta, multi=True))


def sharded_dia_cg_solve_batched(
    diags_sharded,
    offsets: Tuple[int, ...],
    B,
    X0=None,
    *,
    mesh=None,
    axis: str = "rows",
    tol=0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    recompute_r_every: int = 0,
    method: str = "lockstep",
    rcond: Optional[float] = None,
):
    """Row-sharded multi-RHS (P)CG on the banded (DIA) layout: per
    iteration one ring halo moves the bandwidth-wide edges of ALL R lanes
    ((w, R) values to each neighbour), each diagonal is read once for all
    lanes, and the dots sum (R,) lane vectors.  Same contract as the
    blocked-ELL variant; ``diags_sharded`` from
    :func:`~.partition.partition_dia_rows`, ``|off| <= rows_per_shard``."""
    del axis
    group = _group_for(mesh, int(diags_sharded.shape[0]))
    offsets = tuple(int(o) for o in offsets)
    return _sharded_solve_batched(
        "dia", (diags_sharded,), B, X0, mesh=group, tol=tol, maxiter=maxiter,
        inv_diag=inv_diag, recompute_r_every=recompute_r_every, method=method, rcond=rcond,
        make_local_matvec_multi=_dia_matvec(offsets, int(diags_sharded.shape[-1]),
                                            group.device, multi=True))


# ---- checkpoint / resume of long sharded solves --------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedCGState:
    """The row-sharded (P)CG carry, the JAX package's fields: ``x``, ``r``
    and ``p`` are global (n_padded,) vectors (gathered over the group when
    the state is built or advanced), the scalars and ``hist`` one copy.
    Write it with ``solver.checkpoint.save_state``; the group and the
    operator are given again at resume (the layout lives in the operator,
    not in the carry)."""

    k: torch.Tensor
    done: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    rnorm: torch.Tensor
    hist: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def _state_setup(op_arrays, mesh, n_padded: int):
    """The group, the owned shards' (m,) slices of a global vector, and
    the owned operator arrays."""
    group = _group_for(mesh, int(op_arrays[0].shape[0]))
    own, m = _owned_rows(group, n_padded)
    return group, (lambda v: _split(own(v), m)), [group.own_op(a) for a in op_arrays]


def _generic_sharded_init(op_arrays, make_lm, b, x0, inv_diag, mesh, maxiter) -> ShardedCGState:
    """The state of a solve that has taken no step: ``_pcg_init_carry`` on
    the owned shards (the uninterrupted solve's own start), its vectors
    gathered."""
    n_padded = int(b.shape[0])
    maxiter = int(n_padded + 1 if maxiter is None else maxiter)
    group, own, ops = _state_setup(op_arrays, mesh, n_padded)
    b_l = own(b)
    x0_l = own(torch.zeros_like(torch.as_tensor(b)) if x0 is None else x0)
    ctx = _ctx(group, make_lm(group, ops), b_l, own(inv_diag), 0.0)
    c = _pcg_init_carry(ctx, x0_l, maxiter)
    return ShardedCGState(k=c.k, done=c.done, x=group.all_gather(c.x),
                          r=group.all_gather(c.r), p=group.all_gather(c.p), rho=c.rho,
                          rnorm=c.rnorm, hist=c.hist)


def _generic_sharded_run(op_arrays, make_lm, state: ShardedCGState, tol, steps, b, inv_diag,
                         recompute_r_every, mesh) -> ShardedCGState:
    """Advance a state by at most ``steps`` iterations with the body and
    the restart of the uninterrupted portable solve (``_pcg_body_fn``,
    ``_pcg_replace_fn``) under ``run_chunked``, from the state's k: the
    chunks give that solve's bits.  The host reads k once a call."""
    maxiter = int(state.hist.numel()) - 1
    k0 = int(state.k)
    limit = maxiter if steps is None else min(maxiter, k0 + int(steps))
    recompute_r_every = int(recompute_r_every)
    if recompute_r_every > 0 and b is None:
        raise ValueError("recompute_r_every > 0 needs b (the RHS)")
    group, own, ops = _state_setup(op_arrays, mesh, int(state.x.shape[0]))
    dev = group.device
    b_l = own(b)
    x_l = own(state.x)
    ctx = _ctx(group, make_lm(group, ops), b_l if b_l is not None else x_l, own(inv_diag),
               tol)
    box = [PCGCarry(k=state.k.to(dev), done=state.done.to(dev), x=x_l, r=own(state.r),
                    p=own(state.p), rho=state.rho.to(dev), rnorm=state.rnorm.to(dev),
                    hist=state.hist.to(dev).clone())]

    def step():
        box[0] = _pcg_body_fn(ctx, box[0])

    def replace():
        box[0] = _pcg_replace_fn(ctx, box[0], recompute_r_every)

    run_chunked(step, lambda: box[0].live, limit, recompute_r_every, replace,
                done=lambda: box[0].done, start=k0)
    c = box[0]
    return ShardedCGState(k=c.k, done=c.done, x=group.all_gather(c.x),
                          r=group.all_gather(c.r), p=group.all_gather(c.p), rho=c.rho,
                          rnorm=c.rnorm, hist=c.hist)


def sharded_cg_init(
    blocks,
    block_cols,
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    maxiter: Optional[int] = None,
    inv_diag=None,
) -> ShardedCGState:
    """The row-sharded (blocked-ELL) PCG carry of a solve that has taken no
    step: the checkpoint and resume entry point for long solves
    (:func:`sharded_run_cg` advances it, ``solver.checkpoint.save_state`` /
    ``load_state`` write and read it).  Arguments as
    :func:`sharded_cg_solve`."""
    del axis
    bn = int(blocks.shape[-1])
    return _generic_sharded_init((blocks, torch.as_tensor(block_cols).to(torch.int32)),
                                 _bell_matvec(bn), b, x0, inv_diag, mesh, maxiter)


def sharded_run_cg(
    blocks,
    block_cols,
    state: ShardedCGState,
    *,
    tol=0.0,
    steps: Optional[int] = None,
    mesh=None,
    axis: str = "rows",
    b=None,
    inv_diag=None,
    recompute_r_every: int = 0,
) -> ShardedCGState:
    """Advance a row-sharded solve by up to ``steps`` iterations (or to
    convergence or the history's capacity); returns the new state.

    ``inv_diag`` must be the one the state was made with; ``b`` is needed
    only when ``recompute_r_every > 0`` (a restart recomputes the true
    residual).  Chunks compose bit for bit with
    :func:`sharded_cg_solve`'s portable solve (``use_fused="never"``): the
    body and the local product are the same (kernel 5 on float32 shards
    on a CUDA device)."""
    del axis
    bn = int(blocks.shape[-1])
    return _generic_sharded_run((blocks, torch.as_tensor(block_cols).to(torch.int32)),
                                _bell_matvec(bn), state, tol, steps, b, inv_diag,
                                recompute_r_every, mesh)


def sharded_dia_cg_init(
    diags_sharded,
    offsets,
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    maxiter: Optional[int] = None,
    inv_diag=None,
) -> ShardedCGState:
    """The checkpointable carry of the ring-halo (DIA) sharded solve, the
    long banded solve where resume matters most."""
    del axis
    offsets = tuple(int(o) for o in offsets)
    group = _group_for(mesh, int(diags_sharded.shape[0]))
    return _generic_sharded_init(
        (diags_sharded,), _dia_matvec(offsets, int(diags_sharded.shape[-1]), group.device),
        b, x0, inv_diag, group, maxiter)


def sharded_dia_run_cg(
    diags_sharded,
    offsets,
    state: ShardedCGState,
    *,
    tol=0.0,
    steps: Optional[int] = None,
    mesh=None,
    axis: str = "rows",
    b=None,
    inv_diag=None,
    recompute_r_every: int = 0,
) -> ShardedCGState:
    """Resume sibling of :func:`sharded_dia_cg_init` (kernel 7 on each
    haloed window, as :func:`sharded_dia_cg_solve`)."""
    del axis
    offsets = tuple(int(o) for o in offsets)
    group = _group_for(mesh, int(diags_sharded.shape[0]))
    return _generic_sharded_run(
        (diags_sharded,), _dia_matvec(offsets, int(diags_sharded.shape[-1]), group.device),
        state, tol, steps, b, inv_diag, recompute_r_every, group)


def sharded_sell_cg_init(
    sell_sharded,
    b,
    x0=None,
    *,
    mesh=None,
    axis: str = "rows",
    maxiter: Optional[int] = None,
    inv_diag=None,
) -> ShardedCGState:
    """The checkpointable carry of the scattered-pattern (SELL) sharded
    solve; ``sell_sharded`` is :func:`~.partition.partition_sell_rows`'s
    tuple."""
    del axis
    diag, pos, cols_flat, vals_flat, meta, _ = sell_sharded
    return _generic_sharded_init((diag, pos, cols_flat, vals_flat), _sell_matvec(meta), b, x0,
                                 inv_diag, mesh, maxiter)


def sharded_sell_run_cg(
    sell_sharded,
    state: ShardedCGState,
    *,
    tol=0.0,
    steps: Optional[int] = None,
    mesh=None,
    axis: str = "rows",
    b=None,
    inv_diag=None,
    recompute_r_every: int = 0,
) -> ShardedCGState:
    """Resume sibling of :func:`sharded_sell_cg_init`."""
    del axis
    diag, pos, cols_flat, vals_flat, meta, _ = sell_sharded
    return _generic_sharded_run((diag, pos, cols_flat, vals_flat), _sell_matvec(meta), state,
                                tol, steps, b, inv_diag, recompute_r_every, mesh)


def sharded_state_result(state: ShardedCGState):
    """(x, CGInfo) of a carry, as :func:`sharded_cg_solve` returns them."""
    return state.x, _solve_info(state.k, state.done, state.rho, state.rnorm, state.hist)
