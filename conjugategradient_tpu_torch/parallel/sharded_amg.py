"""Row-sharded smoothed-aggregation AMG for assembled SPD matrices.
Counterpart of ``conjugategradient_tpu/parallel/sharded_amg.py``.

The sharded form of :func:`~conjugategradient_tpu_torch.
smoothed_aggregation_preconditioner`: the SAME hierarchy (both functions
call ``solver.amg._build_hierarchy``, so the aggregates, prolongators and
Galerkin operators are equal by construction) and the same V-cycle
arithmetic, over the solver's row shards, so AMG-PCG on an assembled
matrix spreads over the shards as the geometric one does for stencils.

Communication a V-cycle:

* **smoothing and residual on a sharded level**: each damped-Jacobi or
  Chebyshev sweep's product all_gathers the level vector (a general
  pattern has no banded halo) and applies the shard's blocked-ELL rows;
* **transfers**: the restriction is the shard's rows of Pᵀ against the
  gathered fine residual, the prolongation the shard's rows of P against
  the gathered coarse correction: one all_gather each;
* **coarse tail**: levels of at most ``agglomerate_below`` points run
  replicated after one small all_gather, on the ONE-CARD cycle
  (``solver.amg._make_vcycle``, the same code), built once a device.  In
  an in-process group the tail runs once and its shards share it: the
  bits are those of each process of a ``DistributedGroup`` running it.

The level operators travel as sharded arrays of a collective
:class:`~.sharded_cg.ShardedPreconditioner`, so a process holds only its
shards' rows of every level.  Padding: level l pads its n_l rows to
S·rps_l (zero rows, zero inverse diagonal, so the padding stays exactly
zero through every sweep and transfer); level 0 takes the SOLVER's
``n_padded``, so the apply's shards line up with the CG loop's.

The level tiles are bm = bn = gcd(rps_l, 8) wide (the JAX partition, so
both packages hold the same arrays).  On the card their float32 products
take packed kernel 5 on each shard's packed view, built once an apply's
set-up (``local_ops._bell_products``); float64 and CPU tensors take the
plain einsum.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from ..solver.amg import (_build_hierarchy, _cheb_interval, _coarse_solver, _device_levels,
                          _make_vcycle, _to_scipy_csr, _torch_dtype)
from ..solver.multigrid import _cheb_smooth_steps
from ..types import CSRMatrix
from .local_ops import _bell_products
from .partition import _cdiv, partition_csr_rows
from .sharded_cg import ShardedPreconditioner


def _pad_csr(M, nrows_p: int, ncols_p: int):
    """A scipy CSR zero-extended to (nrows_p, ncols_p): empty padding rows,
    padding columns never referenced."""
    import scipy.sparse as sp

    M = M.tocsr()
    if nrows_p < M.shape[0] or ncols_p < M.shape[1]:
        raise ValueError(f"cannot pad {M.shape} to {(nrows_p, ncols_p)}")
    indptr = np.concatenate([M.indptr, np.full(nrows_p - M.shape[0], M.indptr[-1],
                                               dtype=M.indptr.dtype)])
    return sp.csr_matrix((M.data, M.indices, indptr), shape=(nrows_p, ncols_p))


def _block_of(rps: int) -> int:
    """The largest tile edge in {8, 4, 2, 1} that divides the rows a shard
    holds, so the partition pads to exactly rps rows a shard."""
    return math.gcd(rps, 8)


def _partition_level_op(M, n_shards: int, rps_rows: int, n_cols_padded: int, bn_src: int,
                        dtype):
    """A (padded) level operator as per-shard blocked-ELL rows: rps_rows a
    shard, column-block ids GLOBAL into the source level's padded vector
    seen as (-1, bn_src)."""
    bm = _block_of(rps_rows)
    Mp = _pad_csr(M, rps_rows * n_shards, n_cols_padded)
    blocks, cols, n_out = partition_csr_rows(
        Mp.data.astype(np.float64), Mp.indices, Mp.indptr, (rps_rows * n_shards, n_cols_padded),
        n_shards, bm=bm, bn=bn_src)
    if n_out != rps_rows * n_shards:
        raise AssertionError((n_out, rps_rows, n_shards))
    return torch.from_numpy(blocks).to(dtype), torch.from_numpy(cols)


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def sharded_amg_preconditioner(
    A: Any,
    n_shards: int,
    n_padded: int,
    *,
    axis: str = "rows",
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
    near_nullspace=None,
    blocksize: int = 1,
    agglomerate_below: int = 32768,
    dtype=None,
) -> ShardedPreconditioner:
    """The row-sharded smoothed-aggregation AMG ``M_local`` for
    :func:`~conjugategradient_tpu_torch.parallel.sharded_cg_solve`.

    Arguments as :func:`~conjugategradient_tpu_torch.
    smoothed_aggregation_preconditioner` (the same defaults and hierarchy),
    plus:

      n_shards: the group's size (the solve's).
      n_padded: the SOLVER's padded size (the third return of
        ``partition_csr_rows``), so level 0's shards line up with the CG
        loop's vectors.
      axis: accepted as the JAX signature has it; not read.
      agglomerate_below: levels of at most this many points run replicated
        after one all_gather on the one-card cycle; the coarsest level
        always does.
      level_layout: the layout of the replicated tail's operators (the
        sharded levels are blocked-ELL row blocks).

    Returns a collective :class:`~.sharded_cg.ShardedPreconditioner`
    (``M_local=``); diagnostics ``.level_sizes``, ``.n_levels``, ``.split``
    (the number of sharded levels), ``.stalled_coarse``.
    """
    del axis
    if nu < 1:
        raise ValueError(f"nu must be >= 1, got {nu}")
    if cycles < 1:
        raise ValueError(f"cycles must be >= 1, got {cycles}")
    if not (0.0 < omega < 2.0):
        raise ValueError(f"omega must be in (0, 2), got {omega}")
    if level_layout not in ("auto", "csr"):
        raise ValueError(f"level_layout must be 'auto' or 'csr', got {level_layout!r}")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"smoother must be 'jacobi' or 'chebyshev', got {smoother!r}")
    if not (0.0 < cheb_lower < 1.0):
        raise ValueError(f"cheb_lower must be in (0, 1), got {cheb_lower}")
    if dtype is None:
        dtype = A.dtype if isinstance(A, CSRMatrix) else torch.get_default_dtype()
    dtype = _torch_dtype(dtype)
    A0 = _to_scipy_csr(A)
    n0 = A0.shape[0]
    if A0.shape[0] != A0.shape[1]:
        raise ValueError(f"AMG needs a square operator, got {A0.shape}")
    if n_padded < n0:
        raise ValueError(f"n_padded={n_padded} < matrix size {n0}")
    if n_padded % n_shards:
        raise ValueError(f"n_padded={n_padded} not divisible by n_shards={n_shards}")

    level_mats, A_coarse_sp = _build_hierarchy(
        A0, theta=theta, smooth_prolongator=smooth_prolongator, coarse_size=coarse_size,
        max_levels=max_levels, near_nullspace=near_nullspace, blocksize=blocksize)
    if dense_cap is None:
        dense_cap = max(coarse_size, 4000)
    L = len(level_mats)
    sizes = [m["A"].shape[0] for m in level_mats] + [A_coarse_sp.shape[0]]

    # the sharded prefix: levels big enough to be worth the gathers
    split = 0
    while split < L and sizes[split] > agglomerate_below:
        split += 1
    # padded rows a shard for levels 0..split (split's vector arrives as
    # shards although its operator is in the replicated tail)
    rps = [n_padded // n_shards] + [_cdiv(_cdiv(sizes[l], n_shards), 8) * 8
                                    for l in range(1, split + 1)]
    padded = [r * n_shards for r in rps]

    op_arrays, per_level_bn, cheb_steps = [], [], []
    diag_scale = omega if smoother == "jacobi" else 1.0
    for l in range(split):
        m = level_mats[l]
        A_l = m["A"]
        d = A_l.diagonal()
        invd = np.zeros(padded[l])
        invd[:sizes[l]] = diag_scale / np.where(np.abs(d) > 0, d, 1.0)
        if smoother == "chebyshev":
            cheb_steps.append(_cheb_smooth_steps(*_cheb_interval(A_l, cheb_lower), nu))
        bn_l, bn_c = _block_of(rps[l]), _block_of(rps[l + 1])
        A_b, A_c = _partition_level_op(A_l, n_shards, rps[l], padded[l], bn_l, dtype)
        PT_b, PT_c = _partition_level_op(m["P"].T.tocsr(), n_shards, rps[l + 1], padded[l],
                                         bn_l, dtype)
        P_b, P_c = _partition_level_op(m["P"], n_shards, rps[l], padded[l + 1], bn_c, dtype)
        invd_t = torch.from_numpy(invd.astype(_np_dtype(dtype)).reshape(n_shards, rps[l]))
        op_arrays += [A_b, A_c, invd_t, PT_b, PT_c, P_b, P_c]
        per_level_bn.append((bn_l, bn_c))

    n_split = sizes[split]
    tails = {}

    def tail_of(device):
        """The one-card cycle over the agglomerated levels (and its first
        operator, for the residual of extra cycles), built once a device."""
        if device not in tails:
            levels = _device_levels(level_mats[split:], dtype, level_layout, omega,
                                    smoother=smoother, cheb_lower=cheb_lower, device=device)
            coarse_apply, coarse_residual, _ = _coarse_solver(
                A_coarse_sp, dense_cap=dense_cap, dtype=dtype, level_layout=level_layout,
                omega=omega, nu=nu, device=device)
            tails[device] = (_make_vcycle(levels, coarse_apply, nu, smoother=smoother),
                             levels, coarse_residual)
        return tails[device]

    def make_local_apply(shards, group):
        if group.n_shards != n_shards:
            raise ValueError(f"built for {n_shards} shards, the group has {group.n_shards}")
        tail, tail_levels, coarse_residual = tail_of(group.device)
        names = ("A_b", "A_c", "invd", "PT_b", "PT_c", "P_b", "P_c")
        lv = [dict(zip(names, shards[7 * l:7 * l + 7])) for l in range(split)]
        # each level's products, ``vs -> [y_i]`` over the gathered source
        # vector: A and Pᵀ read level l's, P level l + 1's
        prods = [{op: _bell_products(lv[l][op + "_b"], lv[l][op + "_c"], padded[l + (op == "P")])
                  for op in ("A", "PT", "P")} for l in range(split)]

        def lmv(l, op, vs):
            bn = per_level_bn[l][op == "P"]
            return prods[l][op](group.all_gather(vs).reshape(-1, bn))

        def a_mv(l, vs):
            return lmv(l, "A", vs)

        def tail_at_split(bs):
            full = group.all_gather(bs)
            z_full = torch.zeros_like(full)
            z_full[:n_split] = tail(0, full[:n_split])
            r = rps[split]
            return [z_full[s * r:(s + 1) * r] for s in group.shards]

        def sweep(l, us, bs):
            invd = lv[l]["invd"]
            return [u + invd[i] * (b - y) for i, (u, b, y) in enumerate(zip(us, bs, a_mv(l, us)))]

        def cheb_from(l, us, ds, bs, coeffs):
            invd = lv[l]["invd"]
            for c_d, c_z in coeffs:
                zs = [invd[i] * (b - y) for i, (b, y) in enumerate(zip(bs, a_mv(l, us)))]
                ds = [c_d * d + c_z * z for d, z in zip(ds, zs)]
                us = [u + d for u, d in zip(us, ds)]
            return us

        def pre_smooth(l, bs):
            invd = lv[l]["invd"]
            if smoother == "chebyshev":
                step1, coeffs = cheb_steps[l]
                ds = [step1 * (invd[i] * b) for i, b in enumerate(bs)]
                return cheb_from(l, ds, ds, bs, coeffs)
            us = [invd[i] * b for i, b in enumerate(bs)]  # the first sweep from zero
            for _ in range(nu - 1):
                us = sweep(l, us, bs)
            return us

        def post_smooth(l, us, bs):
            invd = lv[l]["invd"]
            if smoother == "chebyshev":
                step1, coeffs = cheb_steps[l]
                zs = [invd[i] * (b - y) for i, (b, y) in enumerate(zip(bs, a_mv(l, us)))]
                ds = [step1 * z for z in zs]
                us = [u + d for u, d in zip(us, ds)]
                return cheb_from(l, us, ds, bs, coeffs)
            for _ in range(nu):
                us = sweep(l, us, bs)
            return us

        def v_cycle(l, bs):
            if l == split:
                return tail_at_split(bs)
            e = lv[l]
            us = pre_smooth(l, bs)
            rs = [b - y for b, y in zip(bs, a_mv(l, us))]
            rcs = lmv(l, "PT", rs)
            ecs = v_cycle(l + 1, rcs)
            us = [u + y for u, y in zip(us, lmv(l, "P", ecs))]
            return post_smooth(l, us, bs)

        def residual(rs, zs):
            if split:
                return [r - y for r, y in zip(rs, a_mv(0, zs))]
            # the whole hierarchy replicated: the tail's first operator (or
            # the coarse solve's) on the gathered vectors
            full_z, full_r = group.all_gather(zs), group.all_gather(rs)
            if tail_levels:
                res = full_r[:n_split] - tail_levels[0]["A"].matvec(full_z[:n_split])
            else:
                res = coarse_residual(full_r[:n_split], full_z[:n_split])
            res_full = torch.zeros_like(full_r)
            res_full[:n_split] = res
            return [res_full[s * rps[0]:(s + 1) * rps[0]] for s in group.shards]

        def apply(rs):
            zs = v_cycle(0, rs)
            for _ in range(cycles - 1):
                zs = [z + e for z, e in zip(zs, v_cycle(0, residual(rs, zs)))]
            return zs

        return apply

    pre = ShardedPreconditioner(op_arrays=tuple(op_arrays), make_local_apply=make_local_apply,
                                collective=True)
    pre.level_sizes = tuple(sizes)
    pre.n_levels = L + 1
    pre.split = split
    pre.stalled_coarse = bool(A_coarse_sp.shape[0] > dense_cap)
    return pre
