"""Row-sharded FSAI preconditioner.  Counterpart of
``conjugategradient_tpu/parallel/sharded_fsai.py``.

The FSAI apply is two products, z = Gᵀ(G r); over row shards each is the
solver's own sharded product — all_gather the input, multiply the shard's
blocked-ELL rows — so an apply costs two all_gathers an iteration on top
of the solve's collectives.  G is built ONCE on the host by the one-card
setup (``solver/fsai._build_g_host``, the same factor) and partitioned as
the sharded AMG levels are (bm = bn = gcd(rows a shard, 8): packed kernel
5 for float32 on the card, the plain einsum for float64 and on the CPU).
"""

from __future__ import annotations

from typing import Any

import torch

from ..solver.amg import _to_scipy_csr, _torch_dtype
from ..solver.fsai import _build_g_host
from ..types import CSRMatrix
from .local_ops import _bell_products
from .sharded_amg import _block_of, _partition_level_op
from .sharded_cg import ShardedPreconditioner


def sharded_fsai_preconditioner(
    A: Any,
    n_shards: int,
    n_padded: int,
    *,
    axis: str = "rows",
    power: int = 1,
    dtype=None,
) -> ShardedPreconditioner:
    """The row-sharded FSAI ``M_local`` for
    :func:`~conjugategradient_tpu_torch.parallel.sharded_cg_solve`.

    Arguments as :func:`~conjugategradient_tpu_torch.fsai_preconditioner`
    plus the sharding: ``n_shards`` (the group's size) and ``n_padded``
    (the SOLVER's padded size, the third return of ``partition_csr_rows``,
    so the factor's row shards line up with the CG loop's vectors);
    ``axis`` is accepted as the JAX signature has it and not read.

    Returns a collective :class:`~.sharded_cg.ShardedPreconditioner` whose
    sharded arrays are G's and Gᵀ's row blocks (a process holds only its
    shards' rows of both).  Diagnostics: ``.nnz``, ``.G_host``, ``.power``.
    """
    del axis
    if dtype is None:
        dtype = A.dtype if isinstance(A, CSRMatrix) else torch.get_default_dtype()
    dtype = _torch_dtype(dtype)
    A_sp = _to_scipy_csr(A)
    n = A_sp.shape[0]
    if A_sp.shape[0] != A_sp.shape[1]:
        raise ValueError(f"FSAI needs a square operator, got {A_sp.shape}")
    if n_padded < n:
        raise ValueError(f"n_padded={n_padded} < matrix size {n}")
    if n_padded % n_shards:
        raise ValueError(f"n_padded={n_padded} not divisible by n_shards={n_shards}")

    G_sp = _build_g_host(A_sp, power)
    rps = n_padded // n_shards
    bn = _block_of(rps)
    G_b, G_c = _partition_level_op(G_sp, n_shards, rps, n_padded, bn, dtype)
    Gt_b, Gt_c = _partition_level_op(G_sp.T.tocsr(), n_shards, rps, n_padded, bn, dtype)

    def make_local_apply(shards, group):
        if group.n_shards != n_shards:
            raise ValueError(f"built for {n_shards} shards, the group has {group.n_shards}")
        g_b, g_c, gt_b, gt_c = shards
        g, gt = _bell_products(g_b, g_c, n_padded), _bell_products(gt_b, gt_c, n_padded)

        def apply(rs):
            ys = g(group.all_gather(rs).reshape(-1, bn))
            return gt(group.all_gather(ys).reshape(-1, bn))

        return apply

    pre = ShardedPreconditioner(op_arrays=(G_b, G_c, Gt_b, Gt_c),
                                make_local_apply=make_local_apply, collective=True)
    pre.nnz = int(G_sp.nnz)
    pre.G_host = G_sp
    pre.power = power
    return pre
