"""Per-shard local matvec of the row-sharded solve.  Counterpart of the
blocked-ELL part of ``conjugategradient_tpu/parallel/local_ops.py``.

It runs on one shard's tiles against the all-gathered operand, through the
port's blocked-ELL apply with its usual dispatch (``ops/spmv._kernel_route``):
the hand-written SpMV kernel (``bell_spmv``) for a float32 result on a CUDA
device, the plain einsum otherwise, with the JAX package's dtype promotion
so float64 runs keep oracle parity.
"""

from __future__ import annotations

import torch

from ..ops.spmv import _acc, _kernel_route, bell_apply


def _local_bell_matvec(blocks, block_cols, p_full_2d):
    """(nrb·bm,) = shard tiles @ the gathered operand (ncb, bn)."""
    out_dtype = torch.promote_types(blocks.dtype, p_full_2d.dtype)
    if _kernel_route("auto", p_full_2d, out_dtype):
        from ..ops.cuda.bell_spmv import bell_spmv_tiles

        return bell_spmv_tiles(blocks, block_cols, p_full_2d.to(torch.float32))
    acc = _acc(out_dtype)
    y = bell_apply(blocks.to(acc), block_cols, p_full_2d.to(acc))
    return y.reshape(-1).to(out_dtype)
