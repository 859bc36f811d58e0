"""Host-side partitioner and the shard group of the row-sharded solve.
Counterpart of ``conjugategradient_tpu/parallel/partition.py``.

``partition_csr_rows`` is the JAX package's host numpy code over this
package's blocked-ELL packer (``types/bell.pack_host_arrays``, itself
bitwise-equal to the JAX one), so both packages hold the same per-shard
tiles bit for bit.  ``make_row_mesh`` takes the place of the JAX 1-D device
mesh: it returns an in-process shard group (``collectives.InProcessGroup``)
that runs every shard on one device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..types.base import DEFAULT_DEVICE
from ..types.bell import pack_host_arrays
from .collectives import InProcessGroup


def make_row_mesh(n_shards: int = 1, device=DEFAULT_DEVICE) -> InProcessGroup:
    """A group of ``n_shards`` row shards, all on ``device`` (the card
    unless the caller names another)."""
    return InProcessGroup(n_shards, device)


def _cdiv(a, b):
    return -(-a // b)


def partition_csr_rows(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    shape: Tuple[int, int],
    n_shards: int,
    bm: int = 128,
    bn: int = 128,
):
    """Split host CSR into per-shard blocked-ELL row blocks.

    Every shard gets the same number of padded row-blocks and the same kmax
    (global maximum), so the shards have one shape.  Column-block indices
    stay GLOBAL: the SpMV gathers from the all-gathered operand.  Returns
    (blocks (n_shards, nrb, kmax, bm, bn), block_cols (n_shards, nrb, kmax)
    int32, n_padded) as numpy.
    """
    n, ncols = shape
    rows_per_shard = _cdiv(_cdiv(n, n_shards), bm) * bm
    n_padded = rows_per_shard * n_shards

    indptr = np.asarray(indptr, dtype=np.int64)
    shard_tiles = []
    for s in range(n_shards):
        r0 = min(s * rows_per_shard, n)
        r1 = min((s + 1) * rows_per_shard, n)
        lo, hi = indptr[r0], indptr[r1]
        sub_indptr = np.concatenate(
            [
                indptr[r0 : r1 + 1] - lo,
                np.full(rows_per_shard - (r1 - r0), indptr[r1] - lo, dtype=np.int64),
            ]
        )
        blocks, block_cols, _ = pack_host_arrays(
            np.asarray(data)[lo:hi],
            np.asarray(indices)[lo:hi],
            sub_indptr,
            (rows_per_shard, ncols),
            bm=bm,
            bn=bn,
        )
        shard_tiles.append((blocks, block_cols))

    kmax = max(b.shape[1] for b, _ in shard_tiles)
    nrb = max(b.shape[0] for b, _ in shard_tiles)
    blocks = np.zeros((n_shards, nrb, kmax, bm, bn), dtype=shard_tiles[0][0].dtype)
    block_cols = np.zeros((n_shards, nrb, kmax), dtype=np.int32)
    for s, (bb, bc) in enumerate(shard_tiles):
        blocks[s, : bb.shape[0], : bb.shape[1]] = bb
        block_cols[s, : bc.shape[0], : bc.shape[1]] = bc
    return blocks, block_cols, n_padded
