"""Host-side partitioners and the shard group of the row-sharded solves.
Counterpart of ``conjugategradient_tpu/parallel/partition.py``.

Each partitioner is the JAX package's host numpy code over this package's
packers (``types/bell.pack_host_arrays`` and ``SymBellMatrix._pack_np``,
``types/sell._sell_pack_rows``, themselves bitwise-equal to the JAX ones),
so both packages hold the same per-shard arrays bit for bit.
``make_row_mesh`` takes the place of the JAX 1-D device mesh: it returns an
in-process shard group (``collectives.InProcessGroup``) that runs every
shard on one device; ``make_mesh_2d`` the p × p one
(``collectives.InProcessMesh2D``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..types.base import DEFAULT_DEVICE
from ..types.bell import SymBellMatrix, pack_host_arrays
from ..types.sell import _sell_pack_rows
from .collectives import InProcessGroup, InProcessMesh2D


def make_row_mesh(n_shards: int = 1, device=DEFAULT_DEVICE) -> InProcessGroup:
    """A group of ``n_shards`` row shards, all on ``device`` (the card
    unless the caller names another)."""
    return InProcessGroup(n_shards, device)


def make_mesh_2d(p: int, device=DEFAULT_DEVICE) -> InProcessMesh2D:
    """A p × p block grid, every block on ``device`` (the card unless the
    caller names another): the 2-D decomposition's substrate.  The JAX
    function takes a device list and axis names; here the grid is one
    process's, and ``DistributedGroup.mesh_2d(p)`` spreads it over p²
    processes."""
    return InProcessMesh2D(p, device)


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


def partition_sell_rows(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    shape: Tuple[int, int],
    n_shards: int,
):
    """Split host CSR into shape-homogeneous per-shard SELL row blocks:
    each shard's off-diagonal entries in degree-bucketed slabs with GLOBAL
    column ids (one bucket ladder for every shard, per-bucket row counts
    maxed over the shards).  Returns ``(diag (S, m), pos (S, m), cols_flat
    (S, T), vals_flat (S, T), bucket_meta, n_padded)`` as numpy, for
    :func:`~.sharded_cg.sharded_sell_cg_solve`."""
    return _sell_pack_rows(data, indices, indptr, shape, n_shards)


def partition_symbell_rows(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    shape: Tuple[int, int],
    n_shards: int,
    bn: int = 128,
):
    """Split host CSR into per-shard SYMMETRIC blocked-ELL row blocks.

    Intra-shard tiles (block-row and block-column inside the shard) keep
    symmetric storage, their mirror landing in the shard's own rows;
    cross-shard tiles are stored fully on the row-owning shard, packed
    compactly: only the block-rows that own one get slots, addressed by a
    local row index.  Returns ``(diag (S, nrb, bn, bn), off (S, nrb, ku, bn,
    bn), off_cols (S, nrb, ku) LOCAL block ids, cross (S, nxr, kx, bn, bn),
    cross_rows (S, nxr) LOCAL block ids, cross_cols (S, nxr, kx) GLOBAL
    block ids, n_padded)`` as numpy, for
    :func:`~.sharded_cg.sharded_symbell_cg_solve`.
    """
    n, ncols = shape
    rows_per_shard = _cdiv(_cdiv(n, n_shards), bn) * bn
    n_padded = rows_per_shard * n_shards

    data = np.asarray(data)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)

    def sub_csr(rows_sub, cols_sub, vals_sub, n_rows):
        counts = np.bincount(rows_sub, minlength=n_rows)
        sub_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        order = np.lexsort((cols_sub, rows_sub))
        return vals_sub[order], cols_sub[order], sub_indptr

    syms, crosses = [], []
    for s in range(n_shards):
        r0 = min(s * rows_per_shard, n)
        r1 = min((s + 1) * rows_per_shard, n)
        lo, hi = indptr[r0], indptr[r1]
        rows_l = np.repeat(np.arange(r0, r1), np.diff(indptr[r0:r1 + 1])) - r0
        cols_g = indices[lo:hi]
        vals = data[lo:hi]
        base = s * rows_per_shard
        intra = (cols_g >= base) & (cols_g < base + rows_per_shard)

        v_i, c_i, p_i = sub_csr(rows_l[intra], cols_g[intra] - base, vals[intra],
                                rows_per_shard)
        blocks_i, cols_i, nnz_i = pack_host_arrays(
            v_i, c_i, p_i, (rows_per_shard, rows_per_shard), bm=bn, bn=bn)
        # the intra block of a symmetric matrix is symmetric by
        # construction: no re-verify
        syms.append(SymBellMatrix._pack_np(
            blocks_i, cols_i.astype(np.int64), (rows_per_shard, rows_per_shard),
            (rows_per_shard, rows_per_shard), nnz_i, False, device="cpu"))

        v_x, c_x, p_x = sub_csr(rows_l[~intra], cols_g[~intra], vals[~intra], rows_per_shard)
        xb, xc, _ = pack_host_arrays(v_x, c_x, p_x, (rows_per_shard, ncols), bm=bn, bn=bn)
        # compact to the block-rows that own a cross tile
        nonzero_rows = np.nonzero(np.abs(xb).sum(axis=(1, 2, 3)) > 0)[0].astype(np.int32)
        crosses.append((xb[nonzero_rows], xc[nonzero_rows], nonzero_rows))

    nrb = rows_per_shard // bn
    ku = max(sy.ku for sy in syms)
    nxr = max(max(len(r) for _, _, r in crosses), 1)
    kx = max(max((b.shape[1] for b, _, _ in crosses if b.size), default=1), 1)
    dt = syms[0].diag_blocks.numpy().dtype
    diag = np.zeros((n_shards, nrb, bn, bn), dtype=dt)
    off = np.zeros((n_shards, nrb, ku, bn, bn), dtype=dt)
    # local padding slots point at their own (local) row with zero tiles
    off_cols = np.tile(np.arange(nrb, dtype=np.int32)[None, :, None], (n_shards, 1, ku))
    cross = np.zeros((n_shards, nxr, kx, bn, bn), dtype=dt)
    cross_rows = np.zeros((n_shards, nxr), dtype=np.int32)
    cross_cols = np.zeros((n_shards, nxr, kx), dtype=np.int32)
    for s, (sy, (xb, xc, xr)) in enumerate(zip(syms, crosses)):
        diag[s] = sy.diag_blocks.numpy()
        off[s, :, :sy.ku] = sy.off_blocks.numpy()
        off_cols[s, :, :sy.ku] = sy.off_cols.numpy()
        if len(xr):
            cross[s, :len(xr), :xb.shape[1]] = xb
            cross_rows[s, :len(xr)] = xr
            cross_cols[s, :len(xr), :xb.shape[1]] = xc
    return diag, off, off_cols, cross, cross_rows, cross_cols, n_padded


def partition_csr_blocks_2d(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    shape: Tuple[int, int],
    p: int,
    bm: int = 128,
    bn: int = 128,
):
    """Split host CSR into a p × p grid of blocked-ELL blocks (the 2-D
    decomposition): block (i, j) holds rows [i·S, (i+1)·S) × columns
    [j·S, (j+1)·S) with LOCAL column indices, S the stripe (n / p rounded
    up to a multiple of bm).  kmax is taken over all p² blocks, so banded
    patterns pay empty-block padding (use the DIA ring for them).

    Returns ``(blocks (p, p, nrb, kmax, bm, bn), block_cols (p, p, nrb,
    kmax) LOCAL, n_padded)`` as numpy, for
    :func:`~.sharded_cg.sharded_cg_solve_2d`.
    """
    n, ncols = shape
    if n != ncols:
        raise ValueError(f"2-D decomposition needs a square system, got {shape}")
    if bm != bn:
        raise ValueError("2-D decomposition needs square tiles (stripes "
                         "serve as both row and column ranges)")
    stripe = _cdiv(_cdiv(n, p), bm) * bm
    n_padded = stripe * p

    data = np.asarray(data)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)

    packed = []
    for i in range(p):
        r0 = min(i * stripe, n)
        r1 = min((i + 1) * stripe, n)
        lo, hi = indptr[r0], indptr[r1]
        rows_l = np.repeat(np.arange(r0, r1), np.diff(indptr[r0:r1 + 1])) - r0
        cols_g = indices[lo:hi]
        vals = data[lo:hi]
        row_of = []
        for j in range(p):
            c0 = j * stripe
            sel = (cols_g >= c0) & (cols_g < c0 + stripe)
            rows_s, cols_s, vals_s = rows_l[sel], cols_g[sel] - c0, vals[sel]
            counts = np.bincount(rows_s, minlength=stripe)
            sub_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            order = np.lexsort((cols_s, rows_s))
            blocks, block_cols, _ = pack_host_arrays(
                vals_s[order], cols_s[order], sub_indptr, (stripe, stripe), bm=bm, bn=bn)
            row_of.append((blocks, block_cols))
        packed.append(row_of)

    nrb = stripe // bm
    kmax = max(bb.shape[1] for row in packed for bb, _ in row)
    blocks = np.zeros((p, p, nrb, kmax, bm, bn), dtype=packed[0][0][0].dtype)
    block_cols = np.zeros((p, p, nrb, kmax), dtype=np.int32)
    for i in range(p):
        for j in range(p):
            bb, bc = packed[i][j]
            blocks[i, j, :, :bb.shape[1]] = bb
            block_cols[i, j, :, :bc.shape[1]] = bc
    return blocks, block_cols, n_padded


def partition_dia_rows(
    diags: np.ndarray,
    shape: Tuple[int, int],
    n_shards: int,
):
    """Split DIA diagonals into equal row shards.  Returns ``(diags_sharded
    (n_shards, ndiag, rows_per_shard), n_padded)`` as numpy; padding rows
    carry zero diagonal slots, so they stay inert."""
    diags = np.asarray(diags)
    ndiag, n_stored = diags.shape
    n = shape[0]
    rows_per_shard = _cdiv(n, n_shards)
    n_padded = rows_per_shard * n_shards
    dp = np.zeros((ndiag, n_padded), dtype=diags.dtype)
    dp[:, :n_stored] = diags
    out = dp.reshape(ndiag, n_shards, rows_per_shard).transpose(1, 0, 2)
    return np.ascontiguousarray(out), n_padded
