"""Bandwidth-reducing reordering (reverse Cuthill–McKee) and the degree
sort.  Counterpart of ``conjugategradient_tpu/reorder.py``: the same numpy
code (host-side, done once at ingest), so both packages give bitwise-equal
permutations.

The fast sparse layouts waste bandwidth in proportion to how scattered a
matrix's column footprint is: RCM permutes a symmetric matrix so its
nonzeros hug the diagonal, which for blocked-ELL means fewer tiles per
block-row.  For an SPD system, solving ``(P A Pᵀ) y = P b`` and returning
``x = Pᵀ y`` is exact — apply/undo with :func:`permute_vector` /
:func:`unpermute_vector`, which take torch tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rcm_permutation(indices: np.ndarray, indptr: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of a symmetric sparsity pattern.

    Returns ``perm`` with ``perm[new] = old`` (gather convention): row
    ``perm[0]`` of A becomes row 0 of the reordered matrix.  Handles
    disconnected components; within each, BFS starts from a minimum-degree
    vertex and visits neighbors in increasing-degree order.
    """
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    if len(indptr) - 1 != n:
        raise ValueError(f"indptr describes {len(indptr)-1} rows, expected {n}")
    if len(indices) and (indices.min() < 0 or indices.max() >= n):
        raise ValueError(
            "column index out of range for a square symmetric pattern "
            f"(n={n}); RCM requires a square matrix"
        )
    degrees = np.diff(indptr)

    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0

    # process components in order of their minimum-degree seed
    seeds = np.argsort(degrees, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        # Level-synchronous BFS, fully vectorized per frontier (a per-vertex
        # Python loop is minutes at the framework's 1.5M+-row target sizes).
        # Visit order matches the textbook scalar RCM exactly: parents in
        # frontier order, each parent's unvisited neighbors in (degree,
        # vertex-id) order, a shared vertex claimed by its earliest parent —
        # i.e. first occurrence under lexsort(parent_pos, degree, id).
        visited[seed] = True
        order[pos] = seed
        pos += 1
        frontier = np.array([seed], dtype=np.int64)
        while len(frontier):
            counts = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
            total = int(counts.sum())
            if total == 0:
                break
            # gather all frontier adjacency lists in one shot
            starts = indptr[frontier]
            offs = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            nbrs = indices[np.repeat(starts, counts) + offs]
            parent_pos = np.repeat(
                np.arange(len(frontier), dtype=np.int64), counts
            )
            keep = ~visited[nbrs]
            nbrs, parent_pos = nbrs[keep], parent_pos[keep]
            if len(nbrs) == 0:
                break
            sel = np.lexsort((nbrs, degrees[nbrs], parent_pos))
            nbrs = nbrs[sel]
            # keep each vertex's FIRST occurrence in the visit order (a
            # stable value-sort scan — np.unique's indices would give first
            # in value order, which is not the same thing)
            first = np.zeros(len(nbrs), dtype=bool)
            order_idx = np.argsort(nbrs, kind="stable")
            sorted_nbrs = nbrs[order_idx]
            is_first_sorted = np.ones(len(nbrs), dtype=bool)
            is_first_sorted[1:] = sorted_nbrs[1:] != sorted_nbrs[:-1]
            first[order_idx] = is_first_sorted
            nxt = nbrs[first]
            visited[nxt] = True
            order[pos : pos + len(nxt)] = nxt
            pos += len(nxt)
            frontier = nxt
    assert pos == n, "graph traversal missed vertices"
    return order[::-1].copy()  # the "reverse" in RCM


def permute_csr(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    shape: Tuple[int, int],
    perm: np.ndarray,
):
    """Symmetric permutation P A Pᵀ of a square CSR matrix.

    ``perm[new] = old``.  Returns new (data, indices, indptr) with rows
    sorted by column within each row.
    """
    n = shape[0]
    if shape[0] != shape[1]:
        raise ValueError("symmetric permutation needs a square matrix")
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)

    indptr = np.asarray(indptr, dtype=np.int64)
    data = np.asarray(data)
    indices = np.asarray(indices, dtype=np.int64)
    # fully vectorized: relabel every entry's (row, col) through inv, then
    # one lexsort — O(nnz log nnz) in C rather than a Python loop over rows
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    new_rows = inv[row_ids]
    new_cols = inv[indices]
    order = np.lexsort((new_cols, new_rows))
    new_data = data[order]
    new_indices = new_cols[order]
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rows, minlength=n), out=new_indptr[1:])
    return new_data, new_indices, new_indptr


def permute_vector(v: torch.Tensor, perm) -> torch.Tensor:
    """b -> P b (reordered space)."""
    return v[torch.as_tensor(perm, device=v.device)]


def unpermute_vector(v: torch.Tensor, perm) -> torch.Tensor:
    """y -> Pᵀ y (back to the original ordering)."""
    out = torch.empty_like(v)
    out[torch.as_tensor(perm, device=v.device)] = v
    return out


def bandwidth(indices: np.ndarray, indptr: np.ndarray) -> int:
    """max |i - j| over stored entries — the quantity RCM minimizes."""
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = len(indptr) - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    if len(row_ids) == 0:
        return 0
    return int(np.max(np.abs(row_ids - indices)))


def count_diagonals(indices: np.ndarray, indptr: np.ndarray) -> int:
    """Number of distinct diagonals touched (DIA storage rows needed)."""
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = len(indptr) - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return int(len(np.unique(indices - row_ids)))


def degree_sort_permutation(
    indices: np.ndarray, indptr: np.ndarray, n: int
) -> np.ndarray:
    """Stable off-diagonal-degree sort — the SELL-layout enabler.

    Returns ``perm`` with ``perm[new] = old`` (same gather convention as
    :func:`rcm_permutation`).  Applying it symmetrically puts rows in the
    exact order ``SellMatrix``'s degree bucketing would sort them into, so
    the packed layout's ``pos`` becomes the identity and the matvec skips
    its order-restore gather (~20% of the gather-bound matvec at 1.5M
    rows — the per-row result is already in row order).  RCM is the
    analogous enabler for the DIA layout; this is the scattered-pattern
    counterpart, used by ``load_matrix(reorder=True)`` when the layout
    resolves to sell.
    """
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    if len(indptr) - 1 != n:
        raise ValueError(f"indptr describes {len(indptr)-1} rows, expected {n}")
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    off_deg = np.bincount(row_ids[indices != row_ids], minlength=n)
    return np.argsort(off_deg, kind="stable").astype(np.int64)
