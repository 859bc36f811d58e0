"""SELL (sliced-ELL, degree-bucketed) layout on torch tensors — the
container for scattered, power-law patterns where DIA and blocked-ELL pad
too much.  Counterpart of ``conjugategradient_tpu/types/sell.py``: the host
packer is the same numpy code, so both packages hold bitwise-equal slabs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import DEFAULT_DEVICE, LinearOperator, as_numpy_dtype
from .csr import CSRMatrix


def _sell_ladder(max_degree: int) -> Tuple[int, ...]:
    """Geometric row-width ladder {1,2,3,4,6,8,12,16,...}: padding a row to
    the next rung wastes at most 50% of its slots."""
    ks = []
    k = 1
    while k < max_degree:
        ks += [k, k + (k + 1) // 2] if k > 1 else [1, 2]
        k *= 2
    ks = sorted({v for v in ks if v <= max_degree} | {max_degree})
    return tuple(ks)


def _sell_pack_rows(data, indices, indptr, shape, n_shards: int):
    """Host-side CSR → degree-bucketed SELL slabs, split into ``n_shards``
    shape-homogeneous row blocks.

    Rows bucket by off-diagonal degree on one global geometric ladder;
    every shard's per-bucket row count is maxed over shards (virtual padding
    rows own all-zero slab space that ``pos`` never references); the main
    diagonal splits out as a stream; each row's entries keep CSR order
    inside its slab.  Column indices stay global.

    Returns ``(diag (S, m), pos (S, m) int32, cols_flat (S, T) int32,
    vals_flat (S, T), bucket_meta, n_padded)`` with ``m = n_padded /
    n_shards``.
    """
    n = shape[0]
    m = -(-n // n_shards)
    n_padded = m * n_shards
    data = np.asarray(data)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    on_diag = indices == row_ids
    deg = np.bincount(row_ids[~on_diag], minlength=n).astype(np.int64)
    max_deg = int(deg.max()) if len(deg) else 0

    # one global ladder; k=0 collects degree-0 (and virtual padding) rows
    ladder = (
        np.asarray(_sell_ladder(max_deg), dtype=np.int64)
        if max_deg > 0
        else np.zeros((0,), np.int64)
    )
    k_of_row = np.zeros(n_padded, np.int64)
    if max_deg > 0:
        k_of_row[:n] = np.where(deg > 0, ladder[np.searchsorted(ladder, deg)], 0)
    ks_all = np.concatenate([[0], ladder])
    shard_of_row = np.arange(n_padded, dtype=np.int64) // m
    k_idx = np.searchsorted(ks_all, k_of_row)
    counts = np.zeros((n_shards, len(ks_all)), np.int64)
    np.add.at(counts, (shard_of_row, k_idx), 1)
    nb_max = counts.max(axis=0)
    keep = nb_max > 0
    ks, nb = ks_all[keep], nb_max[keep]
    meta = tuple((int(b), int(k)) for b, k in zip(nb, ks))
    k_idx = np.searchsorted(ks, k_of_row)  # every row's k survives keep

    slab_sizes = nb * ks
    slab_base = np.concatenate([[0], np.cumsum(slab_sizes)[:-1]])
    sorted_base = np.concatenate([[0], np.cumsum(nb)[:-1]])
    total = int(slab_sizes.sum())

    # rank of each row within its (shard, bucket) group, row order kept
    grp = shard_of_row * len(ks) + k_idx
    order = np.argsort(grp, kind="stable")
    grp_sorted = grp[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(grp_sorted)) + 1])
    run_lengths = np.diff(np.concatenate([starts, [n_padded]]))
    rank = np.empty(n_padded, np.int64)
    rank[order] = np.arange(n_padded) - np.repeat(starts, run_lengths)

    diag = np.zeros((n_shards, m), dtype=data.dtype)
    dr = row_ids[on_diag]
    np.add.at(diag, (dr // m, dr % m), data[on_diag])
    pos = (sorted_base[k_idx] + rank).astype(np.int32).reshape(n_shards, m)

    off_r = row_ids[~on_diag]
    off_c = indices[~on_diag]
    off_v = data[~on_diag]
    off_row_start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(off_r), dtype=np.int64) - off_row_start[off_r]
    row_start = slab_base[k_idx] + rank * ks[k_idx]  # (n_padded,)
    flat_idx = row_start[off_r] + slot
    cols_flat = np.zeros((n_shards, total), dtype=np.int32)
    vals_flat = np.zeros((n_shards, total), dtype=data.dtype)
    cols_flat[shard_of_row[off_r], flat_idx] = off_c.astype(np.int32)
    vals_flat[shard_of_row[off_r], flat_idx] = off_v
    return diag, pos, cols_flat, vals_flat, meta, n_padded


@dataclasses.dataclass(frozen=True)
class SellMatrix(LinearOperator):
    """Degree-bucketed ELL: rows grouped into buckets by off-diagonal
    degree, each bucket a dense row-major (nb, k) slab of columns and
    values, all slabs back to back in ``cols_flat``/``vals_flat`` (padding
    slots: column 0, value 0, so the matvec needs no mask).  The main
    diagonal is a separate stream (``diag``, which is also ``diagonal()``),
    and ``pos[i]`` is row i's place in the degree-sorted concatenation.
    ``pos_identity`` is True when rows already arrive in bucket order
    (after ``reorder.degree_sort_permutation``), and the matvec then skips
    the order-restore gather.
    """

    diag: torch.Tensor  # (n,)
    pos: torch.Tensor  # (n,) int32
    cols_flat: torch.Tensor  # (total_slots,) int32
    vals_flat: torch.Tensor  # (total_slots,)
    bucket_meta: Tuple[Tuple[int, int], ...]  # per bucket: (nb, k)
    shape: Tuple[int, int]
    nnz: int  # true nnz (before padding)
    pos_identity: bool = False

    @staticmethod
    def from_csr_host(
        data: np.ndarray,
        indices: np.ndarray,
        indptr: np.ndarray,
        shape: Tuple[int, int],
        dtype=None,
        device=DEFAULT_DEVICE,
    ) -> "SellMatrix":
        """Host-side CSR → bucketed ELL (the single-shard case of
        :func:`_sell_pack_rows`), then one copy to ``device``."""
        data = np.asarray(data)
        if dtype is not None:
            data = data.astype(as_numpy_dtype(dtype))
        diag, pos, cols_flat, vals_flat, meta, _ = _sell_pack_rows(
            data, indices, indptr, shape, 1
        )
        dev = torch.device(device)
        return SellMatrix(
            *(torch.from_numpy(a[0]).to(dev) for a in (diag, pos, cols_flat, vals_flat)),
            meta,
            tuple(shape),
            int(len(data)),
            pos_identity=bool(
                np.array_equal(pos[0], np.arange(shape[0], dtype=pos.dtype))
            ),
        )

    @staticmethod
    def from_csr(csr: CSRMatrix) -> "SellMatrix":
        """Repack a ``CSRMatrix`` (host round trip), on its device."""
        return SellMatrix.from_csr_host(
            csr.data.cpu().numpy(), csr.indices.cpu().numpy(),
            csr.indptr.cpu().numpy(), csr.shape, device=csr.device,
        )

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def to(self, device) -> "SellMatrix":
        return dataclasses.replace(
            self, diag=self.diag.to(device), pos=self.pos.to(device),
            cols_flat=self.cols_flat.to(device),
            vals_flat=self.vals_flat.to(device),
        )

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import sell_spmv

        return sell_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        return self.diag

    def to_dense(self) -> torch.Tensor:
        n, ncols = self.shape
        dev = self.device
        out = torch.zeros((n, ncols), dtype=self.dtype, device=dev)
        idx = torch.arange(n, device=dev)
        out.index_put_((idx, idx), self.diag, accumulate=True)
        row_perm = torch.argsort(self.pos.long())
        start, base = 0, 0
        for nb, k in self.bucket_meta:
            if k == 0:
                start += nb
                continue
            cb = self.cols_flat[base: base + nb * k].long()
            vb = self.vals_flat[base: base + nb * k]
            rows = torch.repeat_interleave(row_perm[start: start + nb], k)
            # padding slots carry value 0: adding them is harmless
            out.index_put_((rows, cb), vb, accumulate=True)
            start += nb
            base += nb * k
        return out

    def memory_footprint(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.diag, self.pos, self.cols_flat, self.vals_flat))

    def padding_ratio(self) -> float:
        """Stored slots / true nnz — the bandwidth overhead of the layout."""
        slots = self.diag.numel() + self.vals_flat.numel()
        return float(slots) / max(self.nnz, 1)

    def astype(self, dtype) -> "SellMatrix":
        return dataclasses.replace(self, diag=self.diag.to(dtype),
                                   vals_flat=self.vals_flat.to(dtype))
