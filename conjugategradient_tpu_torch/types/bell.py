"""Blocked-ELL on torch tensors — full storage (``BlockedEllMatrix``) and
symmetric upper-triangle storage (``SymBellMatrix``) — and the host packer
both are built from.  Counterpart of ``conjugategradient_tpu/types/bell.py``:
the packing is the same numpy code, so both packages hold bitwise-equal
tiles."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import DEFAULT_DEVICE, LinearOperator, _cdiv, as_numpy_dtype, cast_values
from .csr import CSRMatrix


def pack_host_arrays(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    shape: Tuple[int, int],
    bm: int = 128,
    bn: int = 128,
    dtype=None,
):
    """CSR -> full blocked-ELL as numpy arrays: ``(blocks, block_cols, nnz)``.

    ``blocks`` is (nrb, kmax, bm, bn), ``block_cols`` (nrb, kmax) int32;
    padding tiles are zero and point at column-block 0.  Uses the native
    C++ packer (native/ell_pack.cpp) when built, else the numpy fallback.
    """
    n, ncols = shape
    nrb = _cdiv(n, bm)
    ncb = _cdiv(ncols, bn)
    data = np.asarray(data)
    if dtype is not None:
        data = data.astype(as_numpy_dtype(dtype))
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    nnz = int(len(data))

    if data.dtype in (np.float32, np.float64):
        from ..io import native as _native

        if _native.available():
            blocks, block_cols, _ = _native.ell_pack_native(
                data, indices, indptr, shape, bm, bn, dtype=data.dtype
            )
            return blocks, np.asarray(block_cols, np.int32), nnz

    # numpy fallback, O(nnz log nnz): sort entries by (row-block,
    # col-block), find each row-block's distinct col-blocks from the sorted
    # runs, scatter all values in one np.add.at
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    rb = row_ids // bm
    cb = indices // bn
    order = np.lexsort((cb, rb))
    rb_s, cb_s = rb[order], cb[order]
    key = rb_s * np.int64(ncb) + cb_s
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    pair_rb = rb_s[first]
    pair_cb = cb_s[first]
    counts = np.bincount(pair_rb, minlength=nrb)
    kmax = max(int(counts.max()) if len(counts) else 1, 1)
    pair_slot = np.arange(len(pair_rb)) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]]
    )[pair_rb]
    block_cols = np.zeros((nrb, kmax), dtype=np.int32)
    block_cols[pair_rb, pair_slot] = pair_cb
    pair_idx_sorted = np.cumsum(first) - 1
    slot_sorted = pair_slot[pair_idx_sorted]
    slot = np.empty(len(slot_sorted), dtype=np.int64)
    slot[order] = slot_sorted

    blocks = np.zeros((nrb, kmax, bm, bn), dtype=data.dtype)
    np.add.at(
        blocks,
        (rb, slot, row_ids - rb * bm, indices - cb * bn),
        data,
    )
    return blocks, block_cols, nnz


#: rows per chunk of the packed view: one warp, one lane per row
PACK_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class PackedBell:
    """The nonzeros of a blocked-ELL operator, as SELL-32: a full
    operator's tiles (:func:`pack_nonzeros`), or symmetric storage's
    D + U + Uᵀ (:func:`pack_symmetric`, ``symmetric=True``).

    Rows (``rows = nrb * bm``, padding rows included) go in chunks of
    ``PACK_CHUNK``; row ``r``'s k-th nonzero sits at entry
    ``chunk_off[r // 32] + 32 * k + r % 32`` of ``vals`` and ``cols``, for
    ``k < row_len[r]``: column-major within a chunk, so a warp's loads of
    one k are one coalesced run.  ``cols`` are global columns (block column
    · bn + column in the tile) into x padded to ``ncols``.  Exact zeros,
    and with them the padding tiles, are dropped; entries past a row's
    length are zero and never read.  The order within a row is the one a
    product sums in; each packing function states its own.
    """

    vals: torch.Tensor  # (total,) tile dtype
    cols: torch.Tensor  # (total,) int32
    row_len: torch.Tensor  # (rows,) int32
    chunk_off: torch.Tensor  # (ceil(rows / 32) + 1,) int64
    nnz: int  # nonzeros kept
    ncols: int  # padded operand length
    symmetric: bool = False  # built from symmetric storage: D + U + Uᵀ

    @property
    def rows(self) -> int:
        return int(self.row_len.shape[0])

    def nbytes(self) -> int:
        """Bytes of the view: what one packed SpMV reads of the operator."""
        return sum(t.numel() * t.element_size()
                   for t in (self.vals, self.cols, self.row_len, self.chunk_off))


def _sell_layout(row, col, val, rows: int, ncols: int, symmetric: bool = False) -> PackedBell:
    """(row, column, value) triples -> :class:`PackedBell`.  The triples
    come sorted by row, each row's in the order its product is to sum
    them; ``row`` and ``col`` are int64 on ``val``'s device."""
    dev = val.device
    c = PACK_CHUNK
    row_len = torch.bincount(row, minlength=rows)
    pos = torch.arange(row.numel(), device=dev) - (torch.cumsum(row_len, 0) - row_len)[row]
    nchunk = _cdiv(rows, c)
    width = torch.nn.functional.pad(row_len, (0, nchunk * c - rows)).view(nchunk, c).amax(dim=1)
    chunk_off = torch.zeros(nchunk + 1, dtype=torch.int64, device=dev)
    chunk_off[1:] = torch.cumsum(width * c, 0)
    total = int(chunk_off[-1])
    at = chunk_off[row // c] + pos * c + row % c
    vals = val.new_zeros(total)
    vals[at] = val
    cols = torch.zeros(total, dtype=torch.int32, device=dev)
    cols[at] = col.to(torch.int32)
    return PackedBell(vals, cols, row_len.to(torch.int32), chunk_off, int(row.numel()), ncols,
                      symmetric)


def pack_nonzeros(blocks: torch.Tensor, block_cols: torch.Tensor, ncols: int) -> PackedBell:
    """Full blocked-ELL tiles -> :class:`PackedBell` for an operand padded
    to ``ncols``, with torch ops on the tiles' device (one-time set-up: it
    reads the whole tile stream).  Within a row the nonzeros keep the dense
    kernels' visiting order: slot, then column in the tile."""
    nrb, kmax, bm, bn = blocks.shape
    # nonzero walks the (block-row, row in tile, slot, column in tile)
    # view in order: each row's nonzeros come out in visiting order
    rb, m, k, j = torch.nonzero(blocks.permute(0, 2, 1, 3) != 0, as_tuple=True)
    return _sell_layout(rb * bm + m, block_cols[rb, k].long() * bn + j, blocks[rb, k, m, j],
                        nrb * bm, ncols)


def pack_symmetric(diag_blocks: torch.Tensor, off_blocks: torch.Tensor, off_cols: torch.Tensor,
                   ncols: int) -> PackedBell:
    """Symmetric blocked-ELL storage -> :class:`PackedBell` of the whole
    operator D + U + Uᵀ, with torch ops on the tiles' device (one-time
    set-up).  Each diagonal tile's nonzeros enter once; each upper tile's
    nonzero (r, c) enters as (r, c) and as its mirror (c, r), so the
    off-diagonal nonzeros are stored twice and a product needs no landing
    of mirrored rows.  Padding slots (zero tiles pointing at their own
    block-row) are dropped.  Within a row the nonzeros go in ascending
    global column (the three sources never share a column)."""
    nrb, bm, bn = diag_blocks.shape
    i, m, j = torch.nonzero(diag_blocks != 0, as_tuple=True)
    rows_d, cols_d, vals_d = i * bm + m, i * bn + j, diag_blocks[i, m, j]
    i, k, m, j = torch.nonzero(off_blocks != 0, as_tuple=True)
    tgt = off_cols[i, k].long()
    real = tgt != i  # a slot pointing at its own row is padding
    i, k, m, j, tgt = i[real], k[real], m[real], j[real], tgt[real]
    rows_u, cols_u, vals_u = i * bm + m, tgt * bn + j, off_blocks[i, k, m, j]
    row = torch.cat([rows_d, rows_u, cols_u])
    col = torch.cat([cols_d, cols_u, rows_u])
    order = torch.argsort(row * ncols + col)  # keys are distinct
    return _sell_layout(row[order], col[order], torch.cat([vals_d, vals_u, vals_u])[order],
                        nrb * bm, ncols, symmetric=True)


def _cached_pack(op, tensors, build) -> PackedBell:
    """``op``'s packed view, built by ``build()`` once and kept with the
    operator, keyed on the storage and version of ``tensors`` (an in-place
    change rebuilds it); builds are counted in ``LAUNCHES["bell_pack"]``."""
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    hit = op.__dict__.get("_packed")
    if hit is None or hit[0] != key:
        from ..ops.cuda._common import LAUNCHES
        from ..utils.tracing import annotate

        with annotate("bell.pack"):
            hit = (key, build())
        object.__setattr__(op, "_packed", hit)
        LAUNCHES["bell_pack"] += 1
    return hit[1]


def mirror_index(off_cols: np.ndarray) -> np.ndarray:
    """Transposed index of the upper tiles: row ``c`` lists the flat slots
    ``row * ku + k`` whose tile mirrors into block-row ``c``
    (``off_cols[row, k] == c`` with ``row < c``), in increasing ``row``
    order, padded with -1.  Shape (nrb, kin), kin >= 1.

    The fixed order is what makes the mirror landing deterministic on the
    GPU: block-row c sums its incoming Bᵀ·p contributions in this order
    instead of through atomics.  Padding slots (pointing at their own row)
    never appear.
    """
    off_cols = np.asarray(off_cols, dtype=np.int64)
    nrb, ku = off_cols.shape
    rows = np.repeat(np.arange(nrb, dtype=np.int64), ku)
    tgt = off_cols.reshape(-1)
    real = tgt > rows
    slots = np.flatnonzero(real)  # increasing slot => increasing row
    tgt = tgt[real]
    order = np.argsort(tgt, kind="stable")
    slots, tgt = slots[order], tgt[order]
    counts = np.bincount(tgt, minlength=nrb)
    kin = max(int(counts.max()) if len(counts) else 0, 1)
    pos = np.arange(len(tgt)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[tgt]
    out = np.full((nrb, kin), -1, dtype=np.int32)
    out[tgt, pos] = slots
    return out


@dataclasses.dataclass(frozen=True)
class BlockedEllMatrix(LinearOperator):
    """Full blocked-ELL: rows grouped into ``nrb = ceil(n / bm)`` block-rows,
    each storing exactly ``kmax`` dense (bm, bn) tiles (``blocks``) and, per
    tile, the column block it multiplies (``block_cols``).  Padding tiles are
    zero and point at column block 0, so the matvec needs no masking.
    """

    blocks: torch.Tensor  # (nrb, kmax, bm, bn)
    block_cols: torch.Tensor  # (nrb, kmax) int32
    shape: Tuple[int, int]
    nnz: int  # true nnz (before padding)

    @staticmethod
    def from_csr_host(
        data: np.ndarray,
        indices: np.ndarray,
        indptr: np.ndarray,
        shape: Tuple[int, int],
        bm: int = 128,
        bn: int = 128,
        dtype=None,
        device=DEFAULT_DEVICE,
    ) -> "BlockedEllMatrix":
        """Host-side CSR -> blocked-ELL, then one copy to ``device``."""
        blocks, block_cols, nnz = pack_host_arrays(
            data, indices, indptr, shape, bm=bm, bn=bn, dtype=dtype
        )
        dev = torch.device(device)
        return cast_values(BlockedEllMatrix(
            torch.from_numpy(blocks).to(dev), torch.from_numpy(block_cols).to(dev),
            (shape[0], shape[1]), nnz,
        ), dtype)

    @staticmethod
    def from_csr(csr: CSRMatrix, bm: int = 128, bn: int = 128) -> "BlockedEllMatrix":
        """Repack a ``CSRMatrix`` (host round trip), on its device."""
        return BlockedEllMatrix.from_csr_host(
            csr.data.cpu().numpy(), csr.indices.cpu().numpy(),
            csr.indptr.cpu().numpy(), csr.shape, bm=bm, bn=bn,
            device=csr.device,
        )

    @property
    def bm(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def bn(self) -> int:
        return int(self.blocks.shape[3])

    @property
    def kmax(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def nrb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def padded_shape(self) -> Tuple[int, int]:
        """(nrb·bm, ncb·bn): rectangular when bm != bn or for a rectangular
        operator."""
        return (self.nrb * self.bm, _cdiv(self.shape[1], self.bn) * self.bn)

    def to(self, device) -> "BlockedEllMatrix":
        return dataclasses.replace(self, blocks=self.blocks.to(device),
                                   block_cols=self.block_cols.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import bell_spmv

        return bell_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        # row r lives in block-row r // bm at local row r % bm; its diagonal
        # element sits in the tile whose column block is r // bn, at local
        # column r % bn.  Gather that one element per (row, slot), an
        # (n_pad, kmax) gather, never the (n_pad, kmax, bn) slab, which is
        # bn times larger (the JAX package's Jacobi setup ran out of memory
        # on it at n ~ 1M)
        nrb, kmax, bm, bn = self.blocks.shape
        rows = torch.arange(nrb * bm, device=self.device)
        rb = rows // bm
        hit = self.block_cols[rb] == (rows // bn)[:, None]  # (n_pad, kmax)
        ks = torch.arange(kmax, device=self.device)[None, :]
        picked = self.blocks[rb[:, None], ks, (rows % bm)[:, None], (rows % bn)[:, None]]
        return torch.where(hit, picked, torch.zeros_like(picked)).sum(dim=1)[: self.n]

    def to_dense(self) -> torch.Tensor:
        nrb, kmax, bm, bn = self.blocks.shape
        dev = self.device
        rows = (torch.arange(nrb, device=dev)[:, None, None, None] * bm
                + torch.arange(bm, device=dev)[None, None, :, None])
        cols = (self.block_cols.long()[:, :, None, None] * bn
                + torch.arange(bn, device=dev)[None, None, None, :])
        rows, cols = torch.broadcast_tensors(rows, cols)
        out = torch.zeros(self.padded_shape, dtype=self.dtype, device=dev)
        out.index_put_((rows, cols), self.blocks, accumulate=True)
        return out[: self.shape[0], : self.shape[1]]

    def memory_footprint(self) -> int:
        return (self.blocks.numel() * self.blocks.element_size()
                + self.block_cols.numel() * self.block_cols.element_size())

    def tile_bytes(self) -> int:
        """Operator bytes one SpMV streams."""
        return self.blocks.numel() * self.blocks.element_size()

    def padding_ratio(self) -> float:
        """Stored slots / true nnz — the bandwidth overhead of the layout."""
        return float(self.blocks.numel()) / max(self.nnz, 1)

    def packed(self) -> PackedBell:
        """The tiles' nonzeros as a :class:`PackedBell`, built once per
        operator on its device and kept with it (counted in
        ``LAUNCHES["bell_pack"]``).  Keyed on the tiles' storage and
        version, so an in-place change of ``blocks`` or ``block_cols``
        rebuilds it."""
        return _cached_pack(self, (self.blocks, self.block_cols),
                            lambda: pack_nonzeros(self.blocks, self.block_cols,
                                                  self.padded_shape[1]))

    def astype(self, dtype) -> "BlockedEllMatrix":
        return dataclasses.replace(self, blocks=self.blocks.to(dtype))


@dataclasses.dataclass(frozen=True)
class SymBellMatrix(LinearOperator):
    """Symmetric blocked-ELL: each off-diagonal tile stored once.

    * ``diag_blocks[i]`` — the full (bm, bn) tile at block (i, i);
    * ``off_blocks[i, k]`` / ``off_cols[i, k]`` — the strictly-upper tiles
      of block-row i (``off_cols[i, k] > i``); padding slots are zero tiles
      pointing at their own row;
    * ``mirror_src`` — :func:`mirror_index` of ``off_cols``, derived at
      construction;
    * ``full_kmax`` — tiles per row of the equivalent full layout, which
      effective-bandwidth accounting credits;
    * ``banded`` — block-tridiagonal pattern (ku == 1, every real upper
      tile targets the next block-row).
    """

    diag_blocks: torch.Tensor  # (nrb, bm, bn)
    off_blocks: torch.Tensor  # (nrb, ku, bm, bn)
    off_cols: torch.Tensor  # (nrb, ku) int32
    shape: Tuple[int, int]
    nnz: int
    full_kmax: int
    banded: bool = False
    mirror_src: Optional[torch.Tensor] = None  # (nrb, kin) int32

    def __post_init__(self):
        if self.mirror_src is None:
            idx = mirror_index(self.off_cols.cpu().numpy())
            object.__setattr__(
                self, "mirror_src", torch.from_numpy(idx).to(self.off_cols.device)
            )

    @staticmethod
    def from_csr_host(
        data: np.ndarray,
        indices: np.ndarray,
        indptr: np.ndarray,
        shape: Tuple[int, int],
        bn: int = 128,
        dtype=None,
        check: bool = True,
        device=DEFAULT_DEVICE,
    ) -> "SymBellMatrix":
        """Host-side CSR -> symmetric blocked-ELL, then one copy to
        ``device``."""
        blocks, block_cols, nnz = pack_host_arrays(
            data, indices, indptr, shape, bm=bn, bn=bn, dtype=dtype
        )
        nrb = blocks.shape[0]
        padded = (nrb * bn, _cdiv(shape[1], bn) * bn)
        return cast_values(SymBellMatrix._pack_np(
            blocks, block_cols.astype(np.int64), padded, shape, nnz, check,
            device=device,
        ), dtype)

    @staticmethod
    def from_bell(bell: BlockedEllMatrix, check: bool = True) -> "SymBellMatrix":
        """Repack a full blocked-ELL operator into symmetric storage (host
        round trip), on its device.  ``check=True`` verifies each dropped
        lower tile equals the transpose of its stored upper mirror."""
        return SymBellMatrix._pack_np(
            bell.blocks.cpu().numpy(), bell.block_cols.cpu().numpy().astype(np.int64),
            bell.padded_shape, bell.shape, bell.nnz, check, device=bell.device,
        )

    @staticmethod
    def from_csr(csr: CSRMatrix, bm: int = 128, bn: int = 128) -> "SymBellMatrix":
        return SymBellMatrix.from_bell(
            BlockedEllMatrix.from_csr(csr, bm=bm, bn=bn), check=False
        )

    @staticmethod
    def _pack_np(blocks, cols, padded_shape, shape, nnz, check, device=DEFAULT_DEVICE):
        """Full blocked-ELL numpy tiles (nrb, kmax, bm, bn) and their
        block columns -> symmetric storage on ``device``."""
        nrb, kmax, bm, bn = blocks.shape
        if bm != bn:
            raise ValueError(f"symmetric layout needs square tiles, got {bm}x{bn}")
        np_, mp = padded_shape
        if np_ != mp:
            raise ValueError(f"symmetric layout needs a square system, got {shape}")
        rows_idx = np.arange(nrb, dtype=np.int64)[:, None]
        nonzero = blocks.reshape(nrb, kmax, -1).any(axis=2)
        diag = np.zeros((nrb, bm, bn), dtype=blocks.dtype)
        for k in range(kmax):
            sel = cols[:, k] == rows_idx[:, 0]
            diag[sel] += blocks[sel, k]
        up_mask = (cols > rows_idx) & nonzero
        lo_mask = (cols < rows_idx) & nonzero
        u_r, u_k = np.nonzero(up_mask)
        if check:
            l_r, l_k = np.nonzero(lo_mask)
            u_keys = u_r * nrb + cols[u_r, u_k]
            l_keys = cols[l_r, l_k] * nrb + l_r
            ou, ol = np.argsort(u_keys), np.argsort(l_keys)
            if len(u_keys) != len(l_keys) or not np.array_equal(
                u_keys[ou], l_keys[ol]
            ):
                only = set(u_keys.tolist()) ^ set(l_keys.tolist())
                key = sorted(only)[0]
                raise ValueError(
                    f"tile ({key // nrb}, {key % nrb}) is not symmetric "
                    "(nonzero on one side of the diagonal only)"
                )
            U = blocks[u_r[ou], u_k[ou]]
            L = blocks[l_r[ol], l_k[ol]]
            if not np.allclose(U, np.swapaxes(L, 1, 2)):
                bad = np.nonzero(
                    ~np.isclose(U, np.swapaxes(L, 1, 2)).all(axis=(1, 2))
                )[0][0]
                key = int(u_keys[ou][bad])
                raise ValueError(
                    f"tile ({key // nrb}, {key % nrb}) is not symmetric"
                )
        counts = up_mask.sum(axis=1)
        ku = max(int(counts.max()) if len(counts) else 1, 1)
        slot = np.cumsum(up_mask, axis=1) - 1
        off_blocks = np.zeros((nrb, ku, bm, bn), dtype=blocks.dtype)
        off_cols = np.tile(np.arange(nrb, dtype=np.int32)[:, None], (1, ku))
        off_blocks[u_r, slot[u_r, u_k]] = blocks[u_r, u_k]
        off_cols[u_r, slot[u_r, u_k]] = cols[u_r, u_k].astype(np.int32)
        banded = bool(
            ku == 1
            and nrb > 1
            and np.array_equal(off_cols[:-1, 0], np.arange(1, nrb, dtype=np.int32))
            and off_cols[-1, 0] == nrb - 1
        )
        dev = torch.device(device)
        return SymBellMatrix(
            torch.from_numpy(diag).to(dev),
            torch.from_numpy(off_blocks).to(dev),
            torch.from_numpy(off_cols).to(dev),
            tuple(shape),
            nnz,
            kmax,
            banded,
            torch.from_numpy(mirror_index(off_cols)).to(dev),
        )

    @property
    def bm(self) -> int:
        return int(self.diag_blocks.shape[1])

    @property
    def bn(self) -> int:
        return int(self.diag_blocks.shape[2])

    @property
    def ku(self) -> int:
        return int(self.off_blocks.shape[1])

    @property
    def nrb(self) -> int:
        return int(self.diag_blocks.shape[0])

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.diag_blocks.dtype

    @property
    def device(self):
        return self.diag_blocks.device

    @property
    def padded_shape(self) -> Tuple[int, int]:
        np_ = self.nrb * self.bm
        return (np_, np_)

    def to(self, device) -> "SymBellMatrix":
        return dataclasses.replace(
            self,
            diag_blocks=self.diag_blocks.to(device),
            off_blocks=self.off_blocks.to(device),
            off_cols=self.off_cols.to(device),
            mirror_src=self.mirror_src.to(device),
        )

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import sym_bell_spmv

        return sym_bell_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        nrb, bm, bn = self.diag_blocks.shape
        rows = torch.arange(nrb * bm, device=self.device)
        d = self.diag_blocks[rows // bm, rows % bm, rows % bn]
        return d[: self.n]

    def to_dense(self) -> torch.Tensor:
        """D + U + Uᵀ as a dense (n, n) tensor."""
        nrb, bm, bn = self.diag_blocks.shape
        np_ = self.padded_shape[0]
        out = torch.zeros((np_, np_), dtype=self.dtype, device=self.device)
        for i in range(nrb):
            out[i * bm:(i + 1) * bm, i * bn:(i + 1) * bn] += self.diag_blocks[i]
        for i, k in zip(*np.nonzero(self.off_cols.cpu().numpy() != np.arange(nrb)[:, None])):
            c = int(self.off_cols[i, k])
            blk = self.off_blocks[i, k]
            out[i * bm:(i + 1) * bm, c * bn:(c + 1) * bn] += blk
            out[c * bn:(c + 1) * bn, i * bm:(i + 1) * bm] += blk.T
        return out[: self.shape[0], : self.shape[1]]

    def memory_footprint(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.diag_blocks, self.off_blocks, self.off_cols, self.mirror_src))

    def padding_ratio(self) -> float:
        """Stored values (each upper tile counted twice, for the two full-
        layout tiles it stands for) / true nnz."""
        stored = self.diag_blocks.numel() + 2 * self.off_blocks.numel()
        return float(stored) / max(self.nnz, 1)

    def astype(self, dtype) -> "SymBellMatrix":
        return dataclasses.replace(self, diag_blocks=self.diag_blocks.to(dtype),
                                   off_blocks=self.off_blocks.to(dtype))

    def packed(self) -> PackedBell:
        """The whole operator D + U + Uᵀ as a :class:`PackedBell`
        (:func:`pack_symmetric`), built once per operator on its device and
        kept with it (counted in ``LAUNCHES["bell_pack"]``).  Keyed on the
        storage and version of ``diag_blocks``, ``off_blocks`` and
        ``off_cols``, so an in-place change of any of them rebuilds it."""
        return _cached_pack(self, (self.diag_blocks, self.off_blocks, self.off_cols),
                            lambda: pack_symmetric(self.diag_blocks, self.off_blocks,
                                                   self.off_cols, self.padded_shape[1]))

    def tile_bytes(self) -> int:
        """Operator bytes one symmetric pass streams (diag + upper tiles)."""
        return (self.diag_blocks.numel() + self.off_blocks.numel()) * \
            self.diag_blocks.element_size()

    def full_tile_bytes(self) -> int:
        """Bytes the equivalent FULL blocked-ELL layout would stream per
        SpMV — what effective-bandwidth accounting credits."""
        return self.nrb * self.full_kmax * self.bm * self.bn * \
            self.diag_blocks.element_size()
