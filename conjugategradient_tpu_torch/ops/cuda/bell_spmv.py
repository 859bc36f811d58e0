"""Blocked-ELL SpMV: two hand-written CUDA kernels for Hopper
(``csrc/bell_spmv.cu``), each beside its plain-torch version.

Both replace ``bell_spmv_pallas`` (``conjugategradient_tpu/ops/pallas/ell_spmv.py:57``):
y (nrb·bm,) = Σ_k blocks[i, k] @ x2d[block_cols[i, k]], f32 accumulate, f32
out.  :func:`bell_spmv_tiles` streams the dense tiles; :func:`bell_spmv_packed`
reads only their nonzeros, from the operator's packed view
(``types/bell.PackedBell``).  A wrapper runs its plain version when the
tensors it is given lie on the CPU and launches its kernel when they lie on
a CUDA device; anything else raises (``_common``).  ``ops/spmv.bell_spmv``
is the operator-level entry point that pads x and picks the route.
"""

from __future__ import annotations

import torch

from ...types.bell import PACK_CHUNK
from ..spmv import bell_apply
from ._common import (
    CUDA_BN,
    LAUNCHES,
    PLAIN_ON_CUDA,
    check_cuda_operands,
    on_cuda,
    ptr,
    raise_on_error,
    stream,
)

_NAME = "bell_spmv"


def bell_spmv_tiles(blocks: torch.Tensor, block_cols: torch.Tensor,
                    x2d: torch.Tensor) -> torch.Tensor:
    """y (nrb·bm,) float32 = blocked-ELL(blocks, block_cols) @ x2d.

    ``blocks`` (nrb, kmax, bm, bn) float32 (bf16 on the CPU only),
    ``block_cols`` (nrb, kmax) int32, ``x2d`` the padded operand as
    (ncb, bn) float32.
    """
    if blocks.dim() != 4:
        raise ValueError(f"{_NAME}: blocks must be (nrb, kmax, bm, bn), got "
                         f"{tuple(blocks.shape)}")
    nrb, kmax, bm, bn = blocks.shape
    if blocks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{_NAME}: tiles must be float32 or bfloat16, got "
                        f"{blocks.dtype}; use the einsum path for other dtypes")
    if tuple(block_cols.shape) != (nrb, kmax) or block_cols.dtype != torch.int32:
        raise ValueError(f"{_NAME}: block_cols must be ({nrb}, {kmax}) int32")
    if x2d.dim() != 2 or x2d.shape[1] != bn or x2d.dtype != torch.float32:
        raise ValueError(f"{_NAME}: x2d must be (ncb, {bn}) float32, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    if not on_cuda(_NAME, blocks, block_cols, x2d):
        return _bell_plain(blocks, block_cols, x2d)
    if blocks.dtype != torch.float32:
        raise TypeError(f"{_NAME}: the CUDA kernel takes float32 tiles, got "
                        f"{blocks.dtype} (bf16 tiles are not ported yet)")
    if bn not in CUDA_BN:
        raise ValueError(f"{_NAME}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    return _bell_cuda(blocks, block_cols, x2d)


def _bell_plain(blocks, block_cols, x2d):
    if x2d.is_cuda:
        PLAIN_ON_CUDA[_NAME] += 1
    return bell_apply(blocks.to(torch.float32), block_cols, x2d).reshape(-1)


def _bell_cuda(blocks, block_cols, x2d):
    from ._build import load_library

    nrb, kmax, bm, bn = blocks.shape
    y = x2d.new_empty(nrb * bm)
    check_cuda_operands(_NAME, (blocks, block_cols, x2d))
    err = load_library().cg_bell_spmv(
        ptr(blocks), ptr(block_cols), ptr(x2d), ptr(y), nrb * bm, bm, kmax, bn,
        stream(x2d.device))
    LAUNCHES[_NAME] += 1
    raise_on_error(_NAME, err)
    return y


_PNAME = "bell_spmv_packed"


def bell_spmv_packed(pk, x: torch.Tensor) -> torch.Tensor:
    """y (pk.rows,) float32 = the packed view ``pk`` (``types/bell.PackedBell``,
    float32 values) @ ``x``, the operand padded to ``pk.ncols`` float32
    entries.  Any tile shape."""
    check_packed(_PNAME, pk)
    if x.shape != (pk.ncols,) or x.dtype != torch.float32:
        raise ValueError(f"{_PNAME}: x must be ({pk.ncols},) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not on_cuda(_PNAME, pk.vals, pk.cols, pk.row_len, pk.chunk_off, x):
        return packed_apply(pk, x)
    return _packed_cuda(pk, x)


def check_packed(name: str, pk) -> None:
    """A packed view the kernels take: float32 values, int32 columns and
    row lengths, int64 chunk offsets, one chunk per 32 rows."""
    if pk.vals.dtype != torch.float32 or pk.cols.dtype != torch.int32 or (
            pk.vals.shape != pk.cols.shape):
        raise TypeError(f"{name}: the packed view must hold float32 values and int32 "
                        f"columns of one length, got {pk.vals.dtype} / {pk.cols.dtype}")
    if pk.row_len.dtype != torch.int32 or pk.chunk_off.dtype != torch.int64 or (
            pk.chunk_off.numel() != -(-pk.rows // PACK_CHUNK) + 1):
        raise ValueError(f"{name}: row_len must be int32 and chunk_off int64 with one "
                         f"entry per {PACK_CHUNK} rows and one more")


def check_packed_vectors(name: str, pk, r2d: torch.Tensor):
    """The packed fused kernels' operator and the shape of their vectors:
    a square padded system of ``pk.rows`` rows, vectors (nrb, bn) with
    nrb·bn = ``pk.rows``.  Returns that shape."""
    check_packed(name, pk)
    if pk.ncols != pk.rows:
        raise ValueError(f"{name}: needs a square padded system, got {pk.rows} rows and "
                         f"{pk.ncols} columns")
    if r2d.dim() != 2 or r2d.numel() != pk.rows:
        raise ValueError(f"{name}: vectors must be one (nrb, bn) float32 shape of "
                         f"{pk.rows} entries, got {tuple(r2d.shape)}")
    return r2d.shape


def packed_apply(pk, x: torch.Tensor) -> torch.Tensor:
    """The plain packed product: y[r] = Σ_k vals[e]·x[cols[e]] over
    e = chunk_off[r // 32] + 32 k + r % 32, k < row_len[r], in k order,
    each product and each sum rounded once — the kernel's order and
    rounding, so the two give the same bits."""
    if x.is_cuda:
        PLAIN_ON_CUDA[_PNAME] += 1
    rows = pk.rows
    r = torch.arange(rows, device=x.device)
    base = pk.chunk_off[r // PACK_CHUNK] + r % PACK_CHUNK
    y = x.new_zeros(rows)
    for k in range(int(pk.row_len.max()) if rows else 0):
        live = pk.row_len > k
        e = torch.where(live, base + PACK_CHUNK * k, 0)
        y = torch.where(live, y + pk.vals[e] * x[pk.cols[e].long()], y)
    return y


def packed_product(pk):
    """:func:`packed_apply` as a product on the fused kernels' (nrb, bn)
    vectors: the plain versions of the packed fused kernels take it."""
    return lambda y: packed_apply(pk, y.reshape(-1)).reshape(y.shape)


def _packed_cuda(pk, x):
    from ._build import load_library

    y = x.new_empty(pk.rows)
    check_cuda_operands(_PNAME, (pk.vals, pk.cols, pk.row_len, pk.chunk_off, x))
    err = load_library().cg_bell_spmv_packed(
        ptr(pk.vals), ptr(pk.cols), ptr(pk.row_len), ptr(pk.chunk_off), ptr(x), ptr(y),
        pk.rows, stream(x.device))
    LAUNCHES[_PNAME] += 1
    raise_on_error(_PNAME, err)
    return y
