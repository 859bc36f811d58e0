"""Blocked-ELL SpMV: a hand-written CUDA kernel for Hopper
(``csrc/bell_spmv.cu``) beside its plain-torch version.

Replaces ``bell_spmv_pallas`` (``conjugategradient_tpu/ops/pallas/ell_spmv.py:57``):
y (nrb·bm,) = Σ_k blocks[i, k] @ x2d[block_cols[i, k]], f32 accumulate, f32
out.  The wrapper runs its plain version when the tensors it is given lie on
the CPU and launches the kernel when they lie on a CUDA device; anything
else raises (``_common``).  ``ops/spmv.bell_spmv`` is the operator-level
entry point that pads x and picks this wrapper or the einsum path.
"""

from __future__ import annotations

import torch

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
