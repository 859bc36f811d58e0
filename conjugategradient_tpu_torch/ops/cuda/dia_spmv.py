"""DIA and symmetric-DIA SpMV: two hand-written CUDA kernels for Hopper
(``csrc/dia_spmv.cu``) beside their plain-torch versions.

``dia_spmv_diags`` replaces ``dia_spmv_pallas``, ``dia_spmv_pallas_2d`` and
``dia_spmv_pallas_blocked`` (``conjugategradient_tpu/ops/pallas/dia_spmv.py:181,
130, 398``), which compute the same y = DIA·x on three layouts of x and of
the diagonals; ``sym_dia_spmv_diags`` replaces ``sym_dia_spmv_pallas_blocked``
(same file, :304).  Both read the row-major (ndiag, n) diagonals as they
are stored and return float32 y.  The wrappers run their plain versions
(``ops/spmv.dia_apply`` / ``sym_dia_apply``) when the tensors they are
given lie on the CPU and launch the kernel when they lie on a CUDA device;
anything else raises (``_common``).
"""

from __future__ import annotations

import torch

from ..spmv import dia_apply, sym_dia_apply
from ._common import (
    LAUNCHES,
    PLAIN_ON_CUDA,
    check_cuda_operands,
    on_cuda,
    ptr,
    raise_on_error,
    stream,
)

#: offsets a CTA stages in (dynamic, at most 48 KB) shared memory
MAX_CUDA_DIAGS = 12288


def _check(name, diags, offsets, offsets_dev, x, ncols):
    if diags.dim() != 2:
        raise ValueError(f"{name}: diags must be (ndiag, n), got {tuple(diags.shape)}")
    ndiag = diags.shape[0]
    if diags.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: diagonals must be float32 or bfloat16, got "
                        f"{diags.dtype}; use the plain path for other dtypes")
    if len(offsets) != ndiag:
        raise ValueError(f"{name}: {len(offsets)} offsets for {ndiag} diagonals")
    if offsets_dev.dtype != torch.int32 or tuple(offsets_dev.shape) != (ndiag,):
        raise ValueError(f"{name}: offsets_dev must be ({ndiag},) int32")
    if x.dim() != 1 or x.dtype != torch.float32 or (ncols is not None and x.shape[0] != ncols):
        raise ValueError(f"{name}: x must be 1-D float32"
                         f"{'' if ncols is None else f' of {ncols} entries'}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not on_cuda(name, diags, offsets_dev, x):
        return False
    if diags.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 diagonals, got "
                        f"{diags.dtype} (bf16 diagonals are not ported yet)")
    if ndiag > MAX_CUDA_DIAGS:
        raise ValueError(f"{name}: the CUDA kernel takes at most {MAX_CUDA_DIAGS} "
                         f"diagonals, got {ndiag}")
    check_cuda_operands(name, (diags, offsets_dev, x))
    return True


def dia_spmv_diags(diags: torch.Tensor, offsets, offsets_dev: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y (n,) float32 = Σ_d diags[d] ⊙ x[i + offsets[d]].

    ``diags`` (ndiag, n) float32 (bf16 on the CPU only), ``offsets`` the
    tuple of ints and ``offsets_dev`` the same as an int32 tensor beside
    ``diags``; ``x`` float32 of any length ncols (rectangular operators).
    """
    name = "dia_spmv"
    if not _check(name, diags, offsets, offsets_dev, x, None):
        return _dia_plain(diags, offsets, x)
    from ._build import load_library

    ndiag, n = diags.shape
    y = x.new_empty(n)
    err = load_library().cg_dia_spmv(ptr(diags), ptr(offsets_dev), ptr(x), ptr(y),
                                     n, x.shape[0], ndiag, stream(x.device))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return y


def _dia_plain(diags, offsets, x):
    if x.is_cuda:
        PLAIN_ON_CUDA["dia_spmv"] += 1
    return dia_apply(diags.to(torch.float32), offsets, x)


def sym_dia_spmv_diags(diags: torch.Tensor, offsets, offsets_dev: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """y (n,) float32 = symmetric-DIA(diags, offsets ≥ 0 ascending) @ x;
    arguments as in :func:`dia_spmv_diags`, x of n entries."""
    name = "sym_dia_spmv"
    if any(o < 0 for o in offsets):
        raise ValueError(f"{name}: symmetric storage holds offsets >= 0, got {offsets}")
    if not _check(name, diags, offsets, offsets_dev, x, diags.shape[-1]):
        return _sym_dia_plain(diags, offsets, x)
    from ._build import load_library

    ndiag, n = diags.shape
    y = x.new_empty(n)
    err = load_library().cg_sym_dia_spmv(ptr(diags), ptr(offsets_dev), ptr(x), ptr(y),
                                         n, ndiag, stream(x.device))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return y


def _sym_dia_plain(diags, offsets, x):
    if x.is_cuda:
        PLAIN_ON_CUDA["sym_dia_spmv"] += 1
    return sym_dia_apply(diags.to(torch.float32), offsets, x)
