"""The 7-point stencil: a hand-written CUDA kernel for Hopper
(``csrc/stencil.cu``) beside its plain-torch version.

:func:`stencil7` replaces ``stencil7_pallas``
(``conjugategradient_tpu/ops/pallas/stencil.py:136``): y = c·u +
w·((x− + x+) + (y− + y+) + (z− + z+)) on a (nx, ny, nz) volume with zero
Dirichlet boundaries, in u's dtype (float32, float64 or bfloat16, as the
TPU kernel takes the input's dtype).  A bfloat16 volume launches the bf16
form, counted as ``stencil7_bf16``, which rounds every product and sum to
bf16 as the plain version's torch ops do, so the two are bit-equal.  The
wrapper runs the plain version (``ops/stencil.stencil7_apply``) when u lies
on the CPU and launches the kernel when it lies on a CUDA device; anything
else raises (``_common``).
"""

from __future__ import annotations

import torch

from ..stencil import stencil7_apply
from ._common import (LAUNCHES, PLAIN_ON_CUDA, check_cuda_operands, form, on_cuda, ptr,
                      raise_on_error, stream)
from .fused_cg import _sm_count

_NAME = "stencil7"
#: the C entry point of each dtype the kernel takes
_ENTRY = {torch.float32: "cg_stencil7_f32", torch.float64: "cg_stencil7_f64",
          torch.bfloat16: "cg_stencil7_bf16"}
#: the kernels' CTA tile of the (y, z) plane (csrc/common.cuh)
TILE_Y, TILE_Z = 8, 32
#: most x planes one CTA marches over
MAX_XCHUNK = 32


def xchunk(grid_shape, device) -> int:
    """x planes per CTA: up to ``MAX_XCHUNK``, fewer where the grid would
    otherwise give the card fewer than 8 CTAs per SM (each CTA re-reads two
    end planes, 2/xchunk of its bytes, from L2)."""
    nx, ny, nz = grid_shape
    tiles = -(-ny // TILE_Y) * -(-nz // TILE_Z)
    chunks = -(-8 * _sm_count(torch.device(device).index or 0) // tiles)
    return max(1, min(MAX_XCHUNK, -(-nx // chunks)))


def check_volume(name: str, u: torch.Tensor) -> None:
    if u.dim() != 3 or min(u.shape) < 1:
        raise ValueError(f"{name}: u must be a (nx, ny, nz) volume, got {tuple(u.shape)}")


def stencil7(u: torch.Tensor, center: float, off: float) -> torch.Tensor:
    """y (nx, ny, nz) = 7-point stencil of the volume ``u``; ``center`` and
    ``off`` are host floats (the operator's values, rounded to u's dtype
    by ``StencilOperator``; the kernels take them as float32 for float32
    and bfloat16 volumes, as torch keeps a scalar factor)."""
    check_volume(_NAME, u)
    if not on_cuda(_NAME, u):
        return _stencil7_plain(u, center, off)
    if u.dtype not in _ENTRY:
        raise TypeError(f"{_NAME}: the CUDA kernel takes float32 or float64 (or bfloat16), "
                        f"got {u.dtype}")
    check_cuda_operands(_NAME, (u,))
    from ._build import load_library

    name = form(_NAME, u.dtype)
    nx, ny, nz = u.shape
    y = torch.empty_like(u)
    err = getattr(load_library(), _ENTRY[u.dtype])(
        ptr(u), ptr(y), nx, ny, nz, center, off, xchunk(u.shape, u.device), stream(u.device))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return y


def _stencil7_plain(u, center, off):
    if u.is_cuda:
        PLAIN_ON_CUDA[form(_NAME, u.dtype)] += 1
    return stencil7_apply(u, center, off)
