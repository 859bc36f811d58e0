"""The 7-point stencil: a hand-written CUDA kernel for Hopper
(``csrc/stencil.cu``) beside its plain-torch version.

:func:`stencil7` replaces ``stencil7_pallas``
(``conjugategradient_tpu/ops/pallas/stencil.py:136``): y = c·u +
w·((x− + x+) + (y− + y+) + (z− + z+)) on a (nx, ny, nz) volume with zero
Dirichlet boundaries, in u's dtype (float32 or float64, as the TPU kernel
takes the input's dtype).  The wrapper runs the plain version
(``ops/stencil.stencil7_apply``) when u lies on the CPU and launches the
kernel when it lies on a CUDA device; anything else raises (``_common``).
"""

from __future__ import annotations

import torch

from ..stencil import stencil7_apply
from ._common import LAUNCHES, PLAIN_ON_CUDA, check_cuda_operands, on_cuda, ptr, raise_on_error, stream
from .fused_cg import _sm_count

_NAME = "stencil7"
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
    by ``StencilOperator``)."""
    check_volume(_NAME, u)
    if not on_cuda(_NAME, u):
        return _stencil7_plain(u, center, off)
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{_NAME}: the CUDA kernel takes float32 or float64, got {u.dtype} "
                        "(a bf16 stencil is not ported yet: ROADMAP.md queue 2)")
    check_cuda_operands(_NAME, (u,))
    from ._build import load_library

    nx, ny, nz = u.shape
    y = torch.empty_like(u)
    lib = load_library()
    fn = lib.cg_stencil7_f32 if u.dtype == torch.float32 else lib.cg_stencil7_f64
    err = fn(ptr(u), ptr(y), nx, ny, nz, center, off, xchunk(u.shape, u.device),
             stream(u.device))
    LAUNCHES[_NAME] += 1
    raise_on_error(_NAME, err)
    return y


def _stencil7_plain(u, center, off):
    if u.is_cuda:
        PLAIN_ON_CUDA[_NAME] += 1
    return stencil7_apply(u, center, off)
