"""Matrix-free 3-D 7-point stencil.  Counterpart of
``conjugategradient_tpu/ops/stencil.py``:

    y = center·x + off·((x[i-1] + x[i+1]) + (x[j-1] + x[j+1]) + (x[k-1] + x[k+1]))

with zero-Dirichlet boundaries.  The JAX package applies it with XLA-fused
shifted pads and keeps its Pallas kernel opt-in (``use_pallas="always"``,
a v5e measurement); here the same argument is ``use_kernel`` and its
default ``"auto"`` takes the kernel: on a CUDA tensor the apply launches the
hand-written kernel ``stencil7`` (``ops/cuda/stencil.py``), on a CPU tensor
it runs the plain version; ``"never"`` runs the plain version anywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import DEFAULT_DEVICE, CSRMatrix
from .spmv import KERNEL_CHOICES


def _neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the six axis neighbours of a (nx, ny, nz) volume, zero past
    the boundary, as ((x− + x+) + (y− + y+)) + (z− + z+) — the order of
    the JAX Pallas kernel (``ops/pallas/stencil.py:130``)."""
    up = torch.nn.functional.pad(u, (1, 1, 1, 1, 1, 1))
    xm, xp = up[:-2, 1:-1, 1:-1], up[2:, 1:-1, 1:-1]
    ym, yp = up[1:-1, :-2, 1:-1], up[1:-1, 2:, 1:-1]
    zm, zp = up[1:-1, 1:-1, :-2], up[1:-1, 1:-1, 2:]
    return (xm + xp) + (ym + yp) + (zm + zp)


def stencil7_apply(u: torch.Tensor, center: float, off: float) -> torch.Tensor:
    """The plain version of kernel ``stencil7`` on a (nx, ny, nz) volume:
    one product, one sum, each rounded to u's dtype, in the kernel's order."""
    return center * u + off * _neighbor_sum(u)


def stencil7_matvec(op, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """Apply the operator to a flat vector: reshape to the grid, apply,
    flatten.  The result has the common dtype of the operator and x.
    ``use_kernel``: ``"auto"`` and ``"always"`` go through the kernel's
    wrapper (the kernel on a CUDA tensor, float32, float64 and bfloat16
    alike), ``"never"`` through the plain version."""
    from .cuda.stencil import stencil7

    if use_kernel not in KERNEL_CHOICES:
        raise ValueError(f"use_kernel must be one of {KERNEL_CHOICES}, got {use_kernel!r}")
    u = x.to(torch.promote_types(op.dtype, x.dtype)).reshape(op.grid_shape)
    if use_kernel == "never":
        return stencil7_apply(u, op.center, op.off).reshape(-1)
    return stencil7(u.contiguous(), op.center, op.off).reshape(-1)


def poisson7_csr(grid_shape, dtype=np.float64, device=DEFAULT_DEVICE):
    """Explicit CSR assembly of the 7-point Poisson operator (center 6,
    off −1), for cross-checking the matrix-free path against the sparse
    path on small grids."""
    nx, ny, nz = grid_shape
    n = nx * ny * nz

    def idx(i, j, k):
        return (i * ny + j) * nz + k

    rows, cols, vals = [], [], []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                r = idx(i, j, k)
                rows.append(r)
                cols.append(r)
                vals.append(6.0)
                for di, dj, dk in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                   (0, 1, 0), (0, 0, -1), (0, 0, 1)):
                    ii, jj, kk = i + di, j + dj, k + dk
                    if 0 <= ii < nx and 0 <= jj < ny and 0 <= kk < nz:
                        rows.append(r)
                        cols.append(idx(ii, jj, kk))
                        vals.append(-1.0)
    return CSRMatrix.from_coo(np.array(rows), np.array(cols), np.array(vals, dtype=dtype),
                              (n, n), device=device)
