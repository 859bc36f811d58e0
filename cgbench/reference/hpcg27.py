"""Plain reference of HPCG's 27-point operator: y = center*x + off*(the sum
of the up to 26 neighbours in the 3x3x3 box), zero outside the grid.
Vectors are flat, x fastest, then y, then z.  Plain torch only: it imports
nothing of the port and reads nothing the port made."""

from __future__ import annotations

import math

import torch


def n(cfg: dict) -> int:
    return math.prod(cfg["grid"])


def shape(cfg: dict) -> tuple:
    """A vector's grid in C order: z, y, x (x fastest)."""
    nx, ny, nz = cfg["grid"]
    return (nz, ny, nx)


def nnz(cfg: dict) -> int:
    """Nonzeros of the whole operator: (3N - 2) couplings along each axis
    of N points, multiplied over the axes."""
    return math.prod(3 * g - 2 for g in cfg["grid"])


def stored_nnz(cfg: dict) -> int:
    """Nonzeros of the diagonal and the strict upper triangle: the least a
    symmetric storage holds."""
    return (nnz(cfg) + n(cfg)) // 2


def operator_bytes(cfg: dict, value_bytes: int) -> int:
    """Bytes one product needs of the operator whatever stores it: each
    stored nonzero's value and 4-byte column once, and 4 bytes a row."""
    return stored_nnz(cfg) * (value_bytes + 4) + 4 * n(cfg)


def _box3(v: torch.Tensor, dim: int) -> torch.Tensor:
    """v summed with its two neighbours along ``dim``, zero past the ends."""
    out = v.clone()
    size = v.shape[dim]
    out.narrow(dim, 1, size - 1).add_(v.narrow(dim, 0, size - 1))
    out.narrow(dim, 0, size - 1).add_(v.narrow(dim, 1, size - 1))
    return out


def matvec(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """A x for x of shape (..., n), in x's dtype."""
    nx, ny, nz = cfg["grid"]
    v = x.reshape(-1, nz, ny, nx)
    box = _box3(_box3(_box3(v, 3), 2), 1)  # the 27 points of each box
    center, off = cfg["center"], cfg["off"]
    return ((center - off) * v + off * box).reshape(x.shape)
