"""Plain reference of the 7-point stencil: y = center*x + off*(the sum of
the 6 axis neighbours), zero outside the grid (Dirichlet).  Vectors are
flat over the grid (nx, ny, nz) in C order.  Plain torch only: it imports
nothing of the port and reads nothing the port made."""

from __future__ import annotations

import math

import torch


def n(cfg: dict) -> int:
    return math.prod(cfg["grid"])


def shape(cfg: dict) -> tuple:
    """A vector's grid in C order: x, y, z (z fastest)."""
    return tuple(cfg["grid"])


def nnz(cfg: dict) -> int:
    """Nonzeros of the never-formed matrix: 7 a point, less the couplings
    cut at each face."""
    nx, ny, nz = cfg["grid"]
    return 7 * nx * ny * nz - 2 * (ny * nz + nx * nz + nx * ny)


def operator_bytes(cfg: dict, value_bytes: int) -> int:
    """A matrix-free operator is two scalars: it needs no bytes."""
    return 0


def matvec(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """A x for x of shape (..., n), in x's dtype."""
    nx, ny, nz = cfg["grid"]
    v = x.reshape(-1, nx, ny, nz)
    nb = torch.zeros_like(v)
    for dim in (1, 2, 3):
        size = v.shape[dim]
        nb.narrow(dim, 1, size - 1).add_(v.narrow(dim, 0, size - 1))
        nb.narrow(dim, 0, size - 1).add_(v.narrow(dim, 1, size - 1))
    return (cfg["center"] * v + cfg["off"] * nb).reshape(x.shape)
