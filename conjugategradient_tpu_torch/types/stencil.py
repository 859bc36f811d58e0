"""Matrix-free 3-D 7-point stencil operator.  Counterpart of
``conjugategradient_tpu/types/stencil.py`` (BASELINE config 4): no matrix
is ever formed; ``matvec`` applies the stencil (``ops/stencil.py``), on a
CUDA device through the hand-written kernel ``stencil7``."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import DEFAULT_DEVICE, LinearOperator, as_numpy_dtype


def round_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` and returned as a host float."""
    return float(as_numpy_dtype(dtype).type(value))


@dataclasses.dataclass(frozen=True)
class StencilOperator(LinearOperator):
    """``y = center·x + off·(sum of the 6 axis neighbours)`` on a
    ``grid_shape`` box with homogeneous Dirichlet (zero) boundaries; the
    standard Poisson operator is ``center=6, off=-1`` (SPD).  Vectors are
    flat ``(nx·ny·nz,)``.

    ``center`` and ``off`` are host floats rounded to ``dtype``, the values
    of the JAX operator's 0-d arrays; kernels take them by value, so a
    matvec reads nothing back from the device.  The operator holds no
    tensor: ``device`` says where its vectors live.
    """

    center: float
    off: float
    grid_shape: Tuple[int, int, int]
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device(DEFAULT_DEVICE)

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"StencilOperator dtype must be float32 or float64, got {self.dtype}")
        shape = tuple(int(n) for n in self.grid_shape)
        if len(shape) != 3 or min(shape) < 1:
            raise ValueError(f"grid_shape must be 3 axes >= 1, got {self.grid_shape}")
        object.__setattr__(self, "grid_shape", shape)
        object.__setattr__(self, "center", round_to(self.center, self.dtype))
        object.__setattr__(self, "off", round_to(self.off, self.dtype))
        object.__setattr__(self, "device", torch.device(self.device))

    @staticmethod
    def poisson(grid_shape: Tuple[int, int, int], dtype=torch.float32,
                device=DEFAULT_DEVICE) -> "StencilOperator":
        return StencilOperator(6.0, -1.0, tuple(grid_shape), dtype, device)

    @property
    def shape(self):
        n = int(np.prod(self.grid_shape))
        return (n, n)

    @property
    def nnz(self) -> int:
        """LOGICAL nonzero count of the never-formed matrix: 7 per point,
        minus the Dirichlet-truncated couplings on each face."""
        nx, ny, nz = self.grid_shape
        return 7 * nx * ny * nz - 2 * (ny * nz + nx * nz + nx * ny)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.stencil import stencil7_matvec

        return stencil7_matvec(self, x)

    def diagonal(self) -> torch.Tensor:
        return torch.full((self.shape[0],), self.center, dtype=self.dtype, device=self.device)

    def astype(self, dtype) -> "StencilOperator":
        return dataclasses.replace(self, dtype=dtype)

    def to(self, device) -> "StencilOperator":
        return dataclasses.replace(self, device=torch.device(device))
