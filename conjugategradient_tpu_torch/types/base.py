"""Operator base class, the dense wrapper, and the ingest dispatcher
(``as_linear_operator``) on torch tensors.

Counterpart of ``conjugategradient_tpu/types/base.py``: the same roles, with
operators as plain dataclasses holding tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

#: where the entry points (``load_matrix``, the ``from_*`` constructors and
#: ``convert``) put an operator when the caller names no device; a CPU run
#: passes ``device="cpu"``.  There is no fallback: without a GPU a call that
#: relies on this default raises torch's own error.
DEFAULT_DEVICE = "cuda"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def as_numpy_dtype(dtype) -> np.dtype:
    """torch dtype, dtype name or numpy dtype -> numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return {torch.float32: np.dtype(np.float32),
                torch.float64: np.dtype(np.float64)}[dtype]
    return np.dtype(dtype)


class LinearOperator:
    """Minimal abstract operator: ``y = A @ x`` plus metadata.

    The CG driver (solver/cg.py) only needs ``shape``, ``dtype``, ``device``
    and ``matvec``; ``diagonal`` feeds the Jacobi preconditioner.
    """

    shape: Tuple[int, int]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def diagonal(self) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a diagonal; "
            "pass an explicit preconditioner instead."
        )

    @property
    def dtype(self) -> torch.dtype:  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def device(self) -> torch.device:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense SPD operator; the matvec is one full-precision ``mv``."""

    a: torch.Tensor

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x):
        from ..ops.spmv import dense_spmv

        return dense_spmv(self.a, x)

    def diagonal(self):
        return torch.diagonal(self.a)


def as_linear_operator(a: Any, device=None) -> LinearOperator:
    """Coerce a LinearOperator or a dense square 2-D tensor/array into a
    LinearOperator."""
    if isinstance(a, LinearOperator):
        return a
    t = torch.as_tensor(a, device=device)
    if t.ndim != 2 or t.shape[0] != t.shape[1]:
        raise ValueError(f"expected a square 2-D operator, got shape {tuple(t.shape)}")
    return DenseOperator(t)
