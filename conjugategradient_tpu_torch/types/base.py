"""Operator base class, the dense wrapper, and the ingest dispatcher
(``as_linear_operator``) on torch tensors.

Counterpart of ``conjugategradient_tpu/types/base.py``: the same roles, with
operators as plain dataclasses holding tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

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


class MatrixFreeOperator(LinearOperator):
    """Wrap an ``x -> A x`` callable on torch tensors of ``n`` entries."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], n: int,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        self.fn = fn
        self._n = int(n)
        self._dtype = dtype
        self._device = torch.device(device)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    def matvec(self, x):
        return self.fn(x)


def as_linear_operator(a: Any, device=None, n: Optional[int] = None,
                       dtype: Optional[torch.dtype] = None) -> LinearOperator:
    """Coerce a LinearOperator, a dense square 2-D tensor/array or an
    ``x -> A x`` callable (which needs ``n``, the system's dimension) into
    a LinearOperator."""
    if isinstance(a, LinearOperator):
        return a
    if callable(a) and not isinstance(a, (torch.Tensor, np.ndarray)):
        if n is None:
            raise ValueError("matrix-free callables need n= (system dimension)")
        return MatrixFreeOperator(a, n, dtype or torch.float32, device or "cpu")
    t = torch.as_tensor(a, device=device)
    if t.ndim != 2 or t.shape[0] != t.shape[1]:
        raise ValueError(f"expected a square 2-D operator, got shape {tuple(t.shape)}")
    return DenseOperator(t)
