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


def is_bfloat16(dtype) -> bool:
    """Whether ``dtype`` (torch dtype, dtype name or numpy dtype) is
    bfloat16, which numpy has no type of its own for."""
    return dtype == torch.bfloat16 or str(dtype) in ("bfloat16", "torch.bfloat16")


def as_numpy_dtype(dtype) -> np.dtype:
    """torch dtype, dtype name or numpy dtype -> the numpy dtype that host
    arrays of values of that dtype are built in.  bfloat16 has no numpy
    type: its values are built as float32 (float64 input rounded once to
    float32, then once more to bfloat16 when the tensor is cast, which is
    how ``ml_dtypes`` and ``jnp.asarray`` round float64 to bfloat16 for the
    JAX package), and the caller casts the tensors (:func:`is_bfloat16`)."""
    if is_bfloat16(dtype):
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        return {torch.float32: np.dtype(np.float32),
                torch.float64: np.dtype(np.float64)}[dtype]
    return np.dtype(dtype)


def cast_values(op, dtype):
    """``op`` with its values cast to bfloat16 where ``dtype`` says so: the
    last step of a constructor that built them as float32
    (:func:`as_numpy_dtype`); any other ``dtype`` leaves ``op`` as it is."""
    return op.astype(torch.bfloat16) if dtype is not None and is_bfloat16(dtype) else op


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

    def memory_footprint(self) -> int:
        """Bytes of device memory this operator occupies; 0 for matrix-free."""
        return 0

    def astype(self, dtype) -> "LinearOperator":
        """Copy with the VALUES cast to ``dtype`` (index arrays keep their
        integer types)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support astype; "
            "construct the operator at the target dtype instead."
        )

    def __matmul__(self, x):
        return self.matvec(x)


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

    def memory_footprint(self) -> int:
        return self.a.numel() * self.a.element_size()

    def astype(self, dtype) -> "DenseOperator":
        return DenseOperator(self.a.to(dtype))


class MatrixFreeOperator(LinearOperator):
    """Wrap an ``x -> A x`` callable on torch tensors of ``n`` entries;
    ``device`` is where the solvers put the vectors they hand it."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], n: int,
                 dtype: torch.dtype = torch.float32, device=DEFAULT_DEVICE):
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


def _is_scipy_sparse(a: Any) -> bool:
    """Duck-typed scipy.sparse check (no scipy import): every scipy sparse
    class has ``tocsr``, ``shape`` and ``nnz``; arrays and tensors have not
    the first."""
    return (hasattr(a, "tocsr") and hasattr(a, "shape") and hasattr(a, "nnz")
            and not isinstance(a, (torch.Tensor, np.ndarray)))


def as_linear_operator(a: Any, n: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                       *, device=None) -> LinearOperator:
    """Coerce into a LinearOperator: an operator as it is; a scipy sparse
    matrix or a sparse torch tensor into a ``CSRMatrix``, and an ``x -> A x``
    callable, which needs ``n`` (the system's dimension), into a
    ``MatrixFreeOperator``, each on ``device`` (None: ``DEFAULT_DEVICE``);
    a dense square 2-D tensor or array into a ``DenseOperator``."""
    # local import: csr imports LinearOperator from here
    from .csr import CSRMatrix

    if isinstance(a, LinearOperator):
        return a
    if _is_scipy_sparse(a):
        return CSRMatrix.from_scipy(a, dtype=dtype, device=device or DEFAULT_DEVICE)
    if isinstance(a, torch.Tensor) and a.layout != torch.strided:
        return CSRMatrix.from_torch(a, dtype=dtype, device=device or DEFAULT_DEVICE)
    if callable(a) and not isinstance(a, (torch.Tensor, np.ndarray)):
        if n is None:
            raise ValueError("matrix-free callables need n= (system dimension)")
        return MatrixFreeOperator(a, n, dtype or torch.float32, device or DEFAULT_DEVICE)
    t = torch.as_tensor(a, device=device)
    if t.ndim != 2 or t.shape[0] != t.shape[1]:
        raise ValueError(f"expected a square 2-D operator, got shape {tuple(t.shape)}")
    return DenseOperator(t)
