from .base import (
    DEFAULT_DEVICE,
    DenseOperator,
    LinearOperator,
    MatrixFreeOperator,
    as_linear_operator,
)
from .bell import BlockedEllMatrix, SymBellMatrix, mirror_index, pack_host_arrays
from .csr import CSRMatrix
from .dia import DIAMatrix, SymDIAMatrix
from .sell import SellMatrix
from .stencil import StencilOperator

__all__ = [
    "DEFAULT_DEVICE",
    "BlockedEllMatrix",
    "CSRMatrix",
    "DIAMatrix",
    "DenseOperator",
    "LinearOperator",
    "MatrixFreeOperator",
    "SellMatrix",
    "StencilOperator",
    "SymBellMatrix",
    "SymDIAMatrix",
    "as_linear_operator",
    "mirror_index",
    "pack_host_arrays",
]
