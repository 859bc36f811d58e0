from .base import DenseOperator, LinearOperator, as_linear_operator
from .bell import BlockedEllMatrix, SymBellMatrix, mirror_index, pack_host_arrays
from .csr import CSRMatrix

__all__ = [
    "BlockedEllMatrix",
    "CSRMatrix",
    "DenseOperator",
    "LinearOperator",
    "SymBellMatrix",
    "as_linear_operator",
    "mirror_index",
    "pack_host_arrays",
]
