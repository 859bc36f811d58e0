from .blas import dot, norm, norm_sq, sambx, sapbx, saxpby
from .spmv import (bell_spmv, bell_spmv_multi, csr_spmv, dense_spmv, dia_spmv, dia_spmv_multi,
                   sell_spmv, sell_spmv_multi, sym_bell_spmv)
from .stencil import stencil7_matvec

__all__ = [
    "bell_spmv",
    "bell_spmv_multi",
    "csr_spmv",
    "dense_spmv",
    "dia_spmv",
    "dia_spmv_multi",
    "dot",
    "norm",
    "norm_sq",
    "sambx",
    "sapbx",
    "saxpby",
    "sell_spmv",
    "sell_spmv_multi",
    "stencil7_matvec",
    "sym_bell_spmv",
]
