from .blas import dot, norm_sq, sambx, sapbx, saxpby
from .spmv import csr_spmv, sym_bell_spmv

__all__ = ["csr_spmv", "dot", "norm_sq", "sambx", "sapbx", "saxpby", "sym_bell_spmv"]
