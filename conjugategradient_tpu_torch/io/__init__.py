from .loader import LAYOUTS, choose_layout, load_matrix, read_csr_host
from .mtx import COOMatrix, MTXHeader, parse_header, read_mtx_coo, read_mtx_csr, write_mtx

__all__ = [
    "COOMatrix",
    "LAYOUTS",
    "MTXHeader",
    "choose_layout",
    "load_matrix",
    "parse_header",
    "read_csr_host",
    "read_mtx_coo",
    "read_mtx_csr",
    "write_mtx",
]
