"""Matrix ingest: MatrixMarket file -> operator on a torch device.
Counterpart of ``conjugategradient_tpu/io/loader.py`` for the layouts this
package has so far (``csr``, ``symbell``)."""

from __future__ import annotations

import numpy as np

from ..types import CSRMatrix, SymBellMatrix
from ..types.base import as_numpy_dtype

_NOT_PORTED = {
    "auto": "the pattern-based layout choice needs the DIA and SELL layouts",
    "bell": "full-storage blocked-ELL comes with its two kernels",
    "dia": "the DIA layout",
    "symdia": "the symmetric DIA layout",
    "sell": "the SELL layout",
}


def read_csr_host(path, dtype=np.float64):
    """Parse a .mtx file to host CSR, preferring the native C++ reader."""
    from . import native

    if native.available():
        return native.read_mtx_csr_native(path, dtype=dtype)
    from .mtx import read_mtx_csr

    return read_mtx_csr(path, dtype=dtype)


def load_matrix(path, layout: str = "auto", dtype=np.float32, bm: int = 8,
                bn: int = 128, reorder: bool = False, device="cpu"):
    """Load a MatrixMarket file as an operator on ``device``.

    ``layout``: ``"csr"`` or ``"symbell"`` (symmetric blocked-ELL with
    bn x bn tiles; the symmetry check is on, so a non-symmetric file fails
    here).  ``bm`` is the row tile of the full blocked-ELL layout; csr and
    symbell ignore it, as in the JAX package.  The JAX package's other
    layouts and ``reorder=True`` raise NotImplementedError naming the port
    item that brings them (ROADMAP.md, "Modules to port").
    """
    if layout in _NOT_PORTED:
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet ({_NOT_PORTED[layout]}; "
            "ROADMAP.md, Modules to port)")
    if layout not in ("csr", "symbell"):
        raise ValueError(f"unknown layout {layout!r} (want 'csr' or 'symbell')")
    if reorder:
        raise NotImplementedError(
            "reorder=True is not ported yet (reorder.py; ROADMAP.md, "
            "Modules to port)")
    data, indices, indptr, shape = read_csr_host(path, dtype=np.float64)
    dt = as_numpy_dtype(dtype)
    if layout == "csr":
        return CSRMatrix.from_arrays(data, indices, indptr, shape, dtype=dt,
                                     device=device)
    return SymBellMatrix.from_csr_host(data.astype(dt), indices, indptr, shape,
                                       bn=bn, check=True, device=device)
