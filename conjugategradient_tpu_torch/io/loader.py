"""Matrix ingest: MatrixMarket file -> operator on a torch device.
Counterpart of ``conjugategradient_tpu/io/loader.py`` for the layouts this
package has so far (``csr``, ``bell``, ``symbell``), with the optional RCM
reordering."""

from __future__ import annotations

import numpy as np

from ..reorder import permute_csr, rcm_permutation
from ..types import BlockedEllMatrix, CSRMatrix, SymBellMatrix
from ..types.base import as_numpy_dtype

_NOT_PORTED = {
    "auto": "the pattern-based layout choice needs the DIA and SELL layouts",
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

    ``layout``: ``"csr"``, ``"bell"`` (full blocked-ELL with bm x bn tiles)
    or ``"symbell"`` (symmetric blocked-ELL with bn x bn tiles; the symmetry
    check is on, so a non-symmetric file fails here).  csr and symbell
    ignore ``bm``, as in the JAX package.  ``reorder=True`` applies the RCM
    permutation first and returns ``(operator, perm)`` with
    ``perm[new] = old``: solve ``A' y = b[perm]`` and map back with
    ``reorder.unpermute_vector``.  The JAX package's other layouts raise
    NotImplementedError naming the port item that brings them (ROADMAP.md,
    "Modules to port").
    """
    if layout in _NOT_PORTED:
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet ({_NOT_PORTED[layout]}; "
            "ROADMAP.md, Modules to port)")
    if layout not in ("csr", "bell", "symbell"):
        raise ValueError(
            f"unknown layout {layout!r} (want 'csr', 'bell' or 'symbell')")
    data, indices, indptr, shape = read_csr_host(path, dtype=np.float64)
    perm = None
    if reorder:
        perm = rcm_permutation(indices, indptr, shape[0])
        data, indices, indptr = permute_csr(data, indices, indptr, shape, perm)
    dt = as_numpy_dtype(dtype)
    if layout == "csr":
        op = CSRMatrix.from_arrays(data, indices, indptr, shape, dtype=dt,
                                   device=device)
    elif layout == "bell":
        op = BlockedEllMatrix.from_csr_host(data.astype(dt), indices, indptr,
                                            shape, bm=bm, bn=bn, device=device)
    else:
        op = SymBellMatrix.from_csr_host(data.astype(dt), indices, indptr,
                                         shape, bn=bn, check=True, device=device)
    return (op, perm) if reorder else op
