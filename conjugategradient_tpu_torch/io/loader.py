"""Matrix ingest: MatrixMarket file -> operator on a torch device.
Counterpart of ``conjugategradient_tpu/io/loader.py``: the same layouts,
the same pattern-based ``"auto"`` choice with the same thresholds, and the
optional RCM reordering (with a degree sort on top for SELL).

* ``dia``  — diagonal storage; best when few distinct diagonals are
  touched: no index traffic, pure streaming (CUDA kernel on the card).
* ``symdia`` — the stored half-band of a symmetric DIA operator.
* ``bell`` / ``symbell`` — blocked-ELL dense tiles, full or symmetric.
* ``sell`` — degree-bucketed ELL for scattered patterns, where DIA and
  blocked-ELL pad too much.
* ``csr``  — gather + segmented sum; always correct.

``"auto"`` compares the padding (stored slots / true nnz) each streaming
layout would pay and picks the cheapest, falling back to SELL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..reorder import (
    count_diagonals,
    degree_sort_permutation,
    permute_csr,
    rcm_permutation,
)
from ..types import (
    BlockedEllMatrix,
    CSRMatrix,
    DIAMatrix,
    SellMatrix,
    SymBellMatrix,
    SymDIAMatrix,
)
from ..types.base import DEFAULT_DEVICE, as_numpy_dtype, is_bfloat16

LAYOUTS = ("auto", "csr", "sell", "bell", "symbell", "dia", "symdia")

# auto-policy thresholds: a streaming layout is admissible while its padding
# (stored slots / nnz) stays under these; DIA is also capped on its
# diagonal count
_DIA_MAX_PADDING = 5.0
_DIA_MAX_DIAGS = 512
_BELL_MAX_PADDING = 16.0


def read_csr_host(path, dtype=np.float64):
    """Parse a .mtx file to host CSR, preferring the native C++ reader."""
    from . import native

    if native.available():
        return native.read_mtx_csr_native(path, dtype=dtype)
    from .mtx import read_mtx_csr

    return read_mtx_csr(path, dtype=dtype)


def choose_layout(
    indices: np.ndarray,
    indptr: np.ndarray,
    shape: Tuple[int, int],
    bm: int = 8,
    bn: int = 128,
) -> str:
    """Pick 'dia' / 'bell' / 'sell' from the sparsity pattern (module doc)."""
    n = shape[0]
    nnz = max(int(len(indices)), 1)

    ndiag = count_diagonals(indices, indptr)
    dia_padding = ndiag * n / nnz
    if ndiag <= _DIA_MAX_DIAGS and dia_padding <= _DIA_MAX_PADDING:
        return "dia"

    # blocked-ELL padding estimate: kmax from a cheap host pass
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    rb = row_ids // bm
    cb = np.asarray(indices, dtype=np.int64) // bn
    pairs = np.unique(rb * (2**32) + cb)
    kmax_counts = np.bincount((pairs // (2**32)).astype(np.int64))
    kmax = int(kmax_counts.max()) if len(kmax_counts) else 1
    nrb = -(-n // bm)
    bell_padding = nrb * kmax * bm * bn / nnz
    if bell_padding <= _BELL_MAX_PADDING:
        return "bell"
    # scattered pattern: no streaming layout exists
    return "sell"


def load_matrix(path, layout: str = "auto", dtype=np.float32, bm: int = 8,
                bn: int = 128, reorder: bool = False, device=DEFAULT_DEVICE):
    """Load a MatrixMarket file as an operator on ``device`` (the card
    unless the caller names another).

    ``layout``: one of ``LAYOUTS``; ``"auto"`` resolves through
    :func:`choose_layout` with these ``bm``/``bn``.  ``bell`` packs bm x bn
    tiles, ``symbell`` bn x bn tiles; the symmetric layouts check symmetry,
    so a non-symmetric file fails here.  ``reorder=True`` applies the RCM
    permutation first (and, when the layout resolves to ``sell``, a stable
    degree sort on top, so the packed ``pos`` is the identity) and returns
    ``(operator, perm)`` with ``perm[new] = old``: solve ``A' y = b[perm]``
    and map back with ``reorder.unpermute_vector``.

    ``dtype``: float32, float64 or bfloat16 (numpy, torch or a name).  A
    bfloat16 operator is built in float32 and cast (``astype``), so its
    values are the file's float64 rounded to float32 and then to bfloat16,
    bit for bit the JAX loader's.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (want one of {', '.join(LAYOUTS)})")
    data, indices, indptr, shape = read_csr_host(path, dtype=np.float64)
    perm = None
    if reorder:
        perm = rcm_permutation(indices, indptr, shape[0])
        data, indices, indptr = permute_csr(data, indices, indptr, shape, perm)
    if layout == "auto":
        layout = choose_layout(indices, indptr, shape, bm=bm, bn=bn)
    if layout == "sell" and reorder:
        dperm = degree_sort_permutation(indices, indptr, shape[0])
        data, indices, indptr = permute_csr(data, indices, indptr, shape, dperm)
        perm = perm[dperm]  # compose: total[new] = rcm[degree_sort[new]]
    dt = as_numpy_dtype(dtype)
    vals = data.astype(dt)
    if layout == "csr":
        op = CSRMatrix.from_arrays(vals, indices, indptr, shape, device=device)
    elif layout == "sell":
        op = SellMatrix.from_csr_host(vals, indices, indptr, shape, device=device)
    elif layout == "bell":
        op = BlockedEllMatrix.from_csr_host(vals, indices, indptr, shape, bm=bm,
                                            bn=bn, device=device)
    elif layout == "symbell":
        op = SymBellMatrix.from_csr_host(vals, indices, indptr, shape, bn=bn,
                                         check=True, device=device)
    elif layout == "dia":
        op = DIAMatrix.from_csr_host(vals, indices, indptr, shape, device=device)
    else:
        # symmetric repack on the host, then one copy of the half-band
        full = DIAMatrix.from_csr_host(vals, indices, indptr, shape, device="cpu")
        op = SymDIAMatrix.from_dia(full, check=True).to(device)
    if is_bfloat16(dtype):
        op = op.astype(torch.bfloat16)
    return (op, perm) if reorder else op
