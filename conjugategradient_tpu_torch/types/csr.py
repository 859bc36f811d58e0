"""CSR container on torch tensors — the portable layout and the tester's
default (``--layout csr --dtype float64``).  Counterpart of
``conjugategradient_tpu/types/csr.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import LinearOperator, as_numpy_dtype


@dataclasses.dataclass(frozen=True)
class CSRMatrix(LinearOperator):
    """``data[nnz]``, ``indices[nnz]`` (int32), ``indptr[n+1]`` (int32) as
    in the reference's ``Matrix<DT>``; ``row_ids[nnz]`` and ``lengths[n]``
    (int64) are precomputed host-side once for the segmented matvec."""

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    row_ids: torch.Tensor
    lengths: torch.Tensor
    shape: Tuple[int, int]

    @staticmethod
    def from_arrays(
        data: np.ndarray,
        indices: np.ndarray,
        indptr: np.ndarray,
        shape: Optional[Tuple[int, int]] = None,
        dtype=None,
        device="cpu",
    ) -> "CSRMatrix":
        """Build from host CSR arrays (the reference's ``setMatrix``)."""
        data = np.asarray(data)
        if dtype is not None:
            data = data.astype(as_numpy_dtype(dtype))
        indices = np.asarray(indices, dtype=np.int32)
        indptr = np.asarray(indptr, dtype=np.int32)
        n = len(indptr) - 1
        if shape is None:
            ncols = int(indices.max()) + 1 if len(indices) else n
            shape = (n, max(n, ncols))
        lengths = np.diff(indptr).astype(np.int64)
        row_ids = np.repeat(np.arange(n, dtype=np.int32), lengths)
        # copies: numpy views of another framework's buffers are read-only
        dev = torch.device(device)
        return CSRMatrix(
            *(torch.from_numpy(np.array(a, copy=True)).to(dev)
              for a in (data, indices, indptr, row_ids, lengths)),
            tuple(shape),
        )

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
        dtype=None,
        sum_duplicates: bool = True,
        device="cpu",
    ) -> "CSRMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows):
            # same bincount duplicate sum as io/mtx.read_mtx_csr, so the two
            # ingest paths give the same CSR
            first = np.ones(len(rows), dtype=bool)
            first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            if not first.all():
                group = np.cumsum(first) - 1
                vals = np.bincount(group, weights=vals).astype(vals.dtype)
                rows, cols = rows[first], cols[first]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRMatrix.from_arrays(vals, cols, indptr, shape, dtype=dtype,
                                     device=device)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import csr_spmv

        return csr_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        from ..ops.spmv import segment_sum

        on_diag = self.indices == self.row_ids
        return segment_sum(
            torch.where(on_diag, self.data, torch.zeros_like(self.data)),
            self.lengths,
        )

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_(
            (self.row_ids.long(), self.indices.long()), self.data, accumulate=True
        )
