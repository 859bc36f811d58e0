"""CSR container on torch tensors — the portable layout and the tester's
default (``--layout csr --dtype float64``).  Counterpart of
``conjugategradient_tpu/types/csr.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .base import DEFAULT_DEVICE, LinearOperator, _is_scipy_sparse, as_numpy_dtype, cast_values


@dataclasses.dataclass(frozen=True)
class CSRMatrix(LinearOperator):
    """``data[nnz]``, ``indices[nnz]`` (int32), ``indptr[n+1]`` (int32) as
    in the reference's ``Matrix<DT>``; ``row_ids[nnz]`` is precomputed
    host-side once for the segmented matvec.  The first five fields are the
    JAX package's, in its order; ``lengths[n]`` (int64 row lengths, the
    segmented sum's operand) is derived from ``indptr`` when not given."""

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    row_ids: torch.Tensor
    shape: Tuple[int, int]
    lengths: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.lengths is None:
            object.__setattr__(self, "lengths", (self.indptr[1:] - self.indptr[:-1]).long())

    @staticmethod
    def from_arrays(
        data: np.ndarray,
        indices: np.ndarray,
        indptr: np.ndarray,
        shape: Optional[Tuple[int, int]] = None,
        dtype=None,
        device=DEFAULT_DEVICE,
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
        return cast_values(CSRMatrix(
            *(torch.from_numpy(np.array(a, copy=True)).to(dev)
              for a in (data, indices, indptr, row_ids)),
            tuple(shape),
        ), dtype)

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
        dtype=None,
        sum_duplicates: bool = True,
        device=DEFAULT_DEVICE,
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

    @staticmethod
    def from_dense(a, dtype=None, device=DEFAULT_DEVICE) -> "CSRMatrix":
        """The nonzeros of a dense 2-D array."""
        a = np.asarray(a)
        rows, cols = np.nonzero(a)
        return CSRMatrix.from_coo(rows, cols, a[rows, cols], a.shape, dtype=dtype,
                                  device=device)

    @staticmethod
    def from_scipy(a: Any, dtype=None, device=DEFAULT_DEVICE) -> "CSRMatrix":
        """A scipy.sparse matrix of any format (duck-typed: no scipy import),
        canonicalized as the JAX package does: duplicates summed, column
        indices sorted, on a copy, never on the caller's matrix."""
        if not _is_scipy_sparse(a):
            raise TypeError(f"not a scipy.sparse-like matrix: {type(a)!r}")
        if not hasattr(a, "indptr") or getattr(a, "format", "csr") != "csr":
            a = a.tocsr()
        elif hasattr(a, "copy"):
            a = a.copy()
        if hasattr(a, "sum_duplicates"):
            a.sum_duplicates()
        if hasattr(a, "sort_indices"):
            a.sort_indices()
        return CSRMatrix.from_arrays(np.asarray(a.data), np.asarray(a.indices),
                                     np.asarray(a.indptr), tuple(a.shape), dtype=dtype,
                                     device=device)

    @staticmethod
    def from_torch(a: Any, dtype=None, device=DEFAULT_DEVICE) -> "CSRMatrix":
        """A sparse torch tensor (``sparse_csr``, ``sparse_coo``, CSC or a
        blocked layout), through the host once: COO is coalesced
        (duplicates summed), the other layouts go through torch's own
        ``to_sparse_csr``.  bfloat16 values stay bfloat16 unless ``dtype``
        says otherwise.  Complex and dense tensors are refused, as in the
        JAX package."""
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"not a torch.Tensor: {type(a)!r}")
        if a.is_complex():
            raise ValueError(
                "complex torch operators are not supported: the solvers cover "
                "real systems (the MatrixMarket ingest's contract, io/mtx.py)")
        if a.dim() != 2:
            raise ValueError(f"expected a 2-D sparse matrix, got shape {tuple(a.shape)}")
        if a.layout == torch.strided:
            raise ValueError(
                "dense (strided) torch tensor: pass it to as_linear_operator "
                "(dense operators stay dense: DenseOperator), or call "
                ".to_sparse_csr() first if CSR is really wanted")
        a = a.detach().cpu()
        shape = tuple(int(s) for s in a.shape)
        target = dtype
        if target is None and a.dtype == torch.bfloat16:
            target = torch.bfloat16
        if target == torch.bfloat16:  # numpy has no bfloat16: widen in transit
            a = a.to(torch.float32)
            dtype = None
        if a.layout == torch.sparse_coo:
            a = a.coalesce()
            idx = a.indices().numpy()
            out = CSRMatrix.from_coo(idx[0], idx[1], a.values().numpy(), shape, dtype=dtype,
                                     device=device)
        else:
            if a.layout != torch.sparse_csr:
                try:
                    a = a.to_sparse_csr()
                except (RuntimeError, NotImplementedError) as e:
                    raise ValueError(f"torch layout {a.layout} has no CSR conversion in "
                                     f"this torch build: {e}") from e
            out = CSRMatrix.from_arrays(a.values().numpy(), a.col_indices().numpy(),
                                        a.crow_indices().numpy(), shape, dtype=dtype,
                                        device=device)
        return out.astype(torch.bfloat16) if target == torch.bfloat16 else out

    def to_torch(self) -> torch.Tensor:
        """A CPU ``torch.sparse_csr_tensor`` with int64 indices (the round
        trip of :meth:`from_torch`)."""
        return torch.sparse_csr_tensor(self.indptr.long().cpu(), self.indices.long().cpu(),
                                       self.data.cpu(), size=self.shape)

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

    def memory_footprint(self) -> int:
        """Bytes on the device: the JAX package's four arrays (data,
        indices, indptr, row_ids) and the port's int64 row lengths."""
        return sum(t.numel() * t.element_size()
                   for t in (self.data, self.indices, self.indptr, self.row_ids, self.lengths))

    def astype(self, dtype) -> "CSRMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))
