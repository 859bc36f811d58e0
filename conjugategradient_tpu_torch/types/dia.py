"""DIA layouts on torch tensors: full storage (``DIAMatrix``) and symmetric
half-band storage (``SymDIAMatrix``).  Counterpart of
``conjugategradient_tpu/types/dia.py``: the host packing is the same numpy
code, so both packages hold bitwise-equal diagonals.

Neither class carries the JAX package's pre-blocked copy (``with_blocked``,
``diags_blocked``): that layout exists to keep XLA:TPU from relayouting the
row-major ``(ndiag, n)`` array in front of a Pallas call every iteration.
The CUDA kernels (``ops/cuda/dia_spmv.py``) read ``(ndiag, n)`` directly,
one coalesced row segment per diagonal, so there is nothing to avoid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import DEFAULT_DEVICE, LinearOperator, as_numpy_dtype, cast_values
from .csr import CSRMatrix


def _offsets_tensor(offsets, device) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int32).to(device)


@dataclasses.dataclass(frozen=True)
class DIAMatrix(LinearOperator):
    """``diags[d, i] = A[i, i + offsets[d]]`` for each stored diagonal, in
    ascending offset order; slots that fall outside the matrix are zero.

    ``offsets_dev`` is ``offsets`` as an int32 tensor on the diagonals'
    device, made once at construction for the CUDA kernel.
    """

    diags: torch.Tensor  # (ndiag, n)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int  # true nnz (before padding)
    offsets_dev: Optional[torch.Tensor] = None  # (ndiag,) int32

    def __post_init__(self):
        object.__setattr__(self, "offsets", tuple(int(o) for o in self.offsets))
        if self.offsets_dev is None:
            object.__setattr__(self, "offsets_dev",
                               _offsets_tensor(self.offsets, self.diags.device))

    @staticmethod
    def from_csr_host(
        data: np.ndarray,
        indices: np.ndarray,
        indptr: np.ndarray,
        shape: Tuple[int, int],
        dtype=None,
        max_diags: Optional[int] = None,
        device=DEFAULT_DEVICE,
    ) -> "DIAMatrix":
        """Host-side CSR -> DIA, then one copy to ``device``.  Raises
        ValueError if the matrix touches more than ``max_diags`` distinct
        diagonals."""
        n, ncols = shape
        data = np.asarray(data)
        if dtype is not None:
            data = data.astype(as_numpy_dtype(dtype))
        indices = np.asarray(indices, dtype=np.int64)
        indptr = np.asarray(indptr, dtype=np.int64)
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        offs = indices - row_ids
        uniq = np.unique(offs)
        if max_diags is not None and len(uniq) > max_diags:
            raise ValueError(
                f"matrix touches {len(uniq)} diagonals > max_diags={max_diags}"
            )
        slot = np.searchsorted(uniq, offs)
        diags = np.zeros((len(uniq), n), dtype=data.dtype)
        np.add.at(diags, (slot, row_ids), data)
        return cast_values(DIAMatrix(
            torch.from_numpy(diags).to(torch.device(device)),
            tuple(int(o) for o in uniq),
            (n, ncols),
            int(len(data)),
        ), dtype)

    @staticmethod
    def from_csr(csr: CSRMatrix, max_diags: Optional[int] = None) -> "DIAMatrix":
        """Repack a ``CSRMatrix`` (host round trip), on its device."""
        return DIAMatrix.from_csr_host(
            csr.data.cpu().numpy(), csr.indices.cpu().numpy(),
            csr.indptr.cpu().numpy(), csr.shape, max_diags=max_diags,
            device=csr.device,
        )

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    def to(self, device) -> "DIAMatrix":
        return dataclasses.replace(self, diags=self.diags.to(device),
                                   offsets_dev=self.offsets_dev.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import dia_spmv

        return dia_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        # a zero diagonal would silently turn Jacobi's 1/diag into inf; an
        # SPD operator always has a positive main diagonal, so one without
        # it is a construction error
        raise ValueError(
            "DIAMatrix stores no main diagonal (offset 0); diagonal() is "
            "undefined for it — an SPD operator must have one"
        )

    def to_dense(self) -> torch.Tensor:
        n, ncols = self.shape
        out = torch.zeros((n, ncols), dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            valid = (cols >= 0) & (cols < ncols)
            out.index_put_((rows[valid], cols[valid]), self.diags[d][valid],
                           accumulate=True)
        return out

    def memory_footprint(self) -> int:
        return self.diags.numel() * self.diags.element_size()

    def padding_ratio(self) -> float:
        """Stored slots / true nnz — the bandwidth overhead of the layout."""
        return float(self.diags.numel()) / max(self.nnz, 1)

    def astype(self, dtype) -> "DIAMatrix":
        return dataclasses.replace(self, diags=self.diags.to(dtype))


@dataclasses.dataclass(frozen=True)
class SymDIAMatrix(LinearOperator):
    """Symmetric DIA: only the offsets ≥ 0 stored, each applied both ways,

        y[i] += d_k[i] · x[i + k]          (the stored direction)
        y[i] += d_k[i − k] · x[i − k]      (its mirror, k > 0)

    so one SpMV streams the stored half-band only.  ``offsets_dev`` as in
    :class:`DIAMatrix`.
    """

    diags: torch.Tensor  # (ndiag_nonneg, n)
    offsets: Tuple[int, ...]  # all >= 0, ascending
    shape: Tuple[int, int]
    nnz: int  # true nnz of the full (expanded) matrix
    offsets_dev: Optional[torch.Tensor] = None

    def __post_init__(self):
        object.__setattr__(self, "offsets", tuple(int(o) for o in self.offsets))
        if self.offsets_dev is None:
            object.__setattr__(self, "offsets_dev",
                               _offsets_tensor(self.offsets, self.diags.device))

    @staticmethod
    def from_dia(dia: DIAMatrix, check: bool = True) -> "SymDIAMatrix":
        """Repack a full DIA operator into symmetric storage (host round
        trip), on its device.

        ``check=True`` verifies each dropped −k diagonal equals its +k
        mirror re-indexed; a ±k diagonal whose partner is missing must be
        all-zero.
        """
        n, ncols = dia.shape
        if n != ncols:
            raise ValueError(f"symmetric layout needs a square system, got {dia.shape}")
        diags = dia.diags.cpu().numpy()
        offs = dia.offsets
        pos = [d for d, o in enumerate(offs) if o >= 0]
        by_off = {o: d for d, o in enumerate(offs)}
        if check:
            for d, o in enumerate(offs):
                if o >= 0:
                    continue
                k = -o
                dneg = diags[d]
                if k in by_off:
                    dpos = diags[by_off[k]]
                    # A[i, i−k] = A[i−k, i]: dneg[i] == dpos[i−k] for i >= k
                    if not (
                        np.allclose(dneg[k:], dpos[: n - k])
                        and not dneg[:k].any()
                    ):
                        raise ValueError(f"diagonal {o} is not symmetric")
                elif dneg.any():
                    raise ValueError(
                        f"diagonal {o} has no +{k} mirror and is nonzero"
                    )
            for d, o in enumerate(offs):
                if o > 0 and -o not in by_off and diags[d].any():
                    raise ValueError(
                        f"diagonal +{o} has no -{o} mirror and is nonzero"
                    )
        return SymDIAMatrix(
            torch.from_numpy(np.ascontiguousarray(diags[pos])).to(dia.device),
            tuple(offs[d] for d in pos),
            dia.shape,
            dia.nnz,
        )

    @staticmethod
    def from_csr(csr: CSRMatrix, max_diags: Optional[int] = None,
                 check: bool = True) -> "SymDIAMatrix":
        return SymDIAMatrix.from_dia(
            DIAMatrix.from_csr(csr, max_diags=max_diags), check=check
        )

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    def to(self, device) -> "SymDIAMatrix":
        return dataclasses.replace(self, diags=self.diags.to(device),
                                   offsets_dev=self.offsets_dev.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import sym_dia_spmv

        return sym_dia_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        raise ValueError(
            "SymDIAMatrix stores no main diagonal (offset 0); diagonal() "
            "is undefined for it — an SPD operator must have one"
        )

    def to_dense(self) -> torch.Tensor:
        n = self.shape[0]
        out = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)
        for d, off in enumerate(self.offsets):
            ok = rows + off < n
            r, c, v = rows[ok], rows[ok] + off, self.diags[d][ok]
            out.index_put_((r, c), v, accumulate=True)
            if off > 0:
                out.index_put_((c, r), v, accumulate=True)
        return out

    def memory_footprint(self) -> int:
        return self.diags.numel() * self.diags.element_size()

    def full_diag_bytes(self) -> int:
        """Bytes the equivalent full DIA layout streams per SpMV (each
        stored off-diagonal serves both halves)."""
        n_off = sum(1 for o in self.offsets if o > 0)
        return (len(self.offsets) + n_off) * self.shape[0] * self.diags.element_size()

    def astype(self, dtype) -> "SymDIAMatrix":
        return dataclasses.replace(self, diags=self.diags.to(dtype))
