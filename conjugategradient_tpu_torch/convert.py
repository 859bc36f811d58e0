"""Carry operators and solver state across from the JAX package.

Each function takes the JAX package's arrays as numpy (``np.asarray`` of a
jax array) and returns this package's object on ``device``, so both
packages can compute on identical operators and states.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops.cuda.fused_cg import S_BETA, S_RHO, S_RNORM, FusedWork
from .solver.fused import FusedCGState
from .types import BlockedEllMatrix, CSRMatrix, SymBellMatrix


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def bell_from_arrays(blocks, block_cols, shape: Tuple[int, int], nnz: int,
                     device="cpu") -> BlockedEllMatrix:
    """A ``BlockedEllMatrix`` from the JAX one's fields."""
    return BlockedEllMatrix(_t(blocks, device), _t(block_cols, device, np.int32),
                            tuple(shape), int(nnz))


def sym_bell_from_arrays(diag_blocks, off_blocks, off_cols,
                         shape: Tuple[int, int], nnz: int, full_kmax: int,
                         banded: bool, device="cpu") -> SymBellMatrix:
    """A ``SymBellMatrix`` from the JAX one's fields (the transposed mirror
    index is derived here)."""
    return SymBellMatrix(
        _t(diag_blocks, device), _t(off_blocks, device),
        _t(off_cols, device, np.int32), tuple(shape), int(nnz),
        int(full_kmax), bool(banded),
    )


def csr_from_arrays(data, indices, indptr, shape: Tuple[int, int],
                    device="cpu") -> CSRMatrix:
    """A ``CSRMatrix`` from the JAX one's ``data``/``indices``/``indptr``."""
    return CSRMatrix.from_arrays(np.asarray(data), np.asarray(indices),
                                 np.asarray(indptr), tuple(shape),
                                 device=device)


def fused_state_from_arrays(x, r, p, beta, rho, k: int, done: bool, hist,
                            tol: float = 0.0, device="cpu") -> FusedCGState:
    """A plain-CG ``FusedCGState`` from the JAX ``FusedCGState`` fields:
    (rows, bn) vectors x, r, p; scalars beta, rho (= ‖r‖²); k, done; the
    history, whose length sets maxiter."""
    hist = np.array(hist, np.float32, copy=True)
    maxiter = len(hist) - 1
    rho = float(np.asarray(rho).reshape(-1)[0])
    work = FusedWork.new(device, maxiter=maxiter, tol=tol)
    work.scal[S_BETA] = float(np.asarray(beta).reshape(-1)[0])
    work.scal[S_RHO] = rho
    work.scal[S_RNORM] = rho
    work.ctl.copy_(torch.tensor(
        [k, int(done), maxiter, int(not done and k < maxiter)],
        dtype=torch.int32))
    work.hist.copy_(torch.from_numpy(hist))
    x, r, p = (_t(v, device, np.float32) for v in (x, r, p))
    return FusedCGState(x=x, r=r, p=p, work=work)
