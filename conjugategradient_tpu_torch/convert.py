"""Carry operators and solver state across from the JAX package.

Each function takes the JAX package's arrays as numpy (``np.asarray`` of a
jax array) and returns this package's object on ``device``, so both
packages can compute on identical operators and states.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops.cuda import fused_bicgstab as fb
from .ops.cuda import fused_minres as fm
from .ops.cuda.fused_cg import S_BETA, S_RHO, S_RNORM, FusedWork
from .solver.fused import FusedCGState
from .solver.fused_bicgstab import FusedBicgstabState
from .solver.fused_minres import FusedMinresState
from .types import (
    DEFAULT_DEVICE,
    BlockedEllMatrix,
    CSRMatrix,
    DIAMatrix,
    SellMatrix,
    StencilOperator,
    SymBellMatrix,
    SymDIAMatrix,
)


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def bell_from_arrays(blocks, block_cols, shape: Tuple[int, int], nnz: int,
                     device=DEFAULT_DEVICE) -> BlockedEllMatrix:
    """A ``BlockedEllMatrix`` from the JAX one's fields."""
    return BlockedEllMatrix(_t(blocks, device), _t(block_cols, device, np.int32),
                            tuple(shape), int(nnz))


def sym_bell_from_arrays(diag_blocks, off_blocks, off_cols,
                         shape: Tuple[int, int], nnz: int, full_kmax: int,
                         banded: bool, device=DEFAULT_DEVICE) -> SymBellMatrix:
    """A ``SymBellMatrix`` from the JAX one's fields (the transposed mirror
    index is derived here)."""
    return SymBellMatrix(
        _t(diag_blocks, device), _t(off_blocks, device),
        _t(off_cols, device, np.int32), tuple(shape), int(nnz),
        int(full_kmax), bool(banded),
    )


def sharded_bell_from_arrays(blocks, block_cols,
                             device=DEFAULT_DEVICE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``parallel.partition_csr_rows`` output (``blocks`` (P, nrb,
    kmax, bm, bn), ``block_cols`` (P, nrb, kmax)) as this package's
    ``sharded_cg_solve`` operands on ``device``."""
    return _t(blocks, device), _t(block_cols, device, np.int32)


def csr_from_arrays(data, indices, indptr, shape: Tuple[int, int],
                    device=DEFAULT_DEVICE) -> CSRMatrix:
    """A ``CSRMatrix`` from the JAX one's ``data``/``indices``/``indptr``."""
    return CSRMatrix.from_arrays(np.asarray(data), np.asarray(indices),
                                 np.asarray(indptr), tuple(shape),
                                 device=device)


def dia_from_arrays(diags, offsets, shape: Tuple[int, int], nnz: int,
                    device=DEFAULT_DEVICE) -> DIAMatrix:
    """A ``DIAMatrix`` from the JAX one's ``diags``/``offsets`` (its
    pre-blocked copy, if any, is not carried: the port reads (ndiag, n))."""
    return DIAMatrix(_t(diags, device), tuple(int(o) for o in offsets),
                     tuple(shape), int(nnz))


def sym_dia_from_arrays(diags, offsets, shape: Tuple[int, int], nnz: int,
                        device=DEFAULT_DEVICE) -> SymDIAMatrix:
    """A ``SymDIAMatrix`` from the JAX one's ``diags``/``offsets``."""
    return SymDIAMatrix(_t(diags, device), tuple(int(o) for o in offsets),
                        tuple(shape), int(nnz))


def sell_from_arrays(diag, pos, cols_flat, vals_flat, bucket_meta,
                     shape: Tuple[int, int], nnz: int, pos_identity: bool,
                     device=DEFAULT_DEVICE) -> SellMatrix:
    """A ``SellMatrix`` from the JAX one's fields."""
    return SellMatrix(
        _t(diag, device), _t(pos, device, np.int32), _t(cols_flat, device, np.int32),
        _t(vals_flat, device), tuple((int(b), int(k)) for b, k in bucket_meta),
        tuple(shape), int(nnz), bool(pos_identity),
    )


def stencil_from_arrays(center, off, grid_shape, device=DEFAULT_DEVICE) -> StencilOperator:
    """A ``StencilOperator`` from the JAX one's ``center``/``off`` 0-d
    arrays (as numpy; their dtype is the operator's) and ``grid_shape``."""
    center = np.asarray(center)
    dtype = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}[center.dtype]
    return StencilOperator(float(center), float(np.asarray(off)), tuple(grid_shape), dtype, device)


def fused_state_from_arrays(x, r, p, beta, rho, k: int, done: bool, hist,
                            tol: float = 0.0, device=DEFAULT_DEVICE) -> FusedCGState:
    """A plain-CG ``FusedCGState`` from the JAX ``FusedCGState`` fields:
    vectors x, r, p of any one shape — (rows, bn) blocks of the blocked-ELL
    loop or (nx, ny, nz) volumes of the stencil loop; scalars beta, rho
    (= ‖r‖²); k, done; the history, whose length sets maxiter."""
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


def fused_minres_state_from_arrays(
        x, r1, r2, vprev, wm1, wm2, beta, oldb, dbar, epsln, phibar, cs, sn,
        p_oldeps, p_delta, p_igamma, p_phi, k: int, done: bool, nan: bool, hist,
        tol: float = 0.0, shift: float = 0.0, inv_diag2d=None,
        device=DEFAULT_DEVICE) -> FusedMinresState:
    """A ``FusedMinresState`` from the JAX ``FusedMinresState``'s fields:
    the six (rows, bn) vectors (each gets a buffer of its own here: the
    port's step updates them in place), the (1, 1) scalars, k, done, nan and
    the history, whose length sets maxiter.  ``tol``, ``shift`` and the
    padded Jacobi diagonal ``inv_diag2d`` are arguments of the JAX step
    that the port keeps in the state."""
    def f(v) -> float:
        return float(np.asarray(v).reshape(-1)[0])

    hist = np.array(hist, np.float32, copy=True)
    maxiter = len(hist) - 1
    k, done, nan = int(k), bool(done), bool(nan)
    work = fm.MinresWork.new(device, maxiter=maxiter, tol=tol, shift=shift)
    scal = np.zeros(fm.N_SCAL, np.float32)
    for slot, val in (
        (fm.SU_INV_BETA, np.float32(1.0) / np.float32(f(beta))), (fm.SU_SHIFT, shift),
        (fm.SU_OLDEPS, f(p_oldeps)), (fm.SU_DELTA, f(p_delta)),
        (fm.SU_IGAMMA, f(p_igamma)), (fm.SU_PHI, f(p_phi)),
        (fm.M_BETA, f(beta)), (fm.M_OLDB, f(oldb)), (fm.M_DBAR, f(dbar)),
        (fm.M_EPSLN, f(epsln)), (fm.M_PHIBAR, f(phibar)), (fm.M_CS, f(cs)),
        (fm.M_SN, f(sn)), (fm.M_TOL, tol),
    ):
        scal[slot] = val
    work.scal.copy_(torch.from_numpy(scal))
    work.ctl.copy_(torch.tensor(
        [k, int(done), maxiter, int(not done and k < maxiter), int(nan)],
        dtype=torch.int32))
    work.hist.copy_(torch.from_numpy(hist))
    vecs = [_t(v, device, np.float32) for v in (x, r1, r2, vprev, wm1, wm2)]
    d = None if inv_diag2d is None else _t(inv_diag2d, device, np.float32)
    return FusedMinresState(*vecs, work=work, d=d, launched=k)


def fused_bicgstab_state_from_arrays(
        x, xprev, r, rhat, p, v, rho, rho_next, alpha, omega, rnorm, rnorm_prev,
        k: int, done: bool, broke: bool, hist, tol: float = 0.0, inv_diag2d=None,
        device=DEFAULT_DEVICE) -> FusedBicgstabState:
    """A ``FusedBicgstabState`` from the JAX ``FusedBicgstabState``'s
    fields: the six (rows, bn) vectors (each gets a buffer of its own), the
    (1, 1) scalars, k, done, broke and the history, whose length sets
    maxiter.  The JAX step computes β from ρ, ρ_next, α and ω at its start;
    the port's kernels find it computed in the state, so it is derived here
    the same way.  ``tol`` and the padded Jacobi diagonal ``inv_diag2d`` are
    arguments of the JAX step that the port keeps in the state."""
    def f(v) -> float:
        return float(np.asarray(v).reshape(-1)[0])

    hist = np.array(hist, np.float32, copy=True)
    maxiter = len(hist) - 1
    k, done, broke = int(k), bool(done), bool(broke)
    work = fb.BicgstabWork.new(device, maxiter=maxiter, tol=tol)
    scal = work.scal
    for slot, val in ((fb.B_RHO, rho), (fb.B_RHO_NEXT, rho_next), (fb.B_ALPHA, alpha),
                      (fb.B_OMEGA, omega), (fb.B_RNORM, rnorm), (fb.B_RNORM_PREV, rnorm_prev)):
        scal[slot] = f(val)
    fb.set_beta(scal, scal[fb.B_RHO_NEXT].clone())
    work.ctl.copy_(torch.tensor(
        [k, int(done), maxiter, int(not done and k < maxiter), int(broke), 0],
        dtype=torch.int32))
    work.hist.copy_(torch.from_numpy(hist))
    vecs = [_t(a, device, np.float32) for a in (x, xprev, r, rhat, p, v)]
    d = None if inv_diag2d is None else _t(inv_diag2d, device, np.float32)
    return FusedBicgstabState(*vecs, work=work, d=d, launched=k)
