"""Fused-kernel CG loop for the matrix-free stencil operator (BASELINE
config 4).  Counterpart of ``conjugategradient_tpu/solver/fused_stencil.py``:
the two-kernel iteration of solver/fused.py with the blocked-ELL pass
replaced by the stencil one (ops/cuda/fused_stencil.py):

    S1  p = r + β·p;  q = stencil(p);  pap = p·q     (fused_stencil_dir_dot)
    K2  x += α·p;  r −= α·q;  rnorm = r·r            (fused_update_dot_3d)

Semantics identical to solver/cg.py (pre-update termination, ρ == 0 guard,
N+1 cap, NaN exit).  State vectors stay (nx, ny, nz) volumes end to end; the
device scalars, the p double buffer, the host read every ``CHECK_EVERY``
steps and the masked restart are solver/fused.py's.  There is no fused
stencil PCG, in the JAX package or here: a preconditioned stencil solve runs
the portable loop.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..ops.cuda.fused_cg import S_RHO, S_RNORM, FusedWork
from ..ops.cuda.fused_stencil import fused_stencil_dir_dot, fused_update_dot_3d
from ..ops.spmv import full_precision_matmul
from ..types import StencilOperator
from .cg import CGInfo
from .fused import FusedCGState, run_fused


def fused_stencil_supported(op: Any, dtype=None) -> bool:
    """Whether the fused stencil path can run: a float32
    :class:`StencilOperator` with float32 vectors, on a CUDA device.

    The JAX gate ``nz % 128 == 0 and ny % 8 == 0 and nx % 2 == 0`` is
    dropped: it is Mosaic's block tiling, and the CUDA kernel masks ragged
    (y, z) tiles and x chunks itself.
    """
    return (
        isinstance(op, StencilOperator)
        and op.dtype == torch.float32
        and (dtype is None or dtype == torch.float32)
        and op.device.type == "cuda"
    )


def fused_stencil_cg_init(op: StencilOperator, b: torch.Tensor,
                          x0: Optional[torch.Tensor] = None, maxiter: int = 0,
                          *, tol: float = 0.0) -> FusedCGState:
    """r₀ = b − A·x₀ as a volume (no apply when x₀ is the default zero);
    p enters the loop through S1 with β = 0, so p₁ = r₀."""
    grid = op.grid_shape
    dev = op.device
    b3 = b.to(device=dev, dtype=torch.float32).reshape(grid)
    if x0 is None:
        x3 = torch.zeros_like(b3)
        r3 = b3.clone()  # updated in place by K2
    else:
        x3 = x0.to(device=dev, dtype=torch.float32).reshape(grid).clone()
        r3 = b3 - op.matvec(x3.reshape(-1)).to(torch.float32).reshape(grid)
    rnorm0 = torch.sum(r3 * r3)
    work = FusedWork.new(dev, maxiter=maxiter, tol=tol)
    work.scal[S_RHO] = rnorm0
    work.scal[S_RNORM] = rnorm0
    work.hist[0] = rnorm0
    return FusedCGState(x=x3, r=r3, p=torch.zeros_like(r3), work=work)


def fused_stencil_cg_step(op: StencilOperator, state: FusedCGState) -> FusedCGState:
    """One CG iteration in the two kernels, updating ``state`` in place;
    the p buffers swap."""
    w = state.work
    p_new, q, _ = fused_stencil_dir_dot(state.r, state.p, w.beta, op.center, op.off,
                                        out=(state.p_next, state.q), work=w)
    fused_update_dot_3d(state.x, p_new, state.r, q, w.alpha,
                        out=(state.x, state.r), work=w)
    state.p, state.p_next = p_new, state.p
    return state


def fused_stencil_cg_solve(
    op: StencilOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    recompute_r_every: int = 0,
) -> Tuple[torch.Tensor, CGInfo]:
    """Whole fused stencil CG solve.  On CUDA tensors each step launches
    the two kernels; on CPU tensors it runs their plain versions (the
    parity path the tests hold against the JAX package).
    ``recompute_r_every`` > 0 adds the restart step (r ← b − A·x through
    the stencil kernel, β ← 0, masked on the device) every that many
    iterations."""
    full_precision_matmul()
    maxiter = op.shape[0] + 1 if maxiter is None else int(maxiter)
    state = fused_stencil_cg_init(op, b, x0, maxiter, tol=tol)
    return run_fused(op, b, state, lambda: fused_stencil_cg_step(op, state), maxiter,
                     int(recompute_r_every))
