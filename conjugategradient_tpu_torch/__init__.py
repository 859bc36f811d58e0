"""conjugategradient_tpu_torch — the PyTorch / CUDA port of
conjugategradient_tpu for NVIDIA Hopper GPUs.

Layouts: CSR, blocked-ELL in full or symmetric storage, DIA in full or
symmetric storage, and SELL; ``load_matrix(layout="auto")`` picks one from
the sparsity pattern.  The matrix-free 3-D 7-point ``StencilOperator``
(the tester's ``stencil:<nx>[x<ny>x<nz>]`` input) has its own fused CG
and the geometric-multigrid preconditioner ``multigrid_preconditioner``.
Blocked-ELL CG and Jacobi PCG, and stencil CG, run as two hand-written
CUDA kernels per iteration (``ops/cuda``, sources in ``csrc/``); the full
blocked-ELL SpMV, both DIA SpMVs and the stencil apply (float32 and
float64) are kernels of their own, under the portable loop and multigrid.
MINRES for symmetric indefinite systems (``minres_solve``, with a shift)
runs on blocked-ELL as two more such kernels per iteration, and on every
other layout as a portable loop.  CSR, SELL and the rest of the portable
loops run in plain torch.  Entry
points put operators on the card (``"cuda"``) unless the caller passes
``device="cpu"``.  Imports torch, never jax.
"""

from .io import load_matrix
from .solver import (
    CGInfo,
    MinresInfo,
    accuracy,
    cg_solve,
    expected_step_count,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    fused_minres_solve,
    fused_minres_supported,
    fused_stencil_cg_solve,
    jacobi_preconditioner,
    minres_solve,
    multigrid_preconditioner,
)
from .types import (
    BlockedEllMatrix,
    CSRMatrix,
    DenseOperator,
    DIAMatrix,
    LinearOperator,
    SellMatrix,
    StencilOperator,
    SymBellMatrix,
    SymDIAMatrix,
    as_linear_operator,
)

__all__ = [
    "BlockedEllMatrix",
    "CGInfo",
    "CSRMatrix",
    "DIAMatrix",
    "DenseOperator",
    "LinearOperator",
    "MinresInfo",
    "SellMatrix",
    "StencilOperator",
    "SymBellMatrix",
    "SymDIAMatrix",
    "accuracy",
    "as_linear_operator",
    "cg_solve",
    "expected_step_count",
    "fused_bell_cg_solve",
    "fused_bell_pcg_solve",
    "fused_minres_solve",
    "fused_minres_supported",
    "fused_stencil_cg_solve",
    "jacobi_preconditioner",
    "load_matrix",
    "minres_solve",
    "multigrid_preconditioner",
]
