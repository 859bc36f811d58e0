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
other layout as a portable loop.  BiCGStab for nonsymmetric systems
(``bicgstab_solve``) runs as a portable loop on every layout, and with
``fused="always"`` as three kernels per iteration on full blocked-ELL.
GMRES(m) (``gmres_solve``, right-preconditioned, FGMRES with
``flexible=True``) is a portable loop on every layout.  The
preconditioners are Jacobi, block-Jacobi (a DIA product, the DIA kernel on
the card, for blocks up to 16), Chebyshev (its interval from the device
Lanczos of ``lanczos_eigs``), the stencil's multigrid, and for assembled
matrices smoothed-aggregation AMG (``smoothed_aggregation_preconditioner``,
``rigid_body_modes``) and FSAI (``fsai_preconditioner``), their setup on
the host and their applies on the layouts' SpMVs.  ``sstep_cg_solve`` and
``solver.pipelined_cg_solve`` are CG with one reduction per s steps or one
pass of dots per step; ``CG`` is the
reference's object API, and ``solver.save_state`` / ``load_state`` /
``run_cg`` checkpoint a solve.  Many right-hand sides with one operator:
``cg_solve_batched`` (lockstep CG; ``solver.batched_cg_init`` /
``run_batched_cg`` checkpoint it), ``block_cg_solve`` (one shared
block-Krylov space) and ``minres_solve_batched``,
``bicgstab_solve_batched``, ``gmres_solve_batched``, on the layouts'
multi-RHS SpMVs (``ops.*_spmv_multi``, plain torch).  Eigenpairs and
deflation: ``lobpcg_eigs`` (preconditioned block eigensolver, a B pencil
too), ``deflated_cg_solve`` with a ``DeflationBasis`` from
``make_deflation_basis`` or ``harvest_deflation_basis``; the
``scipy_compat`` module speaks ``scipy.sparse.linalg``'s signatures.  CSR,
SELL and the rest of the portable loops run in plain torch.  Entry
points put operators on the card (``"cuda"``) unless the caller passes
``device="cpu"``.  Imports torch, never jax.
"""

from .compat import CG
from .io import load_matrix, read_mtx_csr, write_mtx
from .solver import (
    BicgstabInfo,
    CGInfo,
    CGState,
    DeflationBasis,
    EigsResult,
    GmresInfo,
    MinresInfo,
    RefineInfo,
    accuracy,
    bicgstab_solve,
    bicgstab_solve_batched,
    block_cg_solve,
    block_jacobi_preconditioner,
    cg_init,
    cg_solve,
    cg_solve_batched,
    cg_step,
    condition_estimate,
    deflated_cg_solve,
    expected_step_count,
    fsai_preconditioner,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    fused_bicgstab_solve,
    fused_bicgstab_supported,
    fused_minres_solve,
    fused_minres_supported,
    fused_stencil_cg_solve,
    gmres_solve,
    gmres_solve_batched,
    harvest_deflation_basis,
    implicit_cg_solve,
    implicit_gmres_solve,
    jacobi_preconditioner,
    lanczos_eigs,
    lobpcg_eigs,
    make_deflation_basis,
    memory_footprint,
    minres_solve,
    minres_solve_batched,
    multigrid_preconditioner,
    refined_cg_solve,
    rigid_body_modes,
    smoothed_aggregation_preconditioner,
    sstep_cg_solve,
)
from .types import (
    BlockedEllMatrix,
    CSRMatrix,
    DenseOperator,
    DIAMatrix,
    LinearOperator,
    MatrixFreeOperator,
    SellMatrix,
    StencilOperator,
    SymBellMatrix,
    SymDIAMatrix,
    as_linear_operator,
)

__version__ = "0.1.0"

__all__ = [
    "BicgstabInfo",
    "BlockedEllMatrix",
    "CG",
    "CGInfo",
    "CGState",
    "CSRMatrix",
    "DIAMatrix",
    "DeflationBasis",
    "DenseOperator",
    "EigsResult",
    "GmresInfo",
    "LinearOperator",
    "MatrixFreeOperator",
    "MinresInfo",
    "RefineInfo",
    "SellMatrix",
    "StencilOperator",
    "SymBellMatrix",
    "SymDIAMatrix",
    "accuracy",
    "__version__",
    "as_linear_operator",
    "bicgstab_solve",
    "bicgstab_solve_batched",
    "block_cg_solve",
    "block_jacobi_preconditioner",
    "cg_init",
    "cg_solve",
    "cg_solve_batched",
    "cg_step",
    "condition_estimate",
    "deflated_cg_solve",
    "expected_step_count",
    "fsai_preconditioner",
    "fused_bell_cg_solve",
    "fused_bell_pcg_solve",
    "fused_bicgstab_solve",
    "fused_bicgstab_supported",
    "fused_minres_solve",
    "fused_minres_supported",
    "fused_stencil_cg_solve",
    "gmres_solve",
    "gmres_solve_batched",
    "harvest_deflation_basis",
    "implicit_cg_solve",
    "implicit_gmres_solve",
    "jacobi_preconditioner",
    "lanczos_eigs",
    "load_matrix",
    "lobpcg_eigs",
    "make_deflation_basis",
    "memory_footprint",
    "minres_solve",
    "minres_solve_batched",
    "multigrid_preconditioner",
    "refined_cg_solve",
    "read_mtx_csr",
    "rigid_body_modes",
    "smoothed_aggregation_preconditioner",
    "sstep_cg_solve",
    "write_mtx",
]
