from .amg import rigid_body_modes, smoothed_aggregation_preconditioner
from .autodiff import implicit_cg_solve, implicit_gmres_solve
from .batched import (BatchedCGState, batched_cg_init, batched_state_result, cg_solve_batched,
                      run_batched_cg)
from .batched_nonsym import bicgstab_solve_batched, gmres_solve_batched, minres_solve_batched
from .bicgstab import BicgstabInfo, bicgstab_solve
from .blockcg import BlockCGState, block_cg_solve
from .cg import (CGInfo, CGState, accuracy, cg_init, cg_solve, cg_step, expected_step_count,
                 memory_footprint)
from .checkpoint import load_state, run_cg, save_state
from .deflated import (DeflationBasis, basis_quality, deflated_cg_solve,
                       deflation_basis_from_vectors, harvest_deflation_basis, make_deflation_basis)
from .eigs import EigsResult, condition_estimate, lanczos_eigs
from .fsai import fsai_preconditioner
from .fused import (
    FusedCGState,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    fused_cg_init,
    fused_cg_step,
    fused_supported,
)
from .fused_bicgstab import fused_bicgstab_solve, fused_bicgstab_supported
from .fused_minres import fused_minres_solve, fused_minres_supported
from .fused_stencil import fused_stencil_cg_solve, fused_stencil_supported
from .gmres import GmresInfo, gmres_solve
from .lobpcg import lobpcg_eigs
from .minres import MinresInfo, minres_solve
from .multigrid import multigrid_preconditioner
from .pipelined import pipelined_cg_solve
from .refine import RefineInfo, refined_cg_solve
from .precond import (
    block_jacobi_preconditioner,
    chebyshev_preconditioner,
    estimate_spectral_bounds,
    identity_preconditioner,
    jacobi_preconditioner,
)
from .sstep import make_sstep_loop, sstep_cg_solve

__all__ = [
    "BatchedCGState",
    "BicgstabInfo",
    "BlockCGState",
    "CGInfo",
    "CGState",
    "DeflationBasis",
    "EigsResult",
    "FusedCGState",
    "GmresInfo",
    "MinresInfo",
    "RefineInfo",
    "accuracy",
    "batched_cg_init",
    "basis_quality",
    "batched_state_result",
    "bicgstab_solve",
    "bicgstab_solve_batched",
    "block_cg_solve",
    "block_jacobi_preconditioner",
    "cg_init",
    "cg_solve",
    "cg_solve_batched",
    "cg_step",
    "chebyshev_preconditioner",
    "condition_estimate",
    "deflated_cg_solve",
    "deflation_basis_from_vectors",
    "estimate_spectral_bounds",
    "expected_step_count",
    "fsai_preconditioner",
    "fused_bell_cg_solve",
    "fused_bell_pcg_solve",
    "fused_bicgstab_solve",
    "fused_bicgstab_supported",
    "fused_cg_init",
    "fused_cg_step",
    "fused_minres_solve",
    "fused_minres_supported",
    "fused_stencil_cg_solve",
    "fused_stencil_supported",
    "fused_supported",
    "gmres_solve",
    "gmres_solve_batched",
    "harvest_deflation_basis",
    "identity_preconditioner",
    "implicit_cg_solve",
    "implicit_gmres_solve",
    "jacobi_preconditioner",
    "lanczos_eigs",
    "load_state",
    "lobpcg_eigs",
    "make_deflation_basis",
    "memory_footprint",
    "minres_solve",
    "minres_solve_batched",
    "multigrid_preconditioner",
    "pipelined_cg_solve",
    "refined_cg_solve",
    "rigid_body_modes",
    "run_batched_cg",
    "run_cg",
    "save_state",
    "smoothed_aggregation_preconditioner",
    "sstep_cg_solve",
]
