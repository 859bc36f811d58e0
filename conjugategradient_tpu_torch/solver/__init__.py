from .cg import CGInfo, CGState, accuracy, cg_init, cg_solve, cg_step, expected_step_count
from .fused import (
    FusedCGState,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    fused_cg_init,
    fused_cg_step,
    fused_supported,
)
from .fused_minres import fused_minres_solve, fused_minres_supported
from .fused_stencil import fused_stencil_cg_solve, fused_stencil_supported
from .minres import MinresInfo, minres_solve
from .multigrid import multigrid_preconditioner
from .precond import jacobi_preconditioner

__all__ = [
    "CGInfo",
    "CGState",
    "FusedCGState",
    "MinresInfo",
    "accuracy",
    "cg_init",
    "cg_solve",
    "cg_step",
    "expected_step_count",
    "fused_bell_cg_solve",
    "fused_bell_pcg_solve",
    "fused_cg_init",
    "fused_cg_step",
    "fused_minres_solve",
    "fused_minres_supported",
    "fused_stencil_cg_solve",
    "fused_stencil_supported",
    "fused_supported",
    "jacobi_preconditioner",
    "minres_solve",
    "multigrid_preconditioner",
]
