from .cg import CGInfo, CGState, accuracy, cg_init, cg_solve, cg_step, expected_step_count
from .fused import (
    FusedCGState,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    fused_cg_init,
    fused_cg_step,
    fused_supported,
)
from .precond import jacobi_preconditioner

__all__ = [
    "CGInfo",
    "CGState",
    "FusedCGState",
    "accuracy",
    "cg_init",
    "cg_solve",
    "cg_step",
    "expected_step_count",
    "fused_bell_cg_solve",
    "fused_bell_pcg_solve",
    "fused_cg_init",
    "fused_cg_step",
    "fused_supported",
    "jacobi_preconditioner",
]
