"""conjugategradient_tpu_torch — the PyTorch / CUDA port of
conjugategradient_tpu for NVIDIA Hopper GPUs.

Blocked-ELL CG and Jacobi PCG, in full or symmetric storage, run as two
hand-written CUDA kernels per iteration (``ops/cuda``, sources in
``csrc/``); the full blocked-ELL SpMV is a third.  CSR and the portable
loop run in plain torch.  Imports torch, never jax.
"""

from .io import load_matrix
from .solver import (
    CGInfo,
    accuracy,
    cg_solve,
    expected_step_count,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    jacobi_preconditioner,
)
from .types import (
    BlockedEllMatrix,
    CSRMatrix,
    DenseOperator,
    LinearOperator,
    SymBellMatrix,
    as_linear_operator,
)

__all__ = [
    "BlockedEllMatrix",
    "CGInfo",
    "CSRMatrix",
    "DenseOperator",
    "LinearOperator",
    "SymBellMatrix",
    "accuracy",
    "as_linear_operator",
    "cg_solve",
    "expected_step_count",
    "fused_bell_cg_solve",
    "fused_bell_pcg_solve",
    "jacobi_preconditioner",
    "load_matrix",
]
