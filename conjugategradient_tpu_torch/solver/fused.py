"""Fused-kernel CG driver for symmetric blocked-ELL operators (the GPU fast
path).  Counterpart of ``conjugategradient_tpu/solver/fused.py``: the same
algorithm and semantics as solver/cg.py, with the iteration body as two
kernels (ops/cuda/fused_cg.py):

    K1  p = z + β·p;  q = A·p;  pap = p·q      (z = d⊙r for Jacobi, else r)
    K2  x += α·p;  r −= α·q;  rnorm = r·r      (PCG: also ρ = Σ d·r²)

The direction update of the reference's iteration end (CG.hpp:418) is
hoisted into the next K1.  α, β, ρ, k, done and the history stay on the
device: the kernels' final reductions do the scalar step (FusedWork), every
kernel is a no-op once the solve is done, and the host reads the done flag
only every ``CHECK_EVERY`` steps (solver/cg.py).  x and r are updated in
place; p lives in two buffers that swap each step (K1 reads p_old rows
while other CTAs write p_new).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..ops.cuda.fused_cg import (
    C_DONE,
    C_K,
    C_LIVE,
    CUDA_BN,
    S_RHO,
    S_RNORM,
    FusedWork,
    fused_update_dot,
    fused_update_dot_pcg,
    sym_fused_dir_spmv_dot,
)
from ..ops.spmv import full_precision_matmul
from ..types import SymBellMatrix
from .cg import CGInfo, run_chunked


@dataclasses.dataclass
class FusedCGState:
    """Carry of the fused loop.  Vectors are (nrb, bn) float32; ``p`` is the
    PREVIOUS direction (β folds into the next K1); ``d`` is the Jacobi
    inverse diagonal (1 on padding rows) or None for plain CG."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    work: FusedWork
    d: Optional[torch.Tensor] = None
    p_next: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.p_next is None:
            self.p_next = torch.empty_like(self.p)
        if self.q is None:
            self.q = torch.empty_like(self.r)

    @property
    def k(self) -> torch.Tensor:
        return self.work.ctl[C_K]

    @property
    def done(self) -> torch.Tensor:
        return self.work.ctl[C_DONE].bool()

    @property
    def beta(self) -> torch.Tensor:
        return self.work.beta

    @property
    def rho(self) -> torch.Tensor:
        return self.work.scalar(S_RHO)

    @property
    def rnorm(self) -> torch.Tensor:
        return self.work.scalar(S_RNORM)

    @property
    def hist(self) -> torch.Tensor:
        return self.work.hist

    @property
    def live(self) -> torch.Tensor:
        return self.work.ctl[C_LIVE]


def fused_supported(a: Any, dtype=None) -> bool:
    """Whether the fused path can run this operator: symmetric blocked-ELL,
    square tiles of a width the kernels take, a square padded system, float32
    tiles and vectors, tensors on a CUDA device.

    The TPU gates on Mosaic block shapes, VMEM residency and ``ku <= 64``
    are dropped: the CUDA kernels mask ragged strips themselves, stream the
    vectors from L2/HBM, and loop over the ku tile slots at run time (the
    TPU's limit kept an unrolled loop compilable).
    """
    if not isinstance(a, SymBellMatrix):
        return False
    np_, mp = a.padded_shape
    return (
        a.bm == a.bn
        and a.bn in CUDA_BN
        and np_ == mp
        and a.dtype == torch.float32
        and (dtype is None or dtype == torch.float32)
        and a.device.type == "cuda"
    )


def _auto_mirror(a: SymBellMatrix) -> str:
    """Bᵀ landing for a pattern: the halo carry for block-tridiagonal
    storage, the fixed-order per-slot landing otherwise."""
    return "banded" if a.banded and a.ku == 1 else "scatter"


def fused_cg_init(
    a: SymBellMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    maxiter: int = 0,
    *,
    tol: float = 0.0,
    inv_diag: Optional[torch.Tensor] = None,
) -> FusedCGState:
    """r₀ = b − A·x₀ (no SpMV when x₀ is the default zero); p enters the
    loop through K1 with β = 0, so p₁ = z₀.  With ``inv_diag`` the state is
    Jacobi PCG: ρ₀ = r₀·(d⊙r₀), history on ‖r‖²."""
    _, mp = a.padded_shape
    bn = a.bn
    n = b.shape[0]
    dev = a.device
    bp = torch.zeros(mp, dtype=torch.float32, device=dev)
    bp[:n] = b.to(torch.float32)
    x = torch.zeros(mp, dtype=torch.float32, device=dev)
    if x0 is None:
        r = bp
    else:
        x[:n] = x0.to(torch.float32)
        ax = a.matvec(x).to(torch.float32)
        r = bp - torch.nn.functional.pad(ax, (0, mp - n))
    x2d, r2d = x.reshape(mp // bn, bn), r.reshape(mp // bn, bn)
    rnorm0 = torch.sum(r2d * r2d)
    d2d = None
    rho0 = rnorm0
    if inv_diag is not None:
        d = torch.ones(mp, dtype=torch.float32, device=dev)
        d[:n] = inv_diag.to(torch.float32)  # padding rows: d = 1 (r is 0 there)
        d2d = d.reshape(mp // bn, bn)
        rho0 = torch.sum(r2d * r2d * d2d)
    work = FusedWork.new(dev, maxiter=maxiter, tol=tol)
    work.scal[S_RHO] = rho0
    work.scal[S_RNORM] = rnorm0
    work.hist[0] = rnorm0
    return FusedCGState(x=x2d, r=r2d, p=torch.zeros_like(r2d), work=work, d=d2d)


def fused_cg_step(a: SymBellMatrix, state: FusedCGState,
                  mirror: str = "auto") -> FusedCGState:
    """One CG (or Jacobi-PCG) iteration in two fused kernels, updating
    ``state`` in place.  ``mirror="auto"`` picks the Bᵀ landing from the
    pattern (:func:`_auto_mirror`)."""
    if mirror == "auto":
        mirror = _auto_mirror(a)
    elif mirror == "banded" and not a.banded:
        # the banded landing would put every mirror at row+1; ku == 1
        # alone does not guarantee that pattern — only the static flag
        raise ValueError(
            "mirror='banded' requires a block-tridiagonal operator "
            "(SymBellMatrix.banded); this pattern has off-band tiles"
        )
    w = state.work
    p_new, q, _ = sym_fused_dir_spmv_dot(
        a.diag_blocks, a.off_blocks, a.off_cols, state.r, state.p,
        w.beta, state.d, mirror=mirror, mirror_src=a.mirror_src,
        out=(state.p_next, state.q), work=w,
    )
    if state.d is None:
        fused_update_dot(state.x, p_new, state.r, q, w.alpha,
                         out=(state.x, state.r), work=w)
    else:
        fused_update_dot_pcg(state.x, p_new, state.r, q, state.d, w.alpha,
                             out=(state.x, state.r), work=w)
    state.p, state.p_next = p_new, state.p
    return state


def _solve(a, b, inv_diag, x0, tol, maxiter,
           recompute_r_every) -> Tuple[torch.Tensor, CGInfo]:
    if recompute_r_every:
        raise NotImplementedError(
            "recompute_r_every is not ported yet (ROADMAP: port queue)")
    full_precision_matmul()
    n = a.shape[0]
    maxiter = n + 1 if maxiter is None else int(maxiter)
    state = fused_cg_init(a, b, x0, maxiter, tol=tol, inv_diag=inv_diag)
    run_chunked(lambda: fused_cg_step(a, state), lambda: state.live, maxiter)
    rnorm = state.rnorm[0, 0]
    info = CGInfo(
        iterations=state.k.clone(),
        converged=state.done & ~torch.isnan(rnorm),
        rho=state.rho[0, 0].to(b.dtype),
        rnorm_sq=rnorm.to(b.dtype),
        rho_history=state.hist,
    )
    return state.x.reshape(-1)[:n].to(b.dtype), info


def fused_bell_cg_solve(
    a: SymBellMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    recompute_r_every: int = 0,
) -> Tuple[torch.Tensor, CGInfo]:
    """Whole fused CG solve.  On CUDA tensors each step launches the
    kernels; on CPU tensors it runs their plain versions (the parity path
    the tests hold against the JAX package)."""
    return _solve(a, b, None, x0, tol, maxiter, recompute_r_every)


def fused_bell_pcg_solve(
    a: SymBellMatrix,
    b: torch.Tensor,
    inv_diag: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    recompute_r_every: int = 0,
) -> Tuple[torch.Tensor, CGInfo]:
    """Jacobi PCG with the fused two-kernel iteration: the M⁻¹ multiply
    happens inside K1's direction update and K2's ρ reduction."""
    return _solve(a, b, inv_diag, x0, tol, maxiter, recompute_r_every)
