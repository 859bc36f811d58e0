"""Fused-kernel CG driver for blocked-ELL operators, full or symmetric
storage (the GPU fast path).  Counterpart of
``conjugategradient_tpu/solver/fused.py``: the same algorithm and semantics
as solver/cg.py, residual replacement included, with the iteration body as
two kernels (ops/cuda/fused_cg.py):

    K1  p = z + β·p;  q = A·p;  pap = p·q      (z = d⊙r for Jacobi, else r)
    K2  x += α·p;  r −= α·q;  rnorm = r·r      (PCG: also ρ = Σ d·r²)

The direction update of the reference's iteration end (CG.hpp:418) is
hoisted into the next K1.  α, β, ρ, k, done and the history stay on the
device: the kernels' final reductions do the scalar step (FusedWork), every
kernel is a no-op once the solve is done, and the host reads the done flag
only every ``CHECK_EVERY`` steps (solver/restart.py).  x and r are updated in
place; p lives in two buffers that swap each step (K1 reads p_old rows
while other CTAs write p_new).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from ..ops.cuda.fused_cg import (
    C_DONE,
    C_K,
    C_LIVE,
    CUDA_BN,
    S_BETA,
    S_RHO,
    S_RNORM,
    FusedWork,
    fused_dir_spmv_dot,
    fused_dir_spmv_dot_packed,
    fused_update_dot,
    fused_update_dot_pcg,
    sym_fused_dir_spmv_dot,
)
from ..ops.spmv import bell_packed_route, full_precision_matmul
from ..types import BlockedEllMatrix, SymBellMatrix
from .cg import CGInfo
from .restart import run_chunked

BellOperator = Union[BlockedEllMatrix, SymBellMatrix]


@dataclasses.dataclass
class FusedCGState:
    """Carry of the fused loop.  Vectors are float32, (nrb, bn) blocks for
    blocked-ELL or (nx, ny, nz) volumes for the stencil
    (solver/fused_stencil.py); ``p`` is the PREVIOUS direction (β folds
    into the next K1); ``d`` is the Jacobi inverse diagonal (1 on padding
    rows) or None for plain CG."""

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
    """Whether the fused path can run this operator: blocked-ELL in full or
    symmetric storage, square tiles of a width the kernels take, a square
    padded system, float32 tiles and vectors, tensors on a CUDA device.

    The TPU gates on Mosaic block shapes, VMEM residency and ``ku <= 64``
    are dropped: the CUDA kernels mask ragged strips themselves, stream the
    vectors from L2/HBM, and loop over the tile slots at run time (the
    TPU's limit kept an unrolled loop compilable).
    """
    if not isinstance(a, (BlockedEllMatrix, SymBellMatrix)):
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
    a: BellOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    maxiter: int = 0,
    *,
    tol: float = 0.0,
    inv_diag: Optional[torch.Tensor] = None,
) -> FusedCGState:
    """r₀ = b − A·x₀ (no SpMV when x₀ is the default zero; on full storage
    on a CUDA device the SpMV is the blocked-ELL kernel); p enters the loop
    through K1 with β = 0, so p₁ = z₀.  With ``inv_diag`` the state is
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


def fused_cg_step(a: BellOperator, state: FusedCGState,
                  mirror: str = "auto") -> FusedCGState:
    """One CG (or Jacobi-PCG) iteration in two fused kernels, updating
    ``state`` in place.  Full storage reads its packed nonzeros where
    ``ops/spmv.bell_packed_route`` says so (sparse tiles), else the tile
    stream.  On symmetric storage ``mirror="auto"`` picks the Bᵀ landing
    from the pattern (:func:`_auto_mirror`); full storage has no mirror and
    ignores it."""
    w = state.work
    if isinstance(a, BlockedEllMatrix):
        if bell_packed_route(a):
            p_new, q, _ = fused_dir_spmv_dot_packed(
                a.packed(), state.r, state.p, w.beta, state.d,
                out=(state.p_next, state.q), work=w,
            )
        else:
            p_new, q, _ = fused_dir_spmv_dot(
                a.blocks, a.block_cols, state.r, state.p, w.beta, state.d,
                out=(state.p_next, state.q), work=w,
            )
        return _update(state, p_new, q)
    if mirror == "auto":
        mirror = _auto_mirror(a)
    elif mirror == "banded" and not a.banded:
        # the banded landing would put every mirror at row+1; ku == 1
        # alone does not guarantee that pattern — only the static flag
        raise ValueError(
            "mirror='banded' requires a block-tridiagonal operator "
            "(SymBellMatrix.banded); this pattern has off-band tiles"
        )
    p_new, q, _ = sym_fused_dir_spmv_dot(
        a.diag_blocks, a.off_blocks, a.off_cols, state.r, state.p,
        w.beta, state.d, mirror=mirror, mirror_src=a.mirror_src,
        out=(state.p_next, state.q), work=w,
    )
    return _update(state, p_new, q)


def _update(state: FusedCGState, p_new, q) -> FusedCGState:
    """K2 of the step, then the p buffers swap."""
    w = state.work
    if state.d is None:
        fused_update_dot(state.x, p_new, state.r, q, w.alpha,
                         out=(state.x, state.r), work=w)
    else:
        fused_update_dot_pcg(state.x, p_new, state.r, q, state.d, w.alpha,
                             out=(state.x, state.r), work=w)
    state.p, state.p_next = p_new, state.p
    return state


def fused_replace(a: BellOperator, state: FusedCGState, bp: torch.Tensor,
                  every: int) -> None:
    """The restart step on the fused state (JAX ``solver/fused.py`` and
    ``solver/fused_stencil.py`` ``replace``), in place: r ← b − A·x, β ← 0
    (so the next K1 emits p = z), ρ and ‖r‖² from the true residual (PCG:
    ρ = Σ d·r²) and ``hist[k]`` ← the true ‖r‖².  Masked on the device to
    iterations k that are multiples of ``every`` of a solve that is not
    done; ``bp`` is b padded to the operator's width, as float32.  The
    state's vectors may be (nrb, bn) blocks or (nx, ny, nz) volumes."""
    w = state.work
    k = w.ctl[C_K]
    mask = (w.ctl[C_DONE] == 0) & (k % every == 0)
    n = a.shape[0]
    ax = a.matvec(state.x.reshape(-1)).to(torch.float32)
    r_true = (bp - torch.nn.functional.pad(ax, (0, bp.numel() - n))).reshape(state.r.shape)
    r2 = r_true * r_true
    rnorm = torch.sum(r2)
    rho = rnorm if state.d is None else torch.sum(r2 * state.d)
    state.r.copy_(torch.where(mask, r_true, state.r))
    scal = w.scal
    scal[S_BETA] = torch.where(mask, 0.0, scal[S_BETA])
    scal[S_RHO] = torch.where(mask, rho, scal[S_RHO])
    scal[S_RNORM] = torch.where(mask, rnorm, scal[S_RNORM])
    kk = k.long().reshape(1)
    w.hist.index_put_((kk,), torch.where(mask, rnorm, w.hist.gather(0, kk)[0]).reshape(1))


def _solve(a, b, inv_diag, x0, tol, maxiter,
           recompute_r_every) -> Tuple[torch.Tensor, CGInfo]:
    full_precision_matmul()
    maxiter = a.shape[0] + 1 if maxiter is None else int(maxiter)
    state = fused_cg_init(a, b, x0, maxiter, tol=tol, inv_diag=inv_diag)
    return run_fused(a, b, state, lambda: fused_cg_step(a, state), maxiter,
                     int(recompute_r_every))


def run_fused(a, b: torch.Tensor, state: FusedCGState, step, maxiter: int,
              every: int) -> Tuple[torch.Tensor, CGInfo]:
    """Drive a fused solve from ``state`` (``step()`` advances it in place),
    with a :func:`fused_replace` restart every ``every`` iterations, and
    return (x, info) in b's dtype."""
    n = a.shape[0]
    bp = torch.nn.functional.pad(b.to(torch.float32), (0, state.r.numel() - n))

    def replace():
        fused_replace(a, state, bp, every)

    run_chunked(step, lambda: state.live, maxiter, every, replace)
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
    a: BellOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    recompute_r_every: int = 0,
) -> Tuple[torch.Tensor, CGInfo]:
    """Whole fused CG solve.  On CUDA tensors each step launches the
    kernels; on CPU tensors it runs their plain versions (the parity path
    the tests hold against the JAX package).  ``recompute_r_every`` > 0
    adds a restart step (:func:`fused_replace`) every that many iterations,
    outside the two-kernel body."""
    return _solve(a, b, None, x0, tol, maxiter, recompute_r_every)


def fused_bell_pcg_solve(
    a: BellOperator,
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
