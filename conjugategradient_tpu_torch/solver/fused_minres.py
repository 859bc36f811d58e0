"""Fused-kernel MINRES solver for blocked-ELL operators, full or symmetric
storage (the GPU fast path).  Counterpart of
``conjugategradient_tpu/solver/fused_minres.py``: the algorithm and
semantics of solver/minres.py (Paige–Saunders Lanczos + Givens recurrence,
absolute-φ̄ termination, NaN and β = 0 exits), with the iteration body as
two kernels (ops/cuda/fused_minres.py; K1 reads the operator's packed
nonzeros where its tiles are sparse, ``ops/spmv.bell_packed_route``):

    K1  [apply the PREVIOUS iteration's solution update]
        v = (d⊙r2)/β;  q = (A − σI)·v;  vq = v·q;  vr1 = v·r1
    K2  r2' = q − c1·r1 − (α/β)·r2;  β'² = r2'·(d⊙r2')

The solution update (w_k, x_k) of iteration k needs Givens scalars that
depend on β_{k+1}, so it is hoisted into iteration k+1's tile pass and the
last one is flushed once after the loop.  The scalar recurrence between and
after the kernels runs in their last CTAs (MinresWork), so no scalar leaves
the device, every kernel is a no-op once the solve is done, and the host
reads the done flag only every ``CHECK_EVERY`` steps (solver/restart.py).

The vectors are updated in place: v over v_prev, x over x, w_new over
w₋₂'s buffer and r2' over r1's, after which the two w buffers and the two
r buffers trade names.  Float32 vectors on float32 or bfloat16 tiles, like
the fused CG path: a bfloat16 operator runs the bf16 forms of kernel 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..ops.cuda.fused_minres import (
    C_DONE,
    C_K,
    C_LIVE,
    C_NAN,
    M_PHIBAR,
    SU_DELTA,
    SU_IGAMMA,
    SU_OLDEPS,
    SU_PHI,
    MinresWork,
    minres_dir_spmv_dot,
    minres_dir_spmv_dot_packed,
    minres_update_dot,
    sym_minres_dir_spmv_dot,
)
from ..ops.spmv import bell_packed_route, full_precision_matmul
from ..types import BlockedEllMatrix, SymBellMatrix
from .fused import BellOperator, _auto_mirror, fused_supported
from .minres import MinresInfo
from .restart import run_chunked


@dataclasses.dataclass
class FusedMinresState:
    """Carry of the fused MINRES loop: vectors as (nrb, bn) float32 blocks,
    every scalar in ``work``.  ``vprev``/``wm1``/``wm2`` and the pending
    scalars of ``work.su`` hold the solution update hoisted into the next
    K1; ``x`` is one update behind.  ``d``: the Jacobi inverse diagonal (1
    on padding rows) or None.

    ``launched`` is k plus the steps launched past the end: every launched
    step trades the names of the w and the r buffers, whether or not the
    solve was still live, and :func:`settle` undoes the trades of the dead
    ones."""

    x: torch.Tensor
    r1: torch.Tensor  # Lanczos v_{k-1} scaled (un-normalized)
    r2: torch.Tensor  # Lanczos v_k scaled
    vprev: torch.Tensor  # v_k (normalized), operand of the pending update
    wm1: torch.Tensor  # w_{k-1}
    wm2: torch.Tensor  # w_{k-2}
    work: MinresWork
    d: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    launched: int = 0

    def __post_init__(self):
        if self.q is None:
            self.q = torch.empty_like(self.r2)

    @property
    def k(self) -> torch.Tensor:
        return self.work.ctl[C_K]

    @property
    def done(self) -> torch.Tensor:
        return self.work.ctl[C_DONE].bool()

    @property
    def nan(self) -> torch.Tensor:
        return self.work.ctl[C_NAN].bool()

    @property
    def live(self) -> torch.Tensor:
        return self.work.ctl[C_LIVE]

    @property
    def phibar(self) -> torch.Tensor:
        return self.work.scal[M_PHIBAR]

    @property
    def hist(self) -> torch.Tensor:
        return self.work.hist


def fused_minres_supported(a: Any, dtype=None) -> bool:
    """Whether the fused MINRES path can run this operator: the fused CG
    gate (:func:`~.fused.fused_supported`: blocked-ELL in full or symmetric
    storage, square tiles of a width the kernels take, a square padded
    system, float32 or bfloat16 tiles with float32 vectors, tensors on a
    CUDA device), as the JAX gate is.  A bfloat16 operator runs the bf16
    forms of kernels 14 and 15 (dense or packed, by
    ``ops/spmv.bell_packed_route``); kernel 16 reads vectors only.  The JAX
    package's extra bound on the vectors' VMEM residency is dropped: the
    CUDA kernels stream the vectors from L2/HBM."""
    return fused_supported(a, dtype=dtype)


def fused_minres_init(
    a: BellOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    maxiter: int = 0,
    *,
    tol: float = 0.0,
    shift: float = 0.0,
    inv_diag: Optional[torch.Tensor] = None,
) -> FusedMinresState:
    """r₁ = b − (A − σI)x₀ (no SpMV when x₀ is the default zero), β₁ =
    √(r₁·(d⊙r₁)); done at once when β₁ is NaN or within ``tol``."""
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
        r = bp - torch.nn.functional.pad(ax, (0, mp - n)) + shift * x
    shape = (mp // bn, bn)
    r2 = r.reshape(shape)
    d2d = None
    y0 = r2
    if inv_diag is not None:
        d = torch.ones(mp, dtype=torch.float32, device=dev)
        d[:n] = inv_diag.to(torch.float32)  # padding rows: d = 1 (r is 0 there)
        d2d = d.reshape(shape)
        y0 = d2d * r2
    work = MinresWork.new(dev, maxiter=maxiter, tol=tol, shift=shift)
    work.start(torch.sqrt(torch.sum(r2 * y0)))
    return FusedMinresState(
        x=x.reshape(shape), r1=r2.clone(), r2=r2,
        vprev=torch.zeros_like(r2), wm1=torch.zeros_like(r2), wm2=torch.zeros_like(r2),
        work=work, d=d2d)


def fused_minres_step(a: BellOperator, s: FusedMinresState,
                      mirror: str = "auto") -> FusedMinresState:
    """One MINRES iteration in two fused kernels, updating ``s`` in place;
    the same recurrence and exits as solver/minres.minres_step, with x one
    update behind.  Either storage reads its packed nonzeros where
    ``ops/spmv.bell_packed_route`` says so (sparse tiles), else the tile
    stream.  On symmetric storage's tiles ``mirror="auto"`` picks the Bᵀ
    landing from the pattern; full storage and the packed view have no
    mirror and ignore it."""
    w = s.work
    out = (s.vprev, s.q, s.wm2, s.x)
    vecs = (s.r2, s.r1, s.vprev, s.wm1, s.wm2, s.x, w.su, s.d)
    if isinstance(a, SymBellMatrix) and mirror == "banded" and not a.banded:
        raise ValueError(
            "mirror='banded' requires a block-tridiagonal operator "
            "(SymBellMatrix.banded); this pattern has off-band tiles")
    if bell_packed_route(a):
        minres_dir_spmv_dot_packed(a.packed(), *vecs, out=out, work=w)
    elif isinstance(a, BlockedEllMatrix):
        minres_dir_spmv_dot(a.blocks, a.block_cols, *vecs, out=out, work=w)
    else:
        sym_minres_dir_spmv_dot(a.diag_blocks, a.off_blocks, a.off_cols, *vecs,
                                mirror=_auto_mirror(a) if mirror == "auto" else mirror,
                                mirror_src=a.mirror_src, out=out, work=w)
    minres_update_dot(s.q, s.r1, s.r2, w.c1, w.ia, s.d, out=s.r1, work=w)
    s.r1, s.r2 = s.r2, s.r1
    s.wm1, s.wm2 = s.wm2, s.wm1
    s.launched += 1
    return s


def settle(s: FusedMinresState) -> FusedMinresState:
    """Give the w and r buffers their right names after steps were launched
    past the end: such a step changes nothing on the device, but it trades
    the names all the same.  One host read of k."""
    dead = s.launched - int(s.k)
    if dead % 2:
        s.r1, s.r2 = s.r2, s.r1
        s.wm1, s.wm2 = s.wm2, s.wm1
    s.launched -= dead
    return s


def flushed_x(s: FusedMinresState) -> torch.Tensor:
    """x with the pending solution update of the last iteration applied (a
    no-op when no iteration ran: 1/γ̄ = φ̄ = 0)."""
    su = s.work.scal
    w_fin = (s.vprev - su[SU_OLDEPS] * s.wm2 - su[SU_DELTA] * s.wm1) * su[SU_IGAMMA]
    return s.x + su[SU_PHI] * w_fin


def fused_minres_solve(
    A: BellOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    shift: float = 0.0,
    inv_diag: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, MinresInfo]:
    """Whole fused MINRES solve.  On CUDA tensors each step launches the
    kernels; on CPU tensors it runs their plain versions (the parity path
    the tests hold against the JAX package).

    ``inv_diag``: a POSITIVE diagonal Jacobi preconditioner, folded into
    both kernels; other preconditioners run the portable loop
    (:func:`~.minres.minres_solve` dispatches).
    """
    if not isinstance(A, (BlockedEllMatrix, SymBellMatrix)):
        raise TypeError(
            "fused_minres_solve needs a blocked-ELL operator "
            f"(got {type(A).__name__}); minres_solve dispatches here")
    full_precision_matmul()
    n = A.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    s = fused_minres_init(A, b, x0, maxiter, tol=tol, shift=shift, inv_diag=inv_diag)
    run_chunked(lambda: fused_minres_step(A, s), lambda: s.live, maxiter)
    settle(s)
    x = flushed_x(s).reshape(-1)[:n]
    # the true ‖b − (A − σI)x‖₂, from one extra SpMV as in the portable loop
    r_true = b.to(torch.float32) - A.matvec(x).to(torch.float32) + shift * x
    info = MinresInfo(
        iterations=s.k.clone(),
        converged=s.done & ~s.nan,
        rnorm=s.phibar.clone(),
        rnorm_history=s.hist,
        rnorm_true=torch.sqrt(torch.sum(r_true * r_true)),
    )
    return x.to(b.dtype), info
