"""Fused-kernel BiCGStab solver for full blocked-ELL operators (the GPU
path for NONSYMMETRIC systems).  Counterpart of
``conjugategradient_tpu/solver/fused_bicgstab.py``: the algorithm of
solver/bicgstab.py (both half-steps per body, the half-step exit, the ρ /
ω / NaN breakdown exits returning the last finite iterate), with the
iteration body as three kernels (ops/cuda/fused_bicgstab.py; K1 and K2 in
their packed forms where the tiles are sparse, ``ops/spmv.bell_packed_route``):

    K1  p' = r + β(p − ω v);  p̂ = d⊙p' or p';  v' = A p̂;  rv = r̂₀·v'
    K2  s = r − α v';  ŝ = d⊙s or s;  x_h = x + α p̂;  t = A ŝ;  ss/ts/tt
    K3  x' = x_h + ω ŝ;  r' = s − ω t;  rn = r'·r';  ρ' = r̂₀·r'

ρ of the next iteration (r̂₀·r') is prefetched in K3's pass.  The breakdown
semantics are the JAX fused loop's, not the portable loop's: a non-finite
α or ω is clamped to 0 before its kernel (its update becomes an exact
no-op), ω is 0 on the half-step exit (K3 then returns x_h and s),
``done`` and the breakdown flag are sticky, ``hist[k]`` gets the new ‖r‖
even on a breakdown, and ONE select after the loop restores the last
finite iterate: a solve that ended in a breakdown after k > 0 steps
returns the previous x, its ‖r‖, and that ‖r‖ at hist[k].

The scalar steps run in the kernels' last CTAs (BicgstabWork), so no
scalar leaves the device, every kernel is a no-op once the solve is done,
and the host reads ``live`` only every ``CHECK_EVERY`` steps
(solver/restart.py).  p and v are double-buffered (K1 gathers them while
it writes the new ones), and so is x: K2 writes x_h into the other buffer,
which keeps the previous x for the select.  Float32 vectors on float32 or
bfloat16 tiles (the kernels' bf16 forms), and full storage only, like the
JAX path: the domain is nonsymmetric.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..ops.cuda.fused_bicgstab import (
    B_RNORM,
    B_RNORM_PREV,
    C_BROKE,
    C_DONE,
    C_K,
    C_LIVE,
    BicgstabWork,
    bicgstab_dir_spmv_dot,
    bicgstab_dir_spmv_dot_packed,
    bicgstab_s_spmv_dot,
    bicgstab_s_spmv_dot_packed,
    bicgstab_update_dot,
)
from ..ops.spmv import bell_packed_route, full_precision_matmul
from ..types import BlockedEllMatrix
from .bicgstab import BicgstabInfo
from .fused import fused_supported
from .restart import run_chunked


@dataclasses.dataclass
class FusedBicgstabState:
    """Carry of the fused BiCGStab loop: vectors as (nrb, bn) float32
    blocks, every scalar in ``work``.  ``x``/``xprev``, ``p``/``p_next`` and
    ``v``/``v_next`` are buffer pairs whose names trade after each launched
    step; ``xprev`` is the x before the last step.  ``d``: the Jacobi
    inverse diagonal (1 on padding rows) or None.

    ``launched`` is k plus the steps launched past the end: every launched
    step trades the names, whether or not the solve was still live, and
    :func:`settle` undoes the trades of the dead ones."""

    x: torch.Tensor
    xprev: torch.Tensor
    r: torch.Tensor
    rhat: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    work: BicgstabWork
    d: Optional[torch.Tensor] = None
    launched: int = 0
    # scratch of one step: the other p and v buffers, p̂, s, ŝ, t
    p_next: torch.Tensor = dataclasses.field(default=None, repr=False)
    v_next: torch.Tensor = dataclasses.field(default=None, repr=False)
    phat: torch.Tensor = dataclasses.field(default=None, repr=False)
    s: torch.Tensor = dataclasses.field(default=None, repr=False)
    shat: torch.Tensor = dataclasses.field(default=None, repr=False)
    t: torch.Tensor = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        for name in ("p_next", "v_next", "phat", "s", "shat", "t"):
            if getattr(self, name) is None:
                setattr(self, name, torch.empty_like(self.r))

    @property
    def k(self) -> torch.Tensor:
        return self.work.ctl[C_K]

    @property
    def done(self) -> torch.Tensor:
        return self.work.ctl[C_DONE].bool()

    @property
    def broke(self) -> torch.Tensor:
        return self.work.ctl[C_BROKE].bool()

    @property
    def live(self) -> torch.Tensor:
        return self.work.ctl[C_LIVE]

    @property
    def rnorm(self) -> torch.Tensor:
        return self.work.scal[B_RNORM]

    @property
    def rnorm_prev(self) -> torch.Tensor:
        return self.work.scal[B_RNORM_PREV]

    @property
    def hist(self) -> torch.Tensor:
        return self.work.hist


def fused_bicgstab_supported(a: Any, dtype=None) -> bool:
    """Whether the fused BiCGStab path can run this operator: the JAX gate,
    the fused CG gate (:func:`~.fused.fused_supported`: square tiles of a
    width the kernels take, float32 or bfloat16, a square padded system,
    tensors on a CUDA device) on FULL blocked-ELL storage.  The JAX
    package's bound on the vectors' VMEM residency is dropped: the CUDA
    kernels stream the vectors from L2/HBM."""
    return isinstance(a, BlockedEllMatrix) and fused_supported(a, dtype=dtype)


def fused_bicgstab_init(
    a: BlockedEllMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    maxiter: int = 0,
    *,
    tol: float = 0.0,
    inv_diag: Optional[torch.Tensor] = None,
) -> FusedBicgstabState:
    """r₀ = b − A x₀ (no SpMV when x₀ is the default zero), r̂₀ = r₀; done
    at once when ‖r₀‖ is NaN or within ``tol``."""
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
    shape = (mp // bn, bn)
    r2d = r.reshape(shape)
    d2d = None
    if inv_diag is not None:
        d = torch.ones(mp, dtype=torch.float32, device=dev)
        d[:n] = inv_diag.to(torch.float32)  # padding rows: d = 1 (r is 0 there)
        d2d = d.reshape(shape)
    work = BicgstabWork.new(dev, maxiter=maxiter, tol=tol)
    work.start(torch.sum(r2d * r2d))
    return FusedBicgstabState(
        x=x.reshape(shape), xprev=torch.empty_like(r2d), r=r2d, rhat=r2d.clone(),
        p=torch.zeros_like(r2d), v=torch.zeros_like(r2d), work=work, d=d2d)


def fused_bicgstab_step(a: BlockedEllMatrix, s: FusedBicgstabState) -> FusedBicgstabState:
    """One full BiCGStab iteration in three fused kernels, updating ``s``
    in place; the same semantics as solver/bicgstab.bicgstab_step, with the
    breakdown select moved after the loop (module doc).  The two products
    read the operator's packed nonzeros where ``ops/spmv.bell_packed_route``
    says so (sparse tiles), else the tile stream."""
    w = s.work
    if bell_packed_route(a):
        pk = a.packed()
        bicgstab_dir_spmv_dot_packed(pk, s.r, s.p, s.v, s.rhat, w.beta_c, w.omega, s.d,
                                     out=(s.p_next, s.phat, s.v_next), work=w)
        bicgstab_s_spmv_dot_packed(pk, s.r, s.v_next, s.x, s.phat, w.alpha_c, s.d,
                                   out=(s.s, s.shat, s.xprev, s.t), work=w)
    else:
        bicgstab_dir_spmv_dot(a.blocks, a.block_cols, s.r, s.p, s.v, s.rhat, w.beta_c,
                              w.omega, s.d, out=(s.p_next, s.phat, s.v_next), work=w)
        bicgstab_s_spmv_dot(a.blocks, a.block_cols, s.r, s.v_next, s.x, s.phat, w.alpha_c,
                            s.d, out=(s.s, s.shat, s.xprev, s.t), work=w)
    bicgstab_update_dot(s.xprev, s.shat, s.s, s.t, s.rhat, w.omega_c, out=(s.xprev, s.r),
                        work=w)
    _trade(s)
    s.launched += 1
    return s


def _trade(s: FusedBicgstabState) -> None:
    s.x, s.xprev = s.xprev, s.x
    s.p, s.p_next = s.p_next, s.p
    s.v, s.v_next = s.v_next, s.v


def settle(s: FusedBicgstabState) -> FusedBicgstabState:
    """Give the buffer pairs their right names after steps were launched
    past the end: such a step changes nothing on the device, but it trades
    the names all the same.  One host read of k."""
    dead = s.launched - int(s.k)
    if dead % 2:
        _trade(s)
    s.launched -= dead
    return s


def fused_bicgstab_solve(
    A: BlockedEllMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, BicgstabInfo]:
    """Whole fused BiCGStab solve.  On CUDA tensors each step launches the
    three kernels; on CPU tensors it runs their plain versions (the parity
    path the tests hold against the JAX package).
    :func:`~.bicgstab.bicgstab_solve` reaches it with ``fused="always"``.

    ``inv_diag``: a Jacobi diagonal folded into both tile passes; general
    preconditioners run the portable loop.
    """
    if not isinstance(A, BlockedEllMatrix):
        raise TypeError(
            "fused_bicgstab_solve needs a full blocked-ELL operator "
            f"(got {type(A).__name__}); bicgstab_solve dispatches here")
    full_precision_matmul()
    n = A.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    s = fused_bicgstab_init(A, b, x0, maxiter, tol=tol, inv_diag=inv_diag)
    run_chunked(lambda: fused_bicgstab_step(A, s), lambda: s.live, maxiter)
    settle(s)
    # the one breakdown select, after the loop: a solve that broke down
    # after k > 0 steps keeps the last finite iterate and its ‖r‖
    k = s.k.long()
    final_broke = s.broke & (k > 0)
    x2d = torch.where(final_broke, s.xprev, s.x)
    rnorm = torch.where(final_broke, s.rnorm_prev, s.rnorm)
    hist = s.hist.index_put(
        (k.reshape(1),), torch.where(final_broke, s.rnorm_prev, s.hist.gather(0, k.reshape(1))[0]
                                     ).reshape(1))
    x = x2d.reshape(-1)[:n]
    r_true = b.to(torch.float32) - A.matvec(x).to(torch.float32)
    info = BicgstabInfo(
        iterations=s.k.clone(),
        converged=s.done & ~s.broke,
        breakdown=s.broke,
        rnorm=rnorm,
        rnorm_history=hist,
        rnorm_true=torch.sqrt(torch.sum(r_true * r_true)),
    )
    return x.to(b.dtype), info
