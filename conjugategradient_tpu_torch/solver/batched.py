"""Batched multi-RHS CG: solve ``A X = B`` for many right-hand sides at
once.  Counterpart of ``conjugategradient_tpu/solver/batched.py``.

The reference solves one RHS per ``solve()`` call (CG.hpp:255).  Batching
the right-hand sides reads the operator once per iteration for all R of
them.  Two implementations, with the same per-lane semantics:

* blocked-ELL (full or symmetric), SELL, DIA and symmetric DIA operators
  get a lockstep loop over (N, R) column blocks whose matvec is the
  layout's multi-RHS SpMV (``ops/spmv.py``'s ``*_spmv_multi``, plain torch
  as in the JAX package).  Per-lane α, β and termination are masked, so
  each lane's iterations, flag and history are what a solo solve reports.
  A Jacobi preconditioner (one carrying ``inv_diag``) is one (N, R)
  elementwise pass; any other per-vector ``M`` is applied column by
  column, as the JAX package's ``jax.vmap(M)`` is (block-Jacobi: the DIA
  kernel once per column on the card);
* every other operator (CSR, dense, the stencil, callables) runs the solo
  portable solve (``cg_solve(..., fused="never")``) once per lane, with
  the results stacked in the JAX layout.  The JAX package vmaps that solve;
  its masked ``while_loop`` gives each lane its solo result, which is what
  the port computes.

The JAX package's TPU gate (``_dia_multi_collapses``, ``_columns_mapped``:
Mosaic's rules for the windowed DIA kernels at offsets >= 1024) is not
ported: DIA and symmetric DIA always take the lockstep loop, as they do in
the JAX package off a TPU.

The loop: a Python loop of device work, no host read per step; the host
follows the flag "no lane live" through ``solver/restart.py``'s
``run_chunked`` and ``_DonePoll``, so at most ``LOOKAHEAD - 1`` masked
steps follow the last lane's end.  The history is written in place
(``index_put_``) into the carry's own copy, made once per solve or chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.spmv import (bell_spmv_multi, dia_spmv_multi, full_precision_matmul,
                        sell_spmv_multi, sym_bell_spmv_multi, sym_dia_spmv_multi)
from ..types import (BlockedEllMatrix, DIAMatrix, SellMatrix, SymBellMatrix, SymDIAMatrix,
                     as_linear_operator)
from ..utils.tracing import outermost
from .cg import CGInfo, cg_solve
from .restart import run_chunked

#: the operators with a multi-RHS SpMV, which take the lockstep loops
_MULTI = {BlockedEllMatrix: bell_spmv_multi, SymBellMatrix: sym_bell_spmv_multi,
          SellMatrix: sell_spmv_multi, DIAMatrix: dia_spmv_multi,
          SymDIAMatrix: sym_dia_spmv_multi}
_LOCKSTEP_TYPES = tuple(_MULTI)


def _dot_cols(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Per-lane dot over (N, R) columns: a plain axis-0 sum."""
    return torch.sum(U * V, dim=0)


def _columns(fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """A per-vector function applied to each column of an (N, R) block."""
    def apply(X: torch.Tensor) -> torch.Tensor:
        return torch.stack([fn(X[:, j].contiguous()) for j in range(X.shape[1])], dim=1)

    return apply


@dataclasses.dataclass(frozen=True)
class BatchedCGState:
    """The lockstep multi-RHS carry, the JAX package's fields: vectors in
    (N, R) column layout, per-lane scalars (R,), ``hist`` (maxiter+1, R)."""

    k: torch.Tensor  # (R,) int32 per-lane iteration counts
    done: torch.Tensor  # (R,) bool
    X: torch.Tensor  # (N, R)
    r: torch.Tensor  # (N, R)
    p: torch.Tensor  # (N, R)
    rho: torch.Tensor  # (R,)
    rnorm: torch.Tensor  # (R,) ‖r‖²
    hist: torch.Tensor  # (maxiter+1, R)

    @property
    def live(self) -> torch.Tensor:
        """Per lane: not done and below the cap."""
        return (~self.done) & (self.k < self.hist.shape[0] - 1)


def _lockstep_ops(op, M):
    """(matvec_multi, precond, with_m) for the lockstep loops: the
    layout's multi-RHS SpMV; Jacobi (``M.inv_diag``) as one (N, R) pass,
    any other ``M`` column by column."""
    mv = next(fn for layout, fn in _MULTI.items() if isinstance(op, layout))
    inv_diag = getattr(M, "inv_diag", None)
    if inv_diag is not None:
        precond = lambda Rv: inv_diag[:, None] * Rv  # noqa: E731
    elif M is not None:
        precond = _columns(M)
    else:
        precond = lambda Rv: Rv  # noqa: E731
    return (lambda X: mv(op, X)), precond, M is not None


def _lane_index(k: torch.Tensor) -> tuple:
    """(rows, columns) indices of each lane's entry ``hist[k[j], j]``."""
    return k.long(), torch.arange(k.shape[0], device=k.device)


def _lockstep_init(matvec_multi, precond, with_m, Bt, X0t, maxiter) -> BatchedCGState:
    r0 = Bt - matvec_multi(X0t)
    z0 = precond(r0)
    rnorm0 = _dot_cols(r0, r0)
    rho0 = _dot_cols(r0, z0) if with_m else rnorm0
    R = Bt.shape[1]
    hist = torch.full((maxiter + 1, R), float("nan"), dtype=rnorm0.dtype, device=Bt.device)
    hist[0] = rnorm0
    return BatchedCGState(
        k=torch.zeros(R, dtype=torch.int32, device=Bt.device),
        done=torch.zeros(R, dtype=torch.bool, device=Bt.device),
        X=X0t, r=r0, p=z0, rho=rho0, rnorm=rnorm0, hist=hist,
    )


def _lockstep_step(matvec_multi, precond, with_m, s: BatchedCGState, tol: torch.Tensor,
                   maxiter: int) -> BatchedCGState:
    """One lockstep iteration: cg_step's per-lane semantics (recurrence
    residual, pre-update termination on ‖r_k‖², ρ == 0 guard, NaN exit);
    finished lanes' carries are frozen.  Writes ``s.hist`` in place."""
    active = (~s.done) & (s.k < maxiter)
    Q = matvec_multi(s.p)
    pap = _dot_cols(s.p, Q)
    exact = s.rho == 0
    alpha = torch.where(exact, 0, s.rho / torch.where(exact, 1, pap))
    am = torch.where(active, alpha, 0)  # frozen lanes: no-op updates
    X = s.X + am * s.p
    Rv = s.r - am * Q
    done_new = torch.isnan(s.rnorm) | (torch.sqrt(s.rnorm) <= tol)
    Z = precond(Rv)
    rnorm_next = _dot_cols(Rv, Rv)
    rho_next = _dot_cols(Rv, Z) if with_m else rnorm_next
    beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, s.rho))
    P = torch.where(active, Z + beta * s.p, s.p)
    k = torch.where(active, s.k + 1, s.k)
    idx = _lane_index(k)
    s.hist.index_put_(idx, torch.where(active, rnorm_next, s.hist[idx]))
    return BatchedCGState(
        k=k, done=torch.where(active, done_new, s.done), X=X, r=Rv, p=P,
        rho=torch.where(active, rho_next, s.rho),
        rnorm=torch.where(active, rnorm_next, s.rnorm), hist=s.hist,
    )


def _lockstep_replace(matvec_multi, precond, with_m, Bt, s: BatchedCGState,
                      every: int) -> BatchedCGState:
    """Per-lane residual-replacement full restart (solver/cg.py's
    semantics): only lanes that are not done and at a multiple of
    ``every`` restart; frozen lanes keep their state.  No ``k < maxiter``
    term: capping on a boundary still replaces the reported residual."""
    restart = (~s.done) & (s.k % every == 0)
    Rt = Bt - matvec_multi(s.X)
    rnorm_t = _dot_cols(Rt, Rt)
    Zt = precond(Rt)
    rho_t = _dot_cols(Rt, Zt) if with_m else rnorm_t
    idx = _lane_index(s.k)
    s.hist.index_put_(idx, torch.where(restart, rnorm_t, s.hist[idx]))
    return BatchedCGState(
        k=s.k, done=s.done, X=s.X,
        r=torch.where(restart, Rt, s.r), p=torch.where(restart, Zt, s.p),
        rho=torch.where(restart, rho_t, s.rho),
        rnorm=torch.where(restart, rnorm_t, s.rnorm), hist=s.hist,
    )


def _lockstep_info(s: BatchedCGState) -> CGInfo:
    return CGInfo(
        iterations=s.k,
        converged=s.done & ~torch.isnan(s.rnorm),
        rho=s.rho,
        rnorm_sq=s.rnorm,
        rho_history=s.hist.T,  # (R, maxiter+1), the JAX layout
    )


def _drive(ops, state: BatchedCGState, Bt, tol, limit: int, every: int,
           start: int) -> BatchedCGState:
    """Run lockstep steps from ``state``, whose live lanes stand at
    iteration ``start``, until no lane is live or their count reaches
    ``limit``, with the restart every ``every`` steps."""
    matvec_multi, precond, with_m = ops
    maxiter = state.hist.shape[0] - 1
    # the history is written in place: this solve's own copy
    box = [dataclasses.replace(state, hist=state.hist.clone())]

    def step():
        box[0] = _lockstep_step(matvec_multi, precond, with_m, box[0], tol, maxiter)

    def replace():
        box[0] = _lockstep_replace(matvec_multi, precond, with_m, Bt, box[0], every)

    def live():
        return box[0].live.any()

    run_chunked(step, live, limit, every, replace, done=lambda: ~live(), start=start)
    return box[0]


def _check_block(B: torch.Tensor) -> None:
    if B.ndim != 2:
        raise ValueError(f"B must be (nrhs, N), got shape {tuple(B.shape)}")


def _lane_tol(tol, B: torch.Tensor) -> torch.Tensor:
    """``tol`` as a tensor on B's device: a scalar, or (nrhs,) per lane."""
    tol = torch.as_tensor(tol, dtype=B.dtype, device=B.device)
    if tol.ndim == 1 and tol.shape[0] != B.shape[0]:
        raise ValueError(f"per-lane tol has length {tol.shape[0]}, expected {B.shape[0]}")
    if tol.ndim > 1:
        raise ValueError(f"tol must be scalar or (nrhs,), got shape {tuple(tol.shape)}")
    return tol


def _stack_lanes(results) -> tuple:
    """Per-lane solo results ``[(x, info), ...]`` as the batched solvers
    return them: X (nrhs, N) and the Info with a leading nrhs axis."""
    xs, infos = zip(*results)
    cls = type(infos[0])
    return torch.stack(xs), cls(**{f.name: torch.stack([getattr(i, f.name) for i in infos])
                                   for f in dataclasses.fields(cls)})


def batched_cg_init(
    A: Any,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
) -> BatchedCGState:
    """Build the lockstep multi-RHS carry (the checkpoint / resume entry
    point).  ``A`` must have a multi-RHS SpMV (blocked-ELL, symmetric
    blocked-ELL, SELL, DIA, symmetric DIA); ``B`` is (nrhs, N).  Drive it
    with :func:`run_batched_cg`; write it with ``solver.checkpoint.save_state``."""
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=B.dtype, device=B.device)
    if not isinstance(op, _LOCKSTEP_TYPES):
        raise TypeError(
            "batched_cg_init needs a lockstep-capable operator "
            f"(BlockedEll/SymBell/SELL/DIA/SymDIA), got {type(op).__name__}")
    _check_block(B)
    mi = int(op.shape[0] + 1 if maxiter is None else maxiter)
    X0 = torch.zeros_like(B) if X0 is None else X0
    return _lockstep_init(*_lockstep_ops(op, M), B.T, X0.T, mi)


def run_batched_cg(
    A: Any,
    state: BatchedCGState,
    tol,
    steps: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    B: Optional[torch.Tensor] = None,
    recompute_r_every: int = 0,
    n: Optional[int] = None,
) -> BatchedCGState:
    """Advance the lockstep solve by at most ``steps`` iterations (or to
    every lane's end, or the history's capacity); returns the new carry.

    ``M`` must be the preconditioner the state was made with.  ``B`` (the
    (nrhs, N) right-hand sides) is needed only when ``recompute_r_every >
    0``: a restart recomputes the true residual.  Chunks compose bit for
    bit with one uninterrupted solve: the step is the same function and
    the restart boundaries run on from the state's count.  The host reads
    the lanes' largest k once per call.
    """
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=state.X.dtype, device=state.X.device)
    maxiter = state.hist.shape[0] - 1
    every = int(recompute_r_every)
    if every > 0 and B is None:
        raise ValueError("recompute_r_every > 0 needs B (the RHS block)")
    # active lanes advance together, so the largest count is theirs
    start = int(state.k.max())
    limit = maxiter if steps is None else min(maxiter, start + int(steps))
    tol_t = torch.as_tensor(tol, dtype=state.X.dtype, device=state.X.device)
    Bt = None if B is None else B.T
    return _drive(_lockstep_ops(op, M), state, Bt, tol_t, limit, every, start)


def batched_state_result(state: BatchedCGState):
    """(X (nrhs, N), CGInfo) from a carry: what the one-shot solve returns."""
    return state.X.T, _lockstep_info(state)


@outermost("cg.solve")
def cg_solve_batched(
    A: Any,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    tol=0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
    recompute_r_every: int = 0,
) -> Tuple[torch.Tensor, CGInfo]:
    """Solve ``A X[i] = B[i]`` for every row of ``B``.

    ``A``: the shared operator (as :func:`~.cg.cg_solve` takes it).  ``B``:
    (nrhs, N) right-hand sides; ``X0`` optional (nrhs, N) initial guesses.
    ``tol``: ABSOLUTE on each lane's ‖r‖₂, a scalar for all lanes or an
    (nrhs,) tensor of per-lane tolerances (solving scaled systems, pass
    ``tol_rel * ‖B_j‖`` per lane).  ``recompute_r_every`` > 0: per-lane
    residual-replacement restarts (solver/cg.py's semantics, lane-masked so
    frozen lanes stay frozen).  ``maxiter`` defaults to N + 1.

    Returns (X (nrhs, N), CGInfo with a leading nrhs axis on every field;
    ``rho_history`` (nrhs, maxiter + 1)).
    """
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=B.dtype, device=B.device)
    _check_block(B)
    tol_t = _lane_tol(tol, B)
    if X0 is None:
        X0 = torch.zeros_like(B)
    every = int(recompute_r_every)
    if isinstance(op, _LOCKSTEP_TYPES):
        mi = int(op.shape[0] + 1 if maxiter is None else maxiter)
        ops = _lockstep_ops(op, M)
        state = _lockstep_init(*ops, B.T, X0.T, mi)
        return batched_state_result(_drive(ops, state, B.T, tol_t, mi, every, 0))
    tols = tol_t.expand(B.shape[0])
    return _stack_lanes([cg_solve(op, B[i], X0[i], tol=tols[i], maxiter=maxiter, M=M,
                                  fused="never", recompute_r_every=every)
                         for i in range(B.shape[0])])
