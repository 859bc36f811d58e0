"""Batched multi-RHS solvers for the nonsymmetric and indefinite families:
lockstep MINRES, BiCGStab and GMRES(m) over ``A X = B`` column blocks.
Counterpart of ``conjugategradient_tpu/solver/batched_nonsym.py``.

The lane-masked lockstep pattern of solver/batched.py, extended:

* :func:`minres_solve_batched`: per-lane Paige–Saunders recurrences over
  (N, R) columns, one multi-RHS SpMV per iteration for all lanes;
* :func:`bicgstab_solve_batched`: per-lane BiCGStab recurrences, both
  SpMVs of an iteration multi-RHS, per-lane breakdown flags;
* :func:`gmres_solve_batched`: restarted GMRES with a lane axis on the
  Krylov basis ``V (m+1, N, R)``; CGS2 as products over the lane axis, the
  Givens rotations and the small triangular solves batched over the lanes
  on the device, and each restart recomputing every lane's true residual.
  The basis holds ``(m+1)·N·R`` values (twice with ``flexible=True``).

Per-lane semantics are the JAX package's (the solo solvers' recurrences
and masks): a lane's iterations, flags and history are what its solo solve
reports.  Finished lanes freeze; active lanes advance together.  Operators
without a multi-RHS SpMV run the solo solve once per lane, the results
stacked in the JAX layout (the JAX package vmaps it).  Infos carry a
leading nrhs axis; ``rnorm_history`` is (nrhs, maxiter + 1).

The loops are Python loops of device work with no host read per step.  The
host follows the flag "no lane live" (and, in GMRES, the cycle's step flag)
through ``solver/restart.py``'s ``_DonePoll``, so at most ``LOOKAHEAD - 1``
masked no-op steps or cycles follow the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.spmv import full_precision_matmul
from ..types import as_linear_operator
from .batched import (_LOCKSTEP_TYPES, _check_block, _dot_cols, _lane_index, _lane_tol,
                      _lockstep_ops, _stack_lanes)
from .bicgstab import BicgstabInfo, bicgstab_solve
from .gmres import GmresInfo, gmres_solve
from .minres import MinresInfo, minres_solve
from .restart import _DonePoll, run_chunked


def _setup(A, B, X0, tol, n):
    """(op, per-lane tol (R,), X0) after the shared validation."""
    full_precision_matmul()
    op = as_linear_operator(A, n=n, dtype=B.dtype, device=B.device)
    _check_block(B)
    tol_lanes = _lane_tol(tol, B).expand(B.shape[0])
    return op, tol_lanes, (torch.zeros_like(B) if X0 is None else X0)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _BatchedBicgstabState:
    """Lockstep BiCGStab carry: vectors (N, R), per-lane scalars (R,)."""

    k: torch.Tensor
    done: torch.Tensor
    broke: torch.Tensor
    X: torch.Tensor
    r: torch.Tensor
    rhat: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    rnorm: torch.Tensor
    hist: torch.Tensor  # (maxiter+1, R)


def _bicgstab_step(matvec_multi, precond, s: _BatchedBicgstabState, tol_l,
                   maxiter: int) -> _BatchedBicgstabState:
    """One lockstep BiCGStab iteration (both half-steps), per lane as
    solver/bicgstab.bicgstab_step; writes ``s.hist`` in place."""
    active = (~s.done) & (s.k < maxiter)
    vdt = s.r.dtype
    rho = _dot_cols(s.rhat, s.r)
    beta = (rho / s.rho) * (s.alpha / s.omega)
    p = (s.r + beta * (s.p - s.omega * s.v)).to(vdt)
    phat = precond(p).to(vdt)
    v = matvec_multi(phat).to(vdt)
    alpha = rho / _dot_cols(s.rhat, v)
    sv = (s.r - alpha * v).to(vdt)
    snorm = torch.sqrt(_dot_cols(sv, sv))
    x_half = (s.X + alpha * phat).to(s.X.dtype)
    half_done = snorm <= tol_l

    shat = precond(sv).to(vdt)
    t = matvec_multi(shat).to(vdt)
    omega = _dot_cols(t, sv) / _dot_cols(t, t)
    x_full = (x_half + omega * shat).to(s.X.dtype)
    r_full = (sv - omega * t).to(vdt)
    rnorm_full = torch.sqrt(_dot_cols(r_full, r_full))

    finite = (torch.isfinite(beta) & torch.isfinite(alpha) & torch.isfinite(omega)
              & torch.isfinite(rnorm_full))
    broke = ~finite & ~half_done
    rnorm_new = torch.where(half_done, snorm, rnorm_full)
    converged_now = half_done | (finite & (rnorm_full <= tol_l))
    broke = broke | (finite & ((omega == 0) | (rho == 0)) & ~converged_now)

    # frozen lanes keep everything; active lanes follow the solo step's
    # breakdown and half-step masks
    keep = ~active | broke
    hold = keep | half_done
    upd = active & ~broke
    k = torch.where(active, s.k + 1, s.k)
    rnorm = torch.where(active, torch.where(broke, s.rnorm, rnorm_new), s.rnorm)
    idx = _lane_index(k)
    s.hist.index_put_(idx, torch.where(active, rnorm, s.hist[idx]))
    return _BatchedBicgstabState(
        k=k,
        done=torch.where(active, converged_now | broke, s.done),
        broke=torch.where(active, broke, s.broke),
        X=torch.where(keep, s.X, torch.where(half_done, x_half, x_full)),
        r=torch.where(keep, s.r, torch.where(half_done, sv, r_full)),
        rhat=s.rhat, p=torch.where(hold, s.p, p), v=torch.where(hold, s.v, v),
        rho=torch.where(upd, rho, s.rho), alpha=torch.where(upd, alpha, s.alpha),
        omega=torch.where(upd, omega, s.omega), rnorm=rnorm, hist=s.hist,
    )


def bicgstab_solve_batched(
    A: Any,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    tol=0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
) -> Tuple[torch.Tensor, BicgstabInfo]:
    """Solve the (possibly nonsymmetric) systems ``A X[i] = B[i]`` for every
    row of ``B`` with lane-masked lockstep BiCGStab.

    ``A``: the shared operator; blocked-ELL, symmetric blocked-ELL, SELL,
    DIA and symmetric DIA read it once per SpMV for all lanes, anything
    else runs the solo solver per lane.  ``B``: (nrhs, N).  ``tol``:
    ABSOLUTE per lane on ‖r‖₂, scalar or (nrhs,).  The rest as
    :func:`~.bicgstab.bicgstab_solve` (``maxiter`` defaults to N).

    Returns (X (nrhs, N), BicgstabInfo with a leading nrhs axis on every
    field, per-lane ``breakdown`` and ``rnorm_true`` included).
    """
    op, tol_lanes, X0 = _setup(A, B, X0, tol, n)
    mi = int(op.shape[0] if maxiter is None else maxiter)
    if not isinstance(op, _LOCKSTEP_TYPES):
        return _stack_lanes([bicgstab_solve(op, B[i], X0[i], tol=tol_lanes[i], maxiter=mi, M=M)
                             for i in range(B.shape[0])])
    matvec_multi, precond, _ = _lockstep_ops(op, M)
    Bt, X0t = B.T, X0.T
    R = Bt.shape[1]
    r0 = Bt - matvec_multi(X0t)
    rnorm0 = torch.sqrt(_dot_cols(r0, r0))
    sdt = rnorm0.dtype
    tol_l = tol_lanes.to(sdt)
    hist = torch.full((mi + 1, R), float("nan"), dtype=sdt, device=B.device)
    hist[0] = rnorm0
    one = torch.ones(R, dtype=sdt, device=B.device)
    box = [_BatchedBicgstabState(
        k=torch.zeros(R, dtype=torch.int32, device=B.device),
        done=torch.isnan(rnorm0) | (rnorm0 <= tol_l), broke=torch.isnan(rnorm0),
        X=X0t, r=r0, rhat=r0, p=torch.zeros_like(r0), v=torch.zeros_like(r0),
        rho=one, alpha=one, omega=one, rnorm=rnorm0, hist=hist,
    )]

    def step():
        box[0] = _bicgstab_step(matvec_multi, precond, box[0], tol_l, mi)

    def live():
        return ((~box[0].done) & (box[0].k < mi)).any()

    run_chunked(step, live, mi, done=lambda: ~live())
    s = box[0]
    Rt = Bt - matvec_multi(s.X)
    info = BicgstabInfo(
        iterations=s.k,
        converged=s.done & ~s.broke,
        breakdown=s.broke,
        rnorm=s.rnorm,
        rnorm_history=s.hist.T,  # (R, maxiter+1)
        rnorm_true=torch.sqrt(_dot_cols(Rt, Rt)),
    )
    return s.X.T, info


# ---------------------------------------------------------------------------
# MINRES
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _BatchedMinresState:
    """Lockstep MINRES carry: the solo carry with a lane axis."""

    k: torch.Tensor
    done: torch.Tensor
    nan: torch.Tensor
    x: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    y: torch.Tensor
    oldb: torch.Tensor
    beta: torch.Tensor
    dbar: torch.Tensor
    epsln: torch.Tensor
    phibar: torch.Tensor
    cs: torch.Tensor
    sn: torch.Tensor
    w: torch.Tensor
    w2: torch.Tensor
    hist: torch.Tensor  # (maxiter+1, R)


def _minres_step(matvec_multi, precond, s: _BatchedMinresState, tol_l, shift,
                 maxiter: int) -> _BatchedMinresState:
    """One lockstep MINRES iteration, per lane as solver/minres.minres_step;
    writes ``s.hist`` in place."""
    active = (~s.done) & (s.k < maxiter)
    # frozen lanes: β may be 0 or NaN; 1 keeps their columns finite (every
    # reduction is column-wise, so lanes never mix; the masks drop them)
    bsafe = torch.where(active & (s.beta != 0) & ~torch.isnan(s.beta), s.beta, 1.0)
    vdt = s.y.dtype
    v = (s.y / bsafe).to(vdt)
    yv = (matvec_multi(v) - shift * v).to(vdt)
    noprev = s.oldb == 0
    c1 = torch.where(noprev, 0.0, s.beta / torch.where(noprev, 1.0, s.oldb))
    yv = yv - (c1 * s.r1).to(vdt)
    alfa = _dot_cols(v, yv)
    yv = (yv - (alfa / bsafe) * s.r2).to(vdt)
    r2_n = yv
    y_next = precond(r2_n).to(vdt)
    beta_n = torch.sqrt(_dot_cols(r2_n, y_next))

    delta = s.cs * s.dbar + s.sn * alfa
    gbar = s.sn * s.dbar - s.cs * alfa
    epsln_n = s.sn * beta_n
    dbar_n = -s.cs * beta_n
    tiny = torch.finfo(beta_n.dtype).tiny
    gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta_n * beta_n), tiny)
    cs_n = gbar / gamma
    sn_n = beta_n / gamma
    phi = cs_n * s.phibar
    phibar_n = sn_n * s.phibar

    w_n = ((v - s.epsln * s.w2 - delta * s.w) / gamma).to(s.w.dtype)
    x_n = (s.x + phi * w_n).to(s.x.dtype)

    def sel(new, old):
        return torch.where(active, new, old)

    k = torch.where(active, s.k + 1, s.k)
    is_nan = torch.isnan(phibar_n) | torch.isnan(beta_n)
    done_n = is_nan | (phibar_n <= tol_l) | (beta_n == 0)
    idx = _lane_index(k)
    s.hist.index_put_(idx, torch.where(active, phibar_n, s.hist[idx]))
    return _BatchedMinresState(
        k=k, done=sel(done_n, s.done), nan=sel(s.nan | is_nan, s.nan),
        x=sel(x_n, s.x), r1=sel(s.r2, s.r1), r2=sel(r2_n, s.r2), y=sel(y_next, s.y),
        oldb=sel(s.beta, s.oldb), beta=sel(beta_n, s.beta),
        dbar=sel(dbar_n, s.dbar), epsln=sel(epsln_n, s.epsln),
        phibar=sel(phibar_n, s.phibar), cs=sel(cs_n, s.cs), sn=sel(sn_n, s.sn),
        w=sel(w_n, s.w), w2=sel(s.w, s.w2),  # the new w2 is the old w (the solo swap)
        hist=s.hist,
    )


def minres_solve_batched(
    A: Any,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    tol=0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    shift: float = 0.0,
    n: Optional[int] = None,
) -> Tuple[torch.Tensor, MinresInfo]:
    """Solve the symmetric (possibly indefinite) systems ``(A − σI) X[i] =
    B[i]`` for every row of ``B`` with lane-masked lockstep MINRES.

    Per lane the semantics of :func:`~.minres.minres_solve` (per-lane β = 0
    and NaN exits); ``tol`` scalar or (nrhs,).  Returns (X (nrhs, N),
    MinresInfo with a leading nrhs axis).
    """
    op, tol_lanes, X0 = _setup(A, B, X0, tol, n)
    mi = int(op.shape[0] if maxiter is None else maxiter)
    if not isinstance(op, _LOCKSTEP_TYPES):
        return _stack_lanes([minres_solve(op, B[i], X0[i], tol=tol_lanes[i], maxiter=mi, M=M,
                                          shift=shift, fused="never")
                             for i in range(B.shape[0])])
    matvec_multi, precond, _ = _lockstep_ops(op, M)
    shift_t = torch.as_tensor(shift, dtype=B.dtype, device=B.device)
    Bt, X0t = B.T, X0.T
    R = Bt.shape[1]
    r1 = Bt - matvec_multi(X0t) + shift_t * X0t
    y0 = precond(r1)
    beta1 = torch.sqrt(_dot_cols(r1, y0))  # NaN on a lane where M is not SPD
    sdt = beta1.dtype
    tol_l = tol_lanes.to(sdt)
    hist = torch.full((mi + 1, R), float("nan"), dtype=sdt, device=B.device)
    hist[0] = beta1
    zero = torch.zeros(R, dtype=sdt, device=B.device)
    box = [_BatchedMinresState(
        k=torch.zeros(R, dtype=torch.int32, device=B.device),
        done=torch.isnan(beta1) | (beta1 <= tol_l), nan=torch.isnan(beta1),
        x=X0t, r1=r1, r2=r1, y=y0.to(Bt.dtype), oldb=zero, beta=beta1,
        dbar=zero, epsln=zero, phibar=beta1, cs=-torch.ones(R, dtype=sdt, device=B.device),
        sn=zero, w=torch.zeros_like(Bt), w2=torch.zeros_like(Bt), hist=hist,
    )]

    def step():
        box[0] = _minres_step(matvec_multi, precond, box[0], tol_l, shift_t, mi)

    def live():
        return ((~box[0].done) & (box[0].k < mi)).any()

    run_chunked(step, live, mi, done=lambda: ~live())
    s = box[0]
    r_true = Bt - matvec_multi(s.x) + shift_t * s.x
    info = MinresInfo(
        iterations=s.k,
        converged=s.done & ~s.nan,
        rnorm=s.phibar,
        rnorm_history=s.hist.T,
        rnorm_true=torch.sqrt(_dot_cols(r_true, r_true)),
    )
    return s.x.T, info


# ---------------------------------------------------------------------------
# GMRES(m)
# ---------------------------------------------------------------------------


class _BatchedGmres:
    """The outer carry (k, cycles, done, broke, X, rnorm, hist) over R
    lanes, and one cycle's basis (m+1, N, R), Hessenberg columns
    (m+1, m, R), rotations (m, R) and flags: the lane-axis form of
    solver/gmres._Solve, with the JAX package's batched lane masks."""

    def __init__(self, matvec_multi, precond, Bt, X0t, tol_l, maxiter, m, flexible):
        self.mv, self.precond, self.Bt = matvec_multi, precond, Bt
        self.maxiter, self.m, self.flexible = maxiter, m, flexible
        dev = Bt.device
        self.vdt = Bt.dtype
        R = Bt.shape[1]
        self.lanes = torch.arange(R, device=dev)
        r0 = Bt - matvec_multi(X0t)
        self.rnorm = torch.sqrt(_dot_cols(r0, r0))
        self.sdt = self.rnorm.dtype
        self.tol = tol_l.to(self.sdt)
        # row maxiter + 1 absorbs masked writes; trimmed on return
        self.hist = torch.full((maxiter + 2, R), float("nan"), dtype=self.sdt, device=dev)
        self.hist[0] = self.rnorm
        self.k = torch.zeros(R, dtype=torch.int32, device=dev)
        self.cycles = torch.zeros(R, dtype=torch.int32, device=dev)
        self.done = torch.isnan(self.rnorm) | (self.rnorm <= self.tol)
        self.broke = torch.isnan(self.rnorm)
        self.X = X0t

    def live(self) -> torch.Tensor:
        """Whether a cycle runs (the JAX loop's predicate)."""
        return ((self.k < self.maxiter) & ~self.done).any()

    def stopped(self) -> torch.Tensor:
        """The step flag: no further step of this cycle is active on any lane."""
        return (self.idone | (self.kk + self.jused >= self.maxiter)).all()

    def start_cycle(self) -> None:
        """r = b − A x, v₀ = r/‖r‖ per lane.  Lanes done at the cycle's
        start enter it frozen (their count read as maxiter: no step is
        active for them)."""
        m, sdt, vdt = self.m, self.sdt, self.vdt
        N, R = self.Bt.shape
        dev = self.Bt.device
        self.run = self.live()
        self.done_in = self.done
        self.kk = torch.where(self.done, self.maxiter, self.k)
        r = self.Bt - self.mv(self.X).to(vdt)
        beta = torch.sqrt(_dot_cols(r, r)).to(sdt)
        safe = torch.where(beta > 0, beta, 1.0).to(vdt)
        self.V = torch.zeros((m + 1, N, R), dtype=vdt, device=dev)
        self.V[0] = torch.where(beta > 0, r / safe, torch.zeros_like(r))
        self.Z = torch.zeros((m if self.flexible else 1, N, R), dtype=vdt, device=dev)
        self.Rm = torch.zeros((m + 1, m, R), dtype=sdt, device=dev)
        self.g = torch.zeros((m + 1, R), dtype=sdt, device=dev)
        self.g[0] = beta
        self.cs = torch.ones((m, R), dtype=sdt, device=dev)
        self.sn = torch.zeros((m, R), dtype=sdt, device=dev)
        self.idone = torch.zeros(R, dtype=torch.bool, device=dev)
        self.ibroke = torch.zeros(R, dtype=torch.bool, device=dev)
        self.jused = torch.zeros(R, dtype=torch.int32, device=dev)

    def step(self, j: int) -> None:
        """Arnoldi step j on every lane: z = M v_j, w = A z, CGS2 against the
        j + 2 live basis rows (the rows past them are zero), the previous
        rotations on the new column, the new rotation and the Givens
        estimate."""
        sdt, vdt, V = self.sdt, self.vdt, self.V
        active = ~self.idone & (self.kk + j < self.maxiter)
        z = self.precond(V[j]).to(vdt)
        if self.flexible:
            self.Z[j] = torch.where(active, z, self.Z[j])
        w = self.mv(z).to(vdt)
        Va = V[: j + 2].to(sdt)
        wa = w.to(sdt)
        h1 = torch.einsum("jnr,nr->jr", Va, wa)
        w1 = wa - torch.einsum("jnr,jr->nr", Va, h1)
        h2 = torch.einsum("jnr,nr->jr", Va, w1)
        w2 = w1 - torch.einsum("jnr,jr->nr", Va, h2)
        h = h1 + h2  # (j+2, R)
        hsub = torch.sqrt(_dot_cols(w2, w2))
        hs_safe = torch.where(hsub > 0, hsub, 1.0).to(vdt)
        vnext = torch.where(hsub > 0, w2.to(vdt) / hs_safe, torch.zeros_like(w2, dtype=vdt))
        V[j + 1] = torch.where(active, vnext, V[j + 1])

        col = torch.cat([h, h.new_zeros(self.m - 1 - j, h.shape[1])])  # (m+1, R)
        col[j + 1] = hsub
        for i in range(j):  # the previous rotations, in order
            a0, a1 = col[i].clone(), col[i + 1].clone()
            col[i] = self.cs[i] * a0 + self.sn[i] * a1
            col[i + 1] = -self.sn[i] * a0 + self.cs[i] * a1
        a0, a1 = col[j].clone(), col[j + 1].clone()
        denom = torch.sqrt(a0 * a0 + a1 * a1)
        ok = denom > 0
        csj = torch.where(ok, a0 / torch.where(ok, denom, 1.0), 1.0)
        snj = torch.where(ok, a1 / torch.where(ok, denom, 1.0), 0.0)
        col[j] = denom
        col[j + 1] = 0.0
        gj = self.g[j]
        g_new = self.g.clone()
        g_new[j] = csj * gj
        g_new[j + 1] = -snj * gj
        resid_est = torch.abs(g_new[j + 1])

        self.Rm[:, j] = torch.where(active, col, self.Rm[:, j])
        self.cs[j] = torch.where(active, csj, self.cs[j])
        self.sn[j] = torch.where(active, snj, self.sn[j])
        self.g = torch.where(active, g_new, self.g)

        nonfinite = ~torch.isfinite(resid_est)
        step_done = active & (nonfinite | (resid_est <= self.tol))
        self.jused = self.jused + active.to(torch.int32)
        idx = torch.where(active, self.kk + self.jused, self.maxiter + 1)
        self.hist.index_put_((idx.long(), self.lanes), resid_est)
        self.idone = self.idone | step_done
        self.ibroke = self.ibroke | (active & nonfinite)

    def end_cycle(self) -> None:
        """Per lane, the triangular solve on the leading jused columns, the
        update and the true-residual restart; lanes done at the cycle's
        start keep their state, history column included."""
        m, sdt, vdt = self.m, self.sdt, self.vdt
        dev = self.Bt.device
        valid = torch.arange(m, device=dev)[:, None] < self.jused[None, :]  # (m, R)
        eye = torch.eye(m, dtype=sdt, device=dev)[:, :, None]
        Rv = torch.where(valid[None, :, :], self.Rm[:m, :m, :], eye)
        gv = torch.where(valid, self.g[:m], torch.zeros((), dtype=sdt, device=dev))
        # torch has no bf16 triangular solve: a bf16 system is solved in
        # float32 and y rounded back (a no-op for float32 and float64)
        wdt = torch.promote_types(sdt, torch.float32)
        y = torch.linalg.solve_triangular(Rv.permute(2, 0, 1).to(wdt), gv.T[:, :, None].to(wdt),
                                          upper=True)[:, :, 0].T.to(sdt)  # (m, R)
        if self.flexible:
            dx = torch.einsum("jnr,jr->nr", self.Z.to(sdt), y).to(vdt)
        else:
            zc = torch.einsum("jnr,jr->nr", self.V[:m].to(sdt), y).to(vdt)
            dx = self.precond(zc).to(vdt)
        moved = self.jused > 0  # lanes that ran no step this cycle do not move
        x_new = (self.X + torch.where(moved, dx, torch.zeros_like(dx))).to(self.X.dtype)
        r_new = self.Bt - self.mv(x_new).to(vdt)
        rnorm_new = torch.sqrt(_dot_cols(r_new, r_new)).to(sdt)
        finite = torch.isfinite(rnorm_new) & ~self.ibroke
        k_new = self.kk + self.jused
        keep = self.done_in | ~self.run  # a cycle after the end is a no-op
        idx = torch.where(finite & ~keep, k_new, self.maxiter + 1)
        self.hist.index_put_((idx.long(), self.lanes), rnorm_new)
        rnorm_out = torch.where(finite, rnorm_new, self.rnorm)
        done = ~finite | (rnorm_out <= self.tol) | (self.jused == 0)
        self.X = torch.where(keep, self.X, torch.where(finite, x_new, self.X))
        self.rnorm = torch.where(keep, self.rnorm, rnorm_out)
        self.k = torch.where(keep, self.k, k_new)
        self.done = torch.where(self.run, self.done_in | done, self.done)
        self.broke = torch.where(self.run, ~finite & ~self.done_in, self.broke)
        self.cycles = self.cycles + (self.run & ~self.done_in).to(torch.int32)
        del self.V, self.Z  # the basis is a cycle's: free it before the next


def gmres_solve_batched(
    A: Any,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    tol=0.0,
    maxiter: Optional[int] = None,
    restart: int = 30,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    flexible: bool = False,
    n: Optional[int] = None,
) -> Tuple[torch.Tensor, GmresInfo]:
    """Solve the (possibly nonsymmetric) systems ``A X[i] = B[i]`` for every
    row of ``B`` with lockstep GMRES(m).

    The Krylov basis carries a lane axis: the device holds
    ``(restart+1)·N·nrhs`` values (and as many again with
    ``flexible=True``).  Layouts with a multi-RHS SpMV read the operator
    once per Arnoldi step for all lanes; others run the solo solver per
    lane.  Arguments and returns as :func:`~.gmres.gmres_solve` with a
    leading nrhs axis; ``tol`` scalar or (nrhs,).
    """
    op, tol_lanes, X0 = _setup(A, B, X0, tol, n)
    N = op.shape[0]
    mi = int(N if maxiter is None else maxiter)
    m = max(1, min(int(restart), mi, N))
    if flexible and M is None:
        flexible = False
    if not isinstance(op, _LOCKSTEP_TYPES):
        return _stack_lanes([gmres_solve(op, B[i], X0[i], tol=tol_lanes[i], maxiter=mi,
                                         restart=m, M=M, flexible=flexible)
                             for i in range(B.shape[0])])
    matvec_multi, precond, _ = _lockstep_ops(op, M)
    s = _BatchedGmres(matvec_multi, precond, B.T, X0.T, tol_lanes, mi, m, bool(flexible))

    cycles = _DonePoll(lambda: ~s.live())
    while not cycles.finished():
        s.start_cycle()
        steps = _DonePoll(s.stopped)
        for j in range(m):
            if steps.finished():
                break
            s.step(j)
            steps.push()
        s.end_cycle()
        cycles.push()

    info = GmresInfo(
        iterations=s.k,
        cycles=s.cycles,
        converged=(s.rnorm <= s.tol) & ~s.broke,
        breakdown=s.broke,
        rnorm=s.rnorm,
        rnorm_history=s.hist[: mi + 1].T,  # (R, maxiter+1)
        rnorm_true=s.rnorm,
    )
    return s.X.T, info
