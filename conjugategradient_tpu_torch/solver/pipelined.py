"""Single-synchronization ("pipelined") CG.  Counterpart of
``conjugategradient_tpu/solver/pipelined.py``, with the same recurrences,
termination and ``CGInfo`` contract.

Standard CG has two dependent reductions per iteration (pᵀAp, then ‖r‖²).
Without a preconditioner the loop runs the Chronopoulos–Gear recurrences,
whose two scalars are dots over the same vector pair, taken in one pass:

    s   = A·r                         (the matvec is applied to r, not p)
    γ   = r·r,  δ = r·s               (one pass)
    β   = γ/γ₋  (0 at k=0)
    α   = γ / (δ − β·γ/α₋)            (γ/δ at k=0)
    p   = r + β·p;   q = s + β·q      (q ≡ A·p by recurrence)
    x  += α·p;       r −= α·q

With ``M`` it runs the Ghysels–Vanroose recurrences (SIAM J. Sci. Comput.
36(4), 2014), whose three scalars are dots over one vector trio:

    γ   = r·u,  δ = w·u,  rr = r·r   (one pass)
    m   = M·w;  ν = A·m
    β   = γ/γ₋  (0 at k=0)
    α   = γ / (δ − β·γ/α₋)            (γ/δ at k=0)
    z   = ν + β·z;  q = m + β·q;  s = w + β·s;  p = u + β·p
    x  += α·p;  r −= α·s;  u −= α·q;  w −= α·z

(z ≡ A·M·s, q ≡ M·s, s ≡ A·p by induction.)  The extra recurrences carry
more rounding than Hestenes–Stiefel CG, and the drift grows like
O(eps·κ) (Cools et al., SIAM J. Matrix Anal. 2018); ``recompute_r_every``
replaces the recurrence residual with the true one and restarts the
directions.

Termination is the framework's: the pre-update ‖r_k‖² against the absolute
tolerance, the NaN exit (a zero denominator makes α NaN), γ = 0 freezes
the solve (a zero right-hand side, a warm start at the solution).  The
loop is device-resident as in solver/cg.py: every step is masked on the
device once ``done`` is set or k reaches the cap, and the host follows
``done`` through ``restart.run_chunked``.  The step's dots are stacked in
one place (:func:`_one_pass`), the pass a sharded form reduces once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..ops.blas import dot
from ..ops.spmv import full_precision_matmul
from ..types import as_linear_operator
from .cg import CGInfo
from .restart import run_chunked


@dataclasses.dataclass(frozen=True)
class _State:
    """The pipelined carry; ``u``, ``w``, ``z`` and ``s`` only under GV.
    ``q`` is A·p without a preconditioner and M·s with one; ``rho`` is the
    γ that ``CGInfo.rho`` reports."""

    k: torch.Tensor
    done: torch.Tensor
    fresh: torch.Tensor  # the next step takes the k == 0 formulas
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    gamma_old: torch.Tensor
    alpha_old: torch.Tensor
    rnorm_sq: torch.Tensor  # ‖r_k‖², the termination observable
    rho: torch.Tensor
    hist: torch.Tensor
    u: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None
    s: Optional[torch.Tensor] = None

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def _one_pass(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """The step's dots, stacked: one reduction point per iteration."""
    return torch.stack([dot(a, b) for a, b in pairs])


def _masked(live: torch.Tensor, new, old):
    return None if old is None else torch.where(live, new, old)


def _record(hist: torch.Tensor, k: torch.Tensor, value: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """hist[k] = value where ``mask``, by a tensor index (no host read)."""
    kk = k.long().reshape(1)
    return hist.index_put((kk,), torch.where(mask, value, hist.gather(0, kk)[0]).reshape(1))


def _alpha_beta(gamma, delta, st: _State):
    """β and α of a step (module doc), with the γ = 0 freeze and the
    zero-denominator NaN exit."""
    exact = gamma == 0
    beta = torch.where(st.fresh | exact, 0.0, gamma / st.gamma_old)
    denom = torch.where(st.fresh, delta, delta - beta * gamma / st.alpha_old)
    safe = torch.where(denom == 0, 1.0, denom)
    alpha = torch.where(denom == 0, float("nan"), gamma / safe)
    alpha = torch.where(exact, 0.0, alpha)
    return alpha, beta


def _step(A, st: _State, tol: torch.Tensor, M) -> _State:
    """One iteration, a no-op once ``done`` is set or k reaches the cap."""
    live = st.live
    # each recurrence a + c·b in the scalars' dtype, rounded once to the
    # vectors' (minres_step's rule; a no-op for float32 and float64)
    sdt, vdt = st.rnorm_sq.dtype, st.r.dtype

    def axpy(a, c, b):
        return (a.to(sdt) + c * b.to(sdt)).to(vdt)

    if M is None:
        s = A.matvec(st.r)
        gamma, delta = _one_pass(((st.r, st.r), (st.r, s)))
        alpha, beta = _alpha_beta(gamma, delta, st)
        p = axpy(st.r, beta, st.p)
        q = axpy(s, beta, st.q)
        x = axpy(st.x, alpha, p)
        r = axpy(st.r, -alpha, q)
        u = w = z = sv = None
    else:
        gamma, delta = _one_pass(((st.r, st.u), (st.w, st.u)))
        m = M(st.w)
        nu = A.matvec(m)
        alpha, beta = _alpha_beta(gamma, delta, st)
        z = axpy(nu, beta, st.z)
        q = axpy(m, beta, st.q)
        sv = axpy(st.w, beta, st.s)
        p = axpy(st.u, beta, st.p)
        x = axpy(st.x, alpha, p)
        r = axpy(st.r, -alpha, sv)
        u = axpy(st.u, -alpha, q)
        w = axpy(st.w, -alpha, z)
    # pre-update termination on the carried ‖r_k‖²
    done = torch.isnan(st.rnorm_sq) | (torch.sqrt(st.rnorm_sq) <= tol)
    rnorm_next = dot(r, r)
    k = st.k + live.to(torch.int32)
    return _State(
        k=k, done=torch.where(live, done, st.done), fresh=st.fresh & ~live,
        x=torch.where(live, x, st.x), r=torch.where(live, r, st.r),
        p=torch.where(live, p, st.p), q=torch.where(live, q, st.q),
        gamma_old=torch.where(live, gamma, st.gamma_old),
        alpha_old=torch.where(live, alpha, st.alpha_old),
        rnorm_sq=torch.where(live, rnorm_next, st.rnorm_sq),
        rho=torch.where(live, gamma, st.rho),
        hist=_record(st.hist, k, rnorm_next, live),
        u=_masked(live, u, st.u), w=_masked(live, w, st.w),
        z=_masked(live, z, st.z), s=_masked(live, sv, st.s),
    )


def _replace(A, st: _State, b: torch.Tensor, every: int, M) -> _State:
    """Residual replacement: the true r (and u = M r, w = A u under GV)
    from x and a full restart of the direction recurrences, masked on the
    device to multiples of ``every`` of a solve that is not done (no
    ``k < maxiter`` term: a solve capped on a boundary still reports its
    true residual).  γ doubles as ``CGInfo.rho`` at exit, so it is replaced
    too; β ignores γ₋ after a restart."""
    mask = (~st.done) & (st.k % every == 0)
    r_t = b - A.matvec(st.x)
    rnorm_t = dot(r_t, r_t)
    zero = lambda v: None if v is None else torch.where(mask, 0.0, v).to(v.dtype)  # noqa: E731
    if M is None:
        u = w = None
        gamma_old = torch.where(mask, rnorm_t, st.gamma_old)
        rho = torch.where(mask, rnorm_t, st.rho)
    else:
        u_t = M(r_t)
        w_t = A.matvec(u_t)
        u, w = torch.where(mask, u_t, st.u), torch.where(mask, w_t, st.w)
        gamma_old = st.gamma_old
        rho = torch.where(mask, dot(r_t, u_t), st.rho)
    return dataclasses.replace(
        st, fresh=st.fresh | mask, r=torch.where(mask, r_t, st.r),
        p=zero(st.p), q=zero(st.q), z=zero(st.z), s=zero(st.s), u=u, w=w,
        gamma_old=gamma_old, rnorm_sq=torch.where(mask, rnorm_t, st.rnorm_sq), rho=rho,
        hist=_record(st.hist, st.k, rnorm_t, mask),
    )


def _init(A, b: torch.Tensor, x0: Optional[torch.Tensor], maxiter: int, M) -> _State:
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - A.matvec(x)
    rnorm0 = dot(r0, r0)
    hist = torch.full((maxiter + 1,), float("nan"), dtype=rnorm0.dtype, device=b.device)
    hist[0] = rnorm0
    zerov = torch.zeros_like(r0)
    one = torch.ones_like(rnorm0)
    dev = b.device
    common = dict(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        fresh=torch.ones((), dtype=torch.bool, device=dev),
        x=x, r=r0, p=zerov, q=zerov, alpha_old=one, rnorm_sq=rnorm0, hist=hist,
    )
    if M is None:
        # γ₋ placeholder (unused while fresh) and the exit's rho
        return _State(gamma_old=rnorm0, rho=rnorm0, **common)
    u0 = M(r0)
    return _State(gamma_old=one, rho=one, u=u0, w=A.matvec(u0), z=zerov, s=zerov, **common)


def pipelined_cg_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    n: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    recompute_r_every: int = 0,
) -> Tuple[torch.Tensor, CGInfo]:
    """Solve SPD ``A x = b`` with single-sync CG.  Same call shape and
    ``CGInfo`` contract as :func:`~.cg.cg_solve`; with ``M`` the loop runs
    the Ghysels–Vanroose preconditioned recurrences (module doc), still one
    pass of dots per iteration.

    ``recompute_r_every`` = N > 0: every N iterations the true residual is
    recomputed (one SpMV, plus the M apply and a second SpMV under GV) and
    the direction state reset, a full restart as in ``cg_solve``; the
    pipelined recurrences drift faster than standard CG's, so long float32
    runs need it.  ``rho_history[k]`` holds the true ‖r‖² there.
    """
    full_precision_matmul()
    op = as_linear_operator(A, device=b.device, n=n, dtype=b.dtype)
    maxiter = int(op.shape[0] + 1 if maxiter is None else maxiter)
    every = int(recompute_r_every)
    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    box = [_init(op, b, x0, maxiter, M)]

    def step():
        box[0] = _step(op, box[0], tol_t, M)

    def replace():
        box[0] = _replace(op, box[0], b, every, M)

    run_chunked(step, lambda: box[0].live, maxiter, every, replace, done=lambda: box[0].done)
    st = box[0]
    return st.x, CGInfo(
        iterations=st.k,
        converged=st.done & ~torch.isnan(st.rnorm_sq),
        rho=st.rho,
        rnorm_sq=st.rnorm_sq,
        rho_history=st.hist,
    )
