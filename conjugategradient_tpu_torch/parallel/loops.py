"""The row-sharded loop cores.  Counterpart of the single-RHS part of
``conjugategradient_tpu/parallel/loops.py``: the portable (P)CG, MINRES,
pipelined (Chronopoulos–Gear and Ghysels–Vanroose), s-step, BiCGStab,
GMRES and deflated loops, the fused (P)CG and MINRES loops, and the fused
path's gate.

The JAX package runs one loop body per shard inside ``shard_map``.  Here a
body is written as "for each shard this process owns: local work; then one
collective" against a shard group (``collectives.py``): the layout's local
matvec (``LocalMatvec``: the owned shards' vectors in, A·v on each out; it
issues its own all_gather or ring halo) and ``group.psum`` for the dots.
Vectors are lists with one tensor per owned shard; scalars (α, β, ρ, ‖r‖²,
done, k, the history) are one copy per process on its device, the same bits
on every shard after a psum, and are never read by the host inside the loop.

The loops run under ``solver/restart.run_chunked`` (GMRES under its two
``_DonePoll`` flags, as ``solver/gmres.py``).  A step after the end is a
no-op, so ``iterations`` and ``rho_history`` match the JAX ``while_loop``:
the portable steps mask every field (as solver/cg.py does); in the fused
steps every kernel returns at once once the solve's ``live`` flag is 0, and
the one-card scalar steps they call after each psum
(``ops/cuda/fused_cg.finish_update``, ``fused_minres.finish_update``) are
masked to a live solve.  Every loop here passes its ``done`` flag, so at
most ``LOOKAHEAD - 1`` steps follow it: a step after the end still costs
its host launches, several per shard (the one-device fused loops, two
launches a step, do not poll).

The preconditioner of a portable loop (``Precond``) is None, a list of (m,)
tensors (Jacobi scaling, one per owned shard) or a callable from the owned
shards' vectors to M⁻¹ applied to each (the front end's ``M_local``).
Where a recurrence meets a vector, it does so in the scalars' dtype and is
rounded once to the vectors' dtype (``solver/minres.py``'s rule; a no-op in
float32 and float64).

Semantics are those of the JAX loops: recurrence residual, Hestenes–Stiefel
α/β, termination on the pre-update ‖r‖² against an absolute tol, the
ρ == 0 guard; MINRES's Paige–Saunders recurrence with ``rho_history``
holding φ̄²; BiCGStab and GMRES report squared norms.

Each loop returns ``(x, k, done, rho, rnorm, hist)`` with ``x`` one tensor
per owned shard.

The multi-RHS loops (:func:`_sharded_lockstep_pcg`, :func:`_sharded_block_cg`,
chosen by :func:`_batched_loop`) keep each owned shard's rows of every lane
as an (m, R) slab and sum (R,) lane dots or (R, R) Gram blocks over the
shards; they return the slabs, per-lane ``k``, ``done``, ``rho`` and
``rnorm`` (R,), and the history as (R, maxiter + 1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Union

import torch

from ..ops.blas import dot
from ..ops.cuda.fused_cg import (C_DONE, C_K, C_LIVE, S_BETA, S_RHO, S_RNORM, FusedWork,
                                 bell_spmv_dot, finish_dir, finish_update, fused_update_dot,
                                 fused_update_dot_pcg, put_hist)
from ..ops.cuda import fused_minres as fm
from ..ops.spmv import full_precision_matmul
from ..solver.restart import _DonePoll, run_chunked
from ..solver.sstep import make_sstep_loop

Vecs = List[torch.Tensor]
#: local_matvec(vs) -> [A_i v]: every OWNED shard's rows of A times v, the
#: owned shards' vectors in (it gathers or halos what it needs itself)
LocalMatvec = Callable[[Vecs], Vecs]
Precond = Union[None, Vecs, Callable[[Vecs], Vecs]]


def _precond(pre: Precond, vs: Vecs) -> Vecs:
    """The per-shard preconditioner on every owned shard: None = identity,
    (m,) tensors = Jacobi scaling, a callable = a general local apply."""
    if pre is None:
        return list(vs)
    if callable(pre):
        return list(pre(vs))
    return [d * v for d, v in zip(pre, vs)]


def _pdot(group, us: Vecs, vs: Vecs) -> torch.Tensor:
    """Σ over every shard of u·v (float32 accumulation at least)."""
    return group.psum([dot(u, v) for u, v in zip(us, vs)])


def _pstack(group, *pairs) -> torch.Tensor:
    """Several shard-summed dots in ONE psum: the stacked per-shard
    partials of ``pairs`` (each a (us, vs) pair of owned vectors)."""
    n_own = len(pairs[0][0])
    return group.psum([torch.stack([dot(us[i], vs[i]) for us, vs in pairs])
                       for i in range(n_own)])


def _scaled(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(c·v) in the scalar's dtype, rounded to v's."""
    return (c * v.to(c.dtype)).to(v.dtype)


def _axpy(a: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(a + c·v) in the scalar's dtype, rounded once to a's."""
    return (a.to(c.dtype) + c * v.to(c.dtype)).to(a.dtype)


def _keep(live, new: Vecs, old: Vecs) -> Vecs:
    return [torch.where(live, a, b) for a, b in zip(new, old)]


def _hist(maxiter: int, first: torch.Tensor, extra: int = 0) -> torch.Tensor:
    hist = torch.full((maxiter + 1 + extra,), float("nan"), dtype=first.dtype,
                      device=first.device)
    hist[0] = first
    return hist


def _zero_i32(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


def _false(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=dev)


@dataclasses.dataclass(frozen=True)
class _Ctx:
    """What a portable body needs besides its carry."""

    group: object
    apply: LocalMatvec
    b: Vecs
    precond: Precond
    tol: torch.Tensor

    def residual(self, x: Vecs) -> Vecs:
        return [b - ax for b, ax in zip(self.b, self.apply(x))]


def _ctx(group, apply, b, precond, tol) -> _Ctx:
    return _Ctx(group, apply, b, precond,
                torch.as_tensor(tol, dtype=b[0].dtype, device=group.device))


# ---- portable (P)CG ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PCGCarry:
    k: torch.Tensor
    done: torch.Tensor
    x: Vecs
    r: Vecs
    p: Vecs
    rho: torch.Tensor  # r·z (== r·r unpreconditioned)
    rnorm: torch.Tensor  # r·r
    hist: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def _pcg_init_carry(ctx: _Ctx, x0: Vecs, maxiter: int) -> PCGCarry:
    """r₀ = b − A·x₀, p₀ = z₀ = M⁻¹r₀, ρ₀ and ‖r₀‖² over the shards."""
    r0 = ctx.residual(x0)
    z0 = _precond(ctx.precond, r0)
    rnorm0 = _pdot(ctx.group, r0, r0)
    rho0 = rnorm0 if ctx.precond is None else _pdot(ctx.group, r0, z0)
    dev = rnorm0.device
    return PCGCarry(k=_zero_i32(dev), done=_false(dev), x=list(x0), r=r0, p=z0, rho=rho0,
                    rnorm=rnorm0, hist=_hist(maxiter, rnorm0))


def _pcg_body_fn(ctx: _Ctx, c: PCGCarry) -> PCGCarry:
    """One per-shard (P)CG iteration: one SpMV, two psum rounds (three
    with a preconditioner: ρ and ‖r‖² apart, as in the JAX loop); a masked
    no-op once the solve is done or capped."""
    live = c.live
    q = ctx.apply(c.p)
    pap = _pdot(ctx.group, c.p, q)
    # exact-convergence guard (solver/cg.py): rho == 0 would put 0/0 into x
    exact = c.rho == 0
    alpha = torch.where(exact, 0, c.rho / torch.where(exact, 1, pap))
    x = [torch.where(live, (x + alpha * p).to(x.dtype), x) for x, p in zip(c.x, c.p)]
    r = [torch.where(live, (r - alpha * qi).to(r.dtype), r) for r, qi in zip(c.r, q)]
    # termination tests the PRE-update residual (CG.hpp:401-402)
    done = torch.isnan(c.rnorm) | (torch.sqrt(c.rnorm) <= ctx.tol)
    z = _precond(ctx.precond, r)
    rnorm_next = _pdot(ctx.group, r, r)
    rho_next = rnorm_next if ctx.precond is None else _pdot(ctx.group, r, z)
    beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, c.rho))
    p = [torch.where(live, (zi + beta * p).to(p.dtype), p) for zi, p in zip(z, c.p)]
    k = c.k + live.to(torch.int32)
    put_hist(c.hist, k, live, rnorm_next)
    return PCGCarry(k=k, done=torch.where(live, done, c.done), x=x, r=r, p=p,
                    rho=torch.where(live, rho_next, c.rho),
                    rnorm=torch.where(live, rnorm_next, c.rnorm), hist=c.hist)


def _pcg_replace_fn(ctx: _Ctx, c: PCGCarry, every: int) -> PCGCarry:
    """Residual-replacement full restart (solver/cg.py's semantics on the
    shards): r ← b − A·x, p ← M⁻¹r, ρ, ‖r‖² and hist[k] from the true
    residual, masked to iterations k that are multiples of ``every`` of a
    solve that is not done.  The extra SpMV's collectives and the dots ride
    the same collectives as an iteration."""
    mask = (~c.done) & (c.k % every == 0)
    r_true = ctx.residual(c.x)
    rnorm_t = _pdot(ctx.group, r_true, r_true)
    z_t = _precond(ctx.precond, r_true)
    rho_t = rnorm_t if ctx.precond is None else _pdot(ctx.group, r_true, z_t)
    put_hist(c.hist, c.k, mask, rnorm_t)
    return PCGCarry(k=c.k, done=c.done, x=c.x, r=_keep(mask, r_true, c.r),
                    p=_keep(mask, z_t, c.p), rho=torch.where(mask, rho_t, c.rho),
                    rnorm=torch.where(mask, rnorm_t, c.rnorm), hist=c.hist)


def _sharded_pcg(group, apply: LocalMatvec, b: Vecs, x0: Vecs, precond: Precond, tol: float,
                 maxiter: int, recompute_r_every: int = 0):
    """The per-shard (P)CG loop, solver/cg.py's semantics (residual
    replacement included)."""
    ctx = _ctx(group, apply, b, precond, tol)
    box = [_pcg_init_carry(ctx, x0, maxiter)]

    def step():
        box[0] = _pcg_body_fn(ctx, box[0])

    def replace():
        box[0] = _pcg_replace_fn(ctx, box[0], recompute_r_every)

    run_chunked(step, lambda: box[0].live, maxiter, recompute_r_every, replace,
                done=lambda: box[0].done)
    c = box[0]
    return c.x, c.k, c.done, c.rho, c.rnorm, c.hist


# ---- portable MINRES ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MinresCarry:
    k: torch.Tensor
    done: torch.Tensor
    nan: torch.Tensor  # breakdown (M not SPD, overflow)
    x: Vecs
    r1: Vecs  # Lanczos v_{k-1}, un-normalised
    r2: Vecs  # Lanczos v_k, un-normalised
    y: Vecs  # M r2
    oldb: torch.Tensor
    beta: torch.Tensor
    dbar: torch.Tensor
    epsln: torch.Tensor
    phibar: torch.Tensor
    cs: torch.Tensor
    sn: torch.Tensor
    w: Vecs
    w2: Vecs
    hist: torch.Tensor  # φ̄² per iteration

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def _minres_init_carry(ctx: _Ctx, x0: Vecs, maxiter: int) -> MinresCarry:
    r1 = ctx.residual(x0)
    y0 = _precond(ctx.precond, r1)
    beta1 = torch.sqrt(_pdot(ctx.group, r1, y0))
    sdt, dev = beta1.dtype, beta1.device
    zero = torch.zeros((), dtype=sdt, device=dev)
    nan = torch.isnan(beta1)
    return MinresCarry(
        k=_zero_i32(dev), done=nan | (beta1 <= ctx.tol), nan=nan, x=list(x0), r1=r1, r2=r1,
        y=[y.to(b.dtype) for y, b in zip(y0, ctx.b)],
        oldb=zero, beta=beta1, dbar=zero, epsln=zero, phibar=beta1,
        cs=-torch.ones((), dtype=sdt, device=dev), sn=zero,
        w=[torch.zeros_like(b) for b in ctx.b], w2=[torch.zeros_like(b) for b in ctx.b],
        hist=_hist(maxiter, beta1 * beta1))


def _minres_body_fn(ctx: _Ctx, s: MinresCarry) -> MinresCarry:
    """One per-shard MINRES iteration: one SpMV and two psum rounds (v·y
    and the Lanczos β), every Givens scalar shard-replicated; a masked no-op
    once the solve is done or capped (β may be 0 or NaN there)."""
    live = s.live
    dt = s.y[0].dtype
    v = [(y / s.beta).to(dt) for y in s.y]
    yn = ctx.apply(v)
    noprev = s.oldb == 0  # the first step has no v_{k-1} term
    c1 = torch.where(noprev, 0, s.beta / torch.where(noprev, 1, s.oldb))
    yn = [y - (c1 * r1).to(dt) for y, r1 in zip(yn, s.r1)]
    alfa = _pdot(ctx.group, v, yn)
    r2n = [(y - (alfa / s.beta) * r2).to(dt) for y, r2 in zip(yn, s.r2)]
    y_next = [y.to(dt) for y in _precond(ctx.precond, r2n)]
    beta = torch.sqrt(_pdot(ctx.group, r2n, y_next))  # NaN iff M is not SPD

    # Givens QR of the tridiagonal
    delta = s.cs * s.dbar + s.sn * alfa
    gbar = s.sn * s.dbar - s.cs * alfa
    epsln = s.sn * beta
    dbar = -s.cs * beta
    gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta * beta),
                            torch.finfo(s.phibar.dtype).tiny)
    cs = gbar / gamma
    sn = beta / gamma
    phi = cs * s.phibar
    phibar = sn * s.phibar

    # solution update
    w = [((vi - s.epsln * w2 - delta * w1) / gamma).to(w1.dtype)
         for vi, w1, w2 in zip(v, s.w, s.w2)]
    x = [(xi + phi * wi).to(xi.dtype) for xi, wi in zip(s.x, w)]

    is_nan = torch.isnan(phibar) | torch.isnan(beta)
    done = is_nan | (phibar <= ctx.tol) | (beta == 0)
    k = s.k + live.to(torch.int32)
    put_hist(s.hist, k, live, phibar * phibar)

    def keep(new, old):
        return torch.where(live, new, old)

    return MinresCarry(
        k=k, done=keep(done, s.done), nan=keep(is_nan, s.nan),
        x=_keep(live, x, s.x), r1=_keep(live, s.r2, s.r1), r2=_keep(live, r2n, s.r2),
        y=_keep(live, y_next, s.y), oldb=keep(s.beta, s.oldb), beta=keep(beta, s.beta),
        dbar=keep(dbar, s.dbar), epsln=keep(epsln, s.epsln),
        phibar=keep(phibar, s.phibar), cs=keep(cs, s.cs), sn=keep(sn, s.sn),
        w=_keep(live, w, s.w), w2=_keep(live, s.w, s.w2), hist=s.hist)


def _sharded_minres(group, apply: LocalMatvec, b: Vecs, x0: Vecs, precond: Precond,
                    tol: float, maxiter: int):
    """Per-shard MINRES (Paige–Saunders) for symmetric, possibly indefinite
    systems, at CG's collective cost.  The preconditioner must be SPD: an
    indefinite M NaNs the Lanczos inner product and reports
    ``converged=False``.  rho = rnorm = φ̄², NaN after a breakdown."""
    ctx = _ctx(group, apply, b, precond, tol)
    box = [_minres_init_carry(ctx, x0, maxiter)]

    def step():
        box[0] = _minres_body_fn(ctx, box[0])

    run_chunked(step, lambda: box[0].live, maxiter, done=lambda: box[0].done)
    s = box[0]
    rho = torch.where(s.nan, torch.full_like(s.phibar, float("nan")), s.phibar * s.phibar)
    return s.x, s.k, s.done, rho, rho, s.hist


# ---- pipelined CG (Chronopoulos–Gear) and PCG (Ghysels–Vanroose) ----------------

@dataclasses.dataclass(frozen=True)
class PipeCarry:
    """The pipelined loops' carry; u, w, z and s only under Ghysels–Vanroose."""

    k: torch.Tensor
    done: torch.Tensor
    fresh: torch.Tensor  # the next step takes the k == 0 formulas
    x: Vecs
    r: Vecs
    p: Vecs
    q: Vecs
    gamma_old: torch.Tensor
    alpha_old: torch.Tensor
    rnorm: torch.Tensor
    rho: torch.Tensor
    hist: torch.Tensor
    u: Optional[Vecs] = None
    w: Optional[Vecs] = None
    z: Optional[Vecs] = None
    s: Optional[Vecs] = None

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def _pipe_alpha_beta(gamma, delta, c: PipeCarry):
    """β and α of a pipelined step, with the γ = 0 freeze and the
    zero-denominator NaN exit."""
    exact = gamma == 0
    beta = torch.where(c.fresh | exact, 0.0, gamma / c.gamma_old)
    denom = torch.where(c.fresh, delta, delta - beta * gamma / c.alpha_old)
    safe = torch.where(denom == 0, 1.0, denom)
    alpha = torch.where(denom == 0, float("nan"), gamma / safe)
    return torch.where(exact, 0.0, alpha), beta


def _pipe_cg_body(ctx: _Ctx, c: PipeCarry) -> PipeCarry:
    """One Chronopoulos–Gear step: one SpMV and ONE psum of the stacked
    (γ, δ) = (r·r, r·Ar); γ is the pre-update ‖r_k‖², recorded and tested
    with no other collective."""
    live = c.live
    s = ctx.apply(c.r)
    pair = _pstack(ctx.group, (c.r, c.r), (c.r, s))
    gamma, delta = pair[0], pair[1]
    put_hist(c.hist, c.k, live, gamma)
    done = torch.isnan(gamma) | (torch.sqrt(gamma) <= ctx.tol)
    alpha, beta = _pipe_alpha_beta(gamma, delta, c)
    p = [r + _scaled(beta, p) for r, p in zip(c.r, c.p)]
    q = [si + _scaled(beta, q) for si, q in zip(s, c.q)]
    x = [_axpy(x, alpha, p) for x, p in zip(c.x, p)]
    r = [_axpy(r, -alpha, q) for r, q in zip(c.r, q)]
    return PipeCarry(
        k=c.k + live.to(torch.int32), done=torch.where(live, done, c.done),
        fresh=c.fresh & ~live, x=_keep(live, x, c.x), r=_keep(live, r, c.r),
        p=_keep(live, p, c.p), q=_keep(live, q, c.q),
        gamma_old=torch.where(live, gamma, c.gamma_old),
        alpha_old=torch.where(live, alpha, c.alpha_old),
        rnorm=torch.where(live, gamma, c.rnorm), rho=c.rho, hist=c.hist)


def _pipe_pcg_body(ctx: _Ctx, c: PipeCarry) -> PipeCarry:
    """One Ghysels–Vanroose step: two SpMVs' worth of recurrences on one
    SpMV (A·M⁻¹w) and ONE psum of the stacked (γ, δ, ‖r‖²) = (r·u, w·u,
    r·r)."""
    live = c.live
    trip = _pstack(ctx.group, (c.r, c.u), (c.w, c.u), (c.r, c.r))
    gamma, delta, rr = trip[0], trip[1], trip[2]
    put_hist(c.hist, c.k, live, rr)
    done = torch.isnan(rr) | (torch.sqrt(rr) <= ctx.tol)
    m = _precond(ctx.precond, c.w)
    nu = ctx.apply(m)
    alpha, beta = _pipe_alpha_beta(gamma, delta, c)
    z = [a + _scaled(beta, v) for a, v in zip(nu, c.z)]
    q = [a + _scaled(beta, v) for a, v in zip(m, c.q)]
    s = [a + _scaled(beta, v) for a, v in zip(c.w, c.s)]
    p = [a + _scaled(beta, v) for a, v in zip(c.u, c.p)]
    x = [_axpy(a, alpha, v) for a, v in zip(c.x, p)]
    r = [_axpy(a, -alpha, v) for a, v in zip(c.r, s)]
    u = [_axpy(a, -alpha, v) for a, v in zip(c.u, q)]
    w = [_axpy(a, -alpha, v) for a, v in zip(c.w, z)]
    keep = lambda new, old: _keep(live, new, old)  # noqa: E731
    return PipeCarry(
        k=c.k + live.to(torch.int32), done=torch.where(live, done, c.done),
        fresh=c.fresh & ~live, x=keep(x, c.x), r=keep(r, c.r), p=keep(p, c.p),
        q=keep(q, c.q), u=keep(u, c.u), w=keep(w, c.w), z=keep(z, c.z), s=keep(s, c.s),
        gamma_old=torch.where(live, gamma, c.gamma_old),
        alpha_old=torch.where(live, alpha, c.alpha_old),
        rnorm=torch.where(live, rr, c.rnorm), rho=torch.where(live, gamma, c.rho),
        hist=c.hist)


def _pipe_replace(ctx: _Ctx, c: PipeCarry, every: int) -> PipeCarry:
    """Residual replacement (the JAX loops' masked no-op convention, no
    ``k < maxiter`` term): the true r (and u = M⁻¹r, w = A·u under GV) from
    x, every direction recurrence reset, ‖r‖² (and ρ = r·u) replaced."""
    mask = (~c.done) & (c.k % every == 0)
    r_t = ctx.residual(c.x)

    def zero(vs):
        return None if vs is None else [torch.where(mask, 0.0, v).to(v.dtype) for v in vs]

    if c.u is None:
        rnorm_t = _pdot(ctx.group, r_t, r_t)
        u = w = None
        rho = c.rho
    else:
        u_t = _precond(ctx.precond, r_t)
        w_t = ctx.apply(u_t)
        pair = _pstack(ctx.group, (r_t, r_t), (r_t, u_t))
        rnorm_t = pair[0]
        u, w = _keep(mask, u_t, c.u), _keep(mask, w_t, c.w)
        rho = torch.where(mask, pair[1], c.rho)
    put_hist(c.hist, c.k, mask, rnorm_t)
    return dataclasses.replace(
        c, fresh=c.fresh | mask, r=_keep(mask, r_t, c.r), p=zero(c.p), q=zero(c.q),
        z=zero(c.z), s=zero(c.s), u=u, w=w, rnorm=torch.where(mask, rnorm_t, c.rnorm),
        rho=rho)


def _sharded_pipelined(group, apply: LocalMatvec, b: Vecs, x0: Vecs, precond: Precond,
                       tol: float, maxiter: int, recompute_r_every: int = 0):
    """Single-sync CG per shard: ONE psum per iteration instead of standard
    CG's two rounds.  Chronopoulos–Gear without a preconditioner, the
    Ghysels–Vanroose recurrences with one (Jacobi or ``M_local``).
    ``recompute_r_every`` is the residual-replacement full restart, which
    the O(eps·κ) drift of the pipelined recurrences needs on long float32
    runs (solver/pipelined.py).  One more psum after the loop records the
    final residual."""
    ctx = _ctx(group, apply, b, precond, tol)
    r0 = ctx.residual(x0)
    rnorm0 = _pdot(group, r0, r0)
    dev = rnorm0.device
    zerov = [torch.zeros_like(r) for r in r0]
    one = torch.ones_like(rnorm0)
    common = dict(k=_zero_i32(dev), done=_false(dev),
                  fresh=torch.ones((), dtype=torch.bool, device=dev), x=list(x0), r=r0,
                  p=zerov, q=zerov, hist=_hist(maxiter, rnorm0), rnorm=rnorm0)
    if precond is None:
        body = _pipe_cg_body
        c0 = PipeCarry(gamma_old=rnorm0, alpha_old=one, rho=rnorm0, **common)
    else:
        body = _pipe_pcg_body
        u0 = _precond(precond, r0)
        c0 = PipeCarry(gamma_old=one, alpha_old=one, rho=one, u=u0, w=apply(u0),
                       z=zerov, s=zerov, **common)
    box = [c0]

    def step():
        box[0] = body(ctx, box[0])

    def replace():
        box[0] = _pipe_replace(ctx, box[0], recompute_r_every)

    run_chunked(step, lambda: box[0].live, maxiter, recompute_r_every, replace,
                done=lambda: box[0].done)
    c = box[0]
    rnorm_final = _pdot(group, c.r, c.r)
    put_hist(c.hist, c.k, torch.ones_like(c.done), rnorm_final)
    rho = rnorm_final if precond is None else c.rho
    return c.x, c.k, c.done, rho, rnorm_final, c.hist


# ---- s-step CG ---------------------------------------------------------------------

def _sharded_sstep_cg(group, apply: LocalMatvec, b: Vecs, x0: Vecs, tol: float,
                      maxiter: int, s: int, rcond: float, basis_fn=None):
    """s-step (communication-avoiding) CG per shard on the shared loop
    (``solver/sstep.make_sstep_loop``): ONE psum, of the (3s+1)² Gram, per
    s iterations.  The loop sees the owned shards as one vector (their rows
    one after another); the Gram is one partial per shard, summed in the
    group's order.  ``basis_fn`` (the DIA matrix-powers kernel) replaces
    the matvec-at-a-time basis."""
    n_own, m = len(b), b[0].numel()

    def split(v):
        return [v[i * m:(i + 1) * m] for i in range(n_own)]

    def matvec(v):
        return torch.cat(apply(split(v)))

    def gram(U):
        return group.psum([U[:, i * m:(i + 1) * m] @ U[:, i * m:(i + 1) * m].T
                           for i in range(n_own)])

    tol_arr = torch.as_tensor(tol, dtype=b[0].dtype, device=group.device)
    x, k, done, rnorm, hist = make_sstep_loop(
        matvec, None, torch.cat(b), torch.cat(x0), s=s, tol_arr=tol_arr, maxiter=maxiter,
        rcond=rcond, basis_fn=basis_fn, gram_fn=gram)
    return split(x), k, done, rnorm, rnorm, hist


# ---- BiCGStab ------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BicgCarry:
    k: torch.Tensor
    done: torch.Tensor
    broke: torch.Tensor
    x: Vecs
    r: Vecs
    p: Vecs
    v: Vecs
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    rnorm_sq: torch.Tensor
    hist: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (self.k < self.hist.numel() - 1)


def _sharded_bicgstab(group, apply: LocalMatvec, b: Vecs, x0: Vecs, precond: Precond,
                      tol: float, maxiter: int):
    """Per-shard BiCGStab for NONSYMMETRIC systems: two SpMVs and three
    psum rounds an iteration (ρ = r̂·r; r̂·v; one stacked (t·s, t·t, s·s)).
    The full step's ‖r‖² comes from the stacked sums, s·s − (t·s)²/t·t,
    with no fourth round.  M need not be SPD.  Breakdowns (ρ → 0, r̂ᵀv → 0,
    ω → 0, NaN) keep the last finite iterate and report ``converged=False``
    through a NaN rnorm.  Squared norms throughout."""
    ctx = _ctx(group, apply, b, precond, tol)
    r0 = ctx.residual(x0)
    rnorm0 = _pdot(group, r0, r0)
    sdt, dev = rnorm0.dtype, rnorm0.device
    tol_sq = (ctx.tol * ctx.tol).to(sdt)
    one = torch.ones((), dtype=sdt, device=dev)
    zerov = [torch.zeros_like(bi) for bi in b]
    box = [BicgCarry(k=_zero_i32(dev), done=torch.isnan(rnorm0) | (rnorm0 <= tol_sq),
                     broke=torch.isnan(rnorm0), x=list(x0), r=r0, p=zerov, v=zerov, rho=one,
                     alpha=one, omega=one, rnorm_sq=rnorm0, hist=_hist(maxiter, rnorm0))]

    def step():
        c = box[0]
        live = c.live
        rho = _pdot(group, r0, c.r)  # r̂₀ = r₀
        beta = (rho / c.rho) * (c.alpha / c.omega)
        pn = [_axpy(r, beta, (p.to(sdt) - c.omega * v.to(sdt))) for r, p, v in zip(c.r, c.p, c.v)]
        phat = [t.to(r.dtype) for t, r in zip(_precond(precond, pn), c.r)]
        vn = apply(phat)
        alpha = rho / _pdot(group, r0, vn)
        sv = [_axpy(r, -alpha, v) for r, v in zip(c.r, vn)]
        x_half = [_axpy(x, alpha, p) for x, p in zip(c.x, phat)]
        shat = [t.to(r.dtype) for t, r in zip(_precond(precond, sv), c.r)]
        t = apply(shat)
        trip = _pstack(group, (t, sv), (t, t), (sv, sv))
        t_s, t_t, s_s = trip[0], trip[1], trip[2]
        half_done = s_s <= tol_sq
        omega = t_s / t_t
        x_full = [_axpy(x, omega, sh) for x, sh in zip(x_half, shat)]
        r_full = [_axpy(si, -omega, ti) for si, ti in zip(sv, t)]
        rfull_sq = torch.clamp_min(s_s - t_s * t_s / t_t, 0.0)
        finite = (torch.isfinite(beta) & torch.isfinite(alpha) & torch.isfinite(omega)
                  & torch.isfinite(rfull_sq))
        broke = ~finite & ~half_done
        rnorm_new = torch.where(half_done, s_s, rfull_sq)
        conv = half_done | (finite & (rfull_sq <= tol_sq))
        broke = broke | (finite & ((omega == 0) | (rho == 0)) & ~conv)
        take_x = live & ~broke
        hold = ~live | broke | half_done
        xn = [torch.where(half_done, h, f) for h, f in zip(x_half, x_full)]
        rn = [torch.where(half_done, h, f) for h, f in zip(sv, r_full)]
        rnorm_n = torch.where(broke, c.rnorm_sq, rnorm_new)
        k = c.k + live.to(torch.int32)
        put_hist(c.hist, k, live, rnorm_n)
        box[0] = BicgCarry(
            k=k, done=torch.where(live, conv | broke, c.done),
            broke=torch.where(live, broke, c.broke), x=_keep(take_x, xn, c.x),
            r=_keep(take_x, rn, c.r), p=_keep(~hold, pn, c.p), v=_keep(~hold, vn, c.v),
            rho=torch.where(take_x, rho, c.rho), alpha=torch.where(take_x, alpha, c.alpha),
            omega=torch.where(take_x, omega, c.omega),
            rnorm_sq=torch.where(live, rnorm_n, c.rnorm_sq), hist=c.hist)

    run_chunked(step, lambda: box[0].live, maxiter, done=lambda: box[0].done)
    c = box[0]
    rho_out = torch.where(c.broke, torch.full_like(c.rnorm_sq, float("nan")), c.rnorm_sq)
    return c.x, c.k, c.done, rho_out, rho_out, c.hist


# ---- GMRES(m) -----------------------------------------------------------------------

class _ShardedGmres:
    """The outer carry (k, done, broke, x, ‖r‖², hist) and one cycle's
    row-sharded basis, Hessenberg columns, rotations and flags: the mesh
    composition of solver/gmres.py, with the JAX sharded loop's squared
    norms and scalar forms."""

    def __init__(self, ctx: _Ctx, x0: Vecs, maxiter: int, m: int, flexible: bool):
        self.ctx, self.maxiter, self.m, self.flexible = ctx, maxiter, m, flexible
        g = ctx.group
        self.vdt = ctx.b[0].dtype
        self.x = list(x0)
        r0 = ctx.residual(self.x)
        self.rnorm_sq = _pdot(g, r0, r0)
        self.sdt = self.rnorm_sq.dtype
        self.dev = self.rnorm_sq.device
        self.tol_sq = (ctx.tol * ctx.tol).to(self.sdt)
        # slot maxiter + 1 absorbs masked writes; trimmed on return
        self.hist = _hist(maxiter, self.rnorm_sq, extra=1)
        self.k = _zero_i32(self.dev)
        self.broke = torch.isnan(self.rnorm_sq)
        self.done = self.broke | (self.rnorm_sq <= self.tol_sq)

    def finished(self) -> torch.Tensor:
        return self.done | (self.k >= self.maxiter)

    def stopped(self) -> torch.Tensor:
        return self.idone | (self.k + self.jused >= self.maxiter)

    def start_cycle(self) -> None:
        m, sdt, vdt, dev = self.m, self.sdt, self.vdt, self.dev
        self.live = ~self.finished()
        r = self.ctx.residual(self.x)
        beta = torch.sqrt(_pdot(self.ctx.group, r, r))
        self.V, self.Z = [], []
        for ri in r:
            v0 = torch.where(beta > 0, (ri.to(sdt) / beta).to(vdt), torch.zeros_like(ri))
            V = torch.zeros((m + 1, ri.numel()), dtype=vdt, device=dev)
            V[0] = v0
            self.V.append(V)
            self.Z.append(torch.zeros((m if self.flexible else 1, ri.numel()), dtype=vdt,
                                      device=dev))
        self.R = torch.zeros((m + 1, m), dtype=sdt, device=dev)
        self.g = torch.zeros(m + 1, dtype=sdt, device=dev)
        self.g[0] = beta
        self.cs = torch.ones(m, dtype=sdt, device=dev)
        self.sn = torch.zeros(m, dtype=sdt, device=dev)
        self.idone = ~self.live
        self.ibroke = _false(dev)
        self.jused = _zero_i32(dev)

    def step(self, j: int) -> None:
        """Arnoldi step j: z = M⁻¹v_j, w = A z, CGS2 with psum'd
        projections against the j + 2 live basis rows (the rows past them
        are zero), the previous rotations on the new column, then the new
        rotation and the Givens estimate²."""
        g, m, sdt, vdt = self.ctx.group, self.m, self.sdt, self.vdt
        active = ~self.idone & (self.k + j < self.maxiter)
        z = [t.to(vdt) for t in _precond(self.ctx.precond, [V[j] for V in self.V])]
        if self.flexible:
            for Z, zi in zip(self.Z, z):
                Z[j] = torch.where(active, zi, Z[j])
        w = [t.to(vdt) for t in self.ctx.apply(z)]
        Va = [V[: j + 2].to(sdt) for V in self.V]
        wa = [t.to(sdt) for t in w]
        h1 = g.psum([va @ t for va, t in zip(Va, wa)])
        w1 = [t - va.T @ h1 for va, t in zip(Va, wa)]
        h2 = g.psum([va @ t for va, t in zip(Va, w1)])
        w2 = [t - va.T @ h2 for va, t in zip(Va, w1)]
        h = h1 + h2
        hsub = torch.sqrt(g.psum([torch.sum(t * t) for t in w2]))
        for V, t in zip(self.V, w2):
            vnext = torch.where(hsub > 0, t / hsub, torch.zeros_like(t))
            V[j + 1] = torch.where(active, vnext.to(vdt), V[j + 1])

        col = torch.zeros(m + 1, dtype=sdt, device=self.dev)
        col[: j + 2] = h
        col[j + 1] = hsub
        for i in range(j):  # the previous rotations, in order
            a0, a1 = col[i].clone(), col[i + 1].clone()
            col[i] = self.cs[i] * a0 + self.sn[i] * a1
            col[i + 1] = -self.sn[i] * a0 + self.cs[i] * a1
        a0, a1 = col[j].clone(), col[j + 1].clone()
        denom = torch.sqrt(a0 * a0 + a1 * a1)
        ok = denom > 0
        csj = torch.where(ok, a0 / denom, 1.0)
        snj = torch.where(ok, a1 / denom, 0.0)
        col[j] = denom
        col[j + 1] = 0.0
        gj = self.g[j]
        g_new = self.g.clone()
        g_new[j] = csj * gj
        g_new[j + 1] = -snj * gj
        est_sq = g_new[j + 1] * g_new[j + 1]

        self.R[:, j] = torch.where(active, col, self.R[:, j])
        self.cs[j] = torch.where(active, csj, self.cs[j])
        self.sn[j] = torch.where(active, snj, self.sn[j])
        self.g = torch.where(active, g_new, self.g)

        nonfinite = ~torch.isfinite(est_sq)
        step_done = active & (nonfinite | (est_sq <= self.tol_sq))
        self.jused = self.jused + active.to(torch.int32)
        idx = torch.where(active, self.k + self.jused, self.maxiter + 1)
        self.hist.index_put_((idx.long().reshape(1),), est_sq.reshape(1))
        self.idone = self.idone | step_done
        self.ibroke = self.ibroke | (active & nonfinite)

    def end_cycle(self) -> None:
        """The small triangular solve on the leading jused columns, the
        update, and the TRUE-residual restart that decides the solve."""
        m, sdt, vdt, dev = self.m, self.sdt, self.vdt, self.dev
        valid = torch.arange(m, device=dev) < self.jused
        Rm = torch.where(valid[None, :], self.R[:m, :m], torch.eye(m, dtype=sdt, device=dev))
        gm = torch.where(valid, self.g[:m], torch.zeros((), dtype=sdt, device=dev))
        y = torch.linalg.solve_triangular(Rm, gm[:, None], upper=True)[:, 0]
        if self.flexible:
            dx = [(Z.to(sdt).T @ y).to(vdt) for Z in self.Z]  # FGMRES: x += Zᵀ y
        else:
            zc = [(V[:m].to(sdt).T @ y).to(vdt) for V in self.V]
            dx = [t.to(vdt) for t in _precond(self.ctx.precond, zc)]
        x_new = [(x + d).to(x.dtype) for x, d in zip(self.x, dx)]
        r_new = self.ctx.residual(x_new)
        rnew_sq = _pdot(self.ctx.group, r_new, r_new)
        finite = torch.isfinite(rnew_sq) & ~self.ibroke
        take = self.live & finite
        self.x = _keep(take, x_new, self.x)
        self.rnorm_sq = torch.where(take, rnew_sq, self.rnorm_sq)
        self.k = self.k + self.jused
        idx = torch.where(take, self.k, self.maxiter + 1)
        self.hist.index_put_((idx.long().reshape(1),), rnew_sq.reshape(1))
        broke = self.broke | ~finite
        done = broke | (self.rnorm_sq <= self.tol_sq) | (self.jused == 0)
        self.broke = torch.where(self.live, broke, self.broke)
        self.done = torch.where(self.live, done, self.done)
        del self.V, self.Z  # the basis is a cycle's: free it before the next


def _sharded_gmres(group, apply: LocalMatvec, b: Vecs, x0: Vecs, precond: Precond,
                   tol: float, maxiter: int, m: int, flexible: bool = False):
    """Per-shard GMRES(m) for NONSYMMETRIC systems: the Krylov basis is
    row-sharded like every other vector, so CGS2's products run shard-local
    and reduce with (j+2,)-payload psums.  Per inner step one SpMV and
    three psums (the two projections and the new vector's norm); per cycle
    one more SpMV and psum for the TRUE residual.  The preconditioner is
    applied on the RIGHT, so the observed residual is the true one;
    ``flexible=True`` is FGMRES (required when ``M_local`` is not one fixed
    linear operator).  Squared norms: hist holds the Givens estimates²,
    each cycle boundary the recomputed true norm²."""
    ctx = _ctx(group, apply, b, precond, tol)
    st = _ShardedGmres(ctx, x0, maxiter, m, bool(flexible))
    cycles = _DonePoll(st.finished)
    while not cycles.finished():
        st.start_cycle()
        steps = _DonePoll(st.stopped)
        for j in range(m):
            if steps.finished():
                break
            st.step(j)
            steps.push()
        st.end_cycle()
        cycles.push()
    rho_out = torch.where(st.broke, torch.full_like(st.rnorm_sq, float("nan")), st.rnorm_sq)
    return st.x, st.k, st.done, rho_out, rho_out, st.hist[: maxiter + 1]


# ---- deflated (P)CG ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeflCarry:
    k: torch.Tensor
    done: torch.Tensor
    x: Vecs
    r: Vecs
    p: Vecs
    rho: torch.Tensor
    rnorm: torch.Tensor
    hist: torch.Tensor
    x_best: Vecs
    rnorm_min: torch.Tensor
    divg: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        return (~self.done) & (~self.divg) & (self.k < self.hist.numel() - 1)


def _sharded_deflated_pcg(group, apply: LocalMatvec, b: Vecs, x0: Vecs, precond: Precond,
                          W: Vecs, AW: Vecs, E_chol: torch.Tensor, tol: float, maxiter: int):
    """Deflated (P)CG per shard (solver/deflated.py's core): directions kept
    A-orthogonal to the row-sharded basis ``W`` through the projector, whose
    (AW)ᵀz products are summed over the shards — ONE extra (k,)-payload psum
    an iteration — and whose k×k Cholesky solve is replicated.  The same
    divergence guard and best-iterate return as the one-device loop."""
    ctx = _ctx(group, apply, b, precond, tol)

    def solve_E(y):
        return torch.cholesky_solve(y[:, None], E_chol, upper=False)[:, 0]

    def project(z):
        mu = solve_E(group.psum([aw.T @ zi for aw, zi in zip(AW, z)]))
        return [zi - w @ mu for w, zi in zip(W, z)]

    # Galerkin initial correction (Wᵀ r₀ = 0)
    r = ctx.residual(x0)
    mu = solve_E(group.psum([w.T @ ri for w, ri in zip(W, r)]))
    x = [xi + w @ mu for xi, w in zip(x0, W)]
    r = [ri - aw @ mu for ri, aw in zip(r, AW)]
    z = _precond(precond, r)
    rnorm0 = _pdot(group, r, r)
    rho0 = rnorm0 if precond is None else _pdot(group, r, z)
    dev = rnorm0.device
    box = [DeflCarry(k=_zero_i32(dev), done=_false(dev), x=x, r=r, p=project(z), rho=rho0,
                     rnorm=rnorm0, hist=_hist(maxiter, rnorm0), x_best=x, rnorm_min=rnorm0,
                     divg=_false(dev))]

    def step():
        c = box[0]
        live = c.live
        q = apply(c.p)
        pap = _pdot(group, c.p, q)
        exact = c.rho == 0
        alpha = torch.where(exact, 0, c.rho / torch.where(exact, 1, pap))
        x = [(xi + alpha * p).to(xi.dtype) for xi, p in zip(c.x, c.p)]
        r = [(ri - alpha * qi).to(ri.dtype) for ri, qi in zip(c.r, q)]
        tol_met = torch.sqrt(c.rnorm) <= ctx.tol
        diverged = (c.rnorm > 1e6 * c.rnorm_min) & ~tol_met
        done = torch.isnan(c.rnorm) | tol_met
        z = _precond(precond, r)
        rnorm_next = _pdot(group, r, r)
        rho_next = rnorm_next if precond is None else _pdot(group, r, z)
        beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, c.rho))
        p = [(pz + beta * p).to(p.dtype) for pz, p in zip(project(z), c.p)]
        k = c.k + live.to(torch.int32)
        put_hist(c.hist, k, live, rnorm_next)
        better = live & (rnorm_next < c.rnorm_min)
        box[0] = DeflCarry(
            k=k, done=torch.where(live, done, c.done), x=_keep(live, x, c.x),
            r=_keep(live, r, c.r), p=_keep(live, p, c.p), rho=torch.where(live, rho_next, c.rho),
            rnorm=torch.where(live, rnorm_next, c.rnorm), hist=c.hist,
            x_best=_keep(better, x, c.x_best),
            rnorm_min=torch.where(better, rnorm_next, c.rnorm_min),
            divg=c.divg | (live & diverged))

    run_chunked(step, lambda: box[0].live, maxiter,
                done=lambda: box[0].done | box[0].divg)
    c = box[0]
    use_best = c.rnorm_min < c.rnorm
    x = _keep(use_best, c.x_best, c.x)
    rnorm = torch.where(use_best, c.rnorm_min, c.rnorm)
    # a diverged exit reports converged=False downstream
    return x, c.k, c.done & ~c.divg, c.rho, rnorm, c.hist


# ---- fused (P)CG ----------------------------------------------------------------

def _views(buf: torch.Tensor, n_local: int, bn: int) -> Vecs:
    """``buf``'s shards as (m / bn, bn) views, one per owned shard."""
    m = buf.numel() // n_local
    return [buf[i * m:(i + 1) * m].view(m // bn, bn) for i in range(n_local)]


def _joined_f32(vs: Vecs, bn: int) -> Vecs:
    """The vectors copied into one float32 buffer, as its views."""
    return _views(torch.cat([v.reshape(-1) for v in vs]).to(torch.float32), len(vs), bn)


def _sharded_fused_cg(group, blocks: Vecs, cols: Vecs, b: Vecs, x0: Vecs,
                      tol: float, maxiter: int, bn: int,
                      inv_diag: Optional[Vecs] = None):
    """Per-shard (P)CG on the fused kernels, float32 vectors on float32 or
    bfloat16 tiles (kernel 6's bf16 form): each shard's SpMV and
    p·q partial as one kernel on the gathered operand (``bell_spmv_dot``),
    its x/r update and ‖r‖² (+ ρ = r·d⊙r) partials as another
    (``fused_update_dot(_pcg)`` in partials-only mode), the partials summed
    over the shards.  One gather and two psum rounds per iteration (three
    with Jacobi).  The direction update p = z + β·p runs before the gather,
    as torch ops (in the JAX loop at the end of the body; here at the start
    of the next, with β = 0 and p = 0 on entry, so the first p is z₀); x and
    r are updated in place."""
    n_local = len(b)
    m = b[0].numel()
    dev = group.device
    offsets = [group.row_offset(s, m) for s in group.shards]
    x = _joined_f32(x0, bn)
    r = _joined_f32(b, bn)
    d = None if inv_diag is None else _joined_f32(inv_diag, bn)
    p = _views(torch.zeros(n_local * m, dtype=torch.float32, device=dev), n_local, bn)
    q = _views(torch.empty(n_local * m, dtype=torch.float32, device=dev), n_local, bn)
    paps = [torch.empty(1, 1, dtype=torch.float32, device=dev) for _ in range(n_local)]

    def spmv_dot(vs, work):
        full = group.all_gather(vs).view(-1, bn)
        for i in range(n_local):
            bell_spmv_dot(blocks[i], cols[i], full, offsets[i], out=(q[i], paps[i]),
                          work=work)
        return group.psum(paps)

    # r0 = b − A·x0 through the same kernel (its dot unused), on a work that
    # is always live: a solve capped at 0 steps still reports its residual
    spmv_dot(x, FusedWork.new(dev))
    for ri, qi in zip(r, q):
        ri.sub_(qi)
    rnorm0 = group.psum([torch.sum(ri * ri) for ri in r])
    rho0 = rnorm0 if d is None else group.psum(
        [torch.sum(ri * (di * ri)) for ri, di in zip(r, d)])
    work = FusedWork.new(dev, maxiter=maxiter, tol=tol)
    work.scal[S_RHO] = rho0
    work.scal[S_RNORM] = rnorm0
    work.hist[0] = rnorm0
    beta = work.scal[S_BETA]

    def step():
        for i in range(n_local):
            z = r[i] if d is None else d[i] * r[i]
            torch.add(z, p[i] * beta, out=p[i])
        finish_dir(work, spmv_dot(p, work)[0, 0])
        if d is None:
            rns = [fused_update_dot(x[i], p[i], r[i], q[i], work.alpha, out=(x[i], r[i]),
                                    work=work, partials_only=True)[2]
                   for i in range(n_local)]
            rn = group.psum(rns)[0, 0]
            rz = rn
        else:
            outs = [fused_update_dot_pcg(x[i], p[i], r[i], q[i], d[i], work.alpha,
                                         out=(x[i], r[i]), work=work, partials_only=True)
                    for i in range(n_local)]
            rn = group.psum([o[2] for o in outs])[0, 0]
            rz = group.psum([o[3] for o in outs])[0, 0]
        finish_update(work, rn, rz)

    run_chunked(step, lambda: work.ctl[C_LIVE], maxiter, done=lambda: work.ctl[C_DONE])
    x_out = [xi.reshape(-1) for xi in x]
    return (x_out, work.ctl[C_K].clone(), work.ctl[C_DONE].bool(),
            work.scal[S_RHO].clone(), work.scal[S_RNORM].clone(), work.hist)


# ---- fused MINRES ---------------------------------------------------------------

def _sharded_fused_minres(group, blocks: Vecs, cols: Vecs, b: Vecs, x0: Vecs,
                          tol: float, maxiter: int, bn: int,
                          inv_diag: Optional[Vecs] = None):
    """Per-shard MINRES on the fused kernels, float32 vectors on float32 or
    bfloat16 tiles: each shard's pending w/x update, SpMV on the gathered v
    and the v·q, v·r1 partials as one kernel (``minres_shard_spmv_dot``),
    the Lanczos projections and the β² partial as another
    (``minres_update_dot`` in partials-only mode).  One
    gather and two psum rounds per iteration (the stacked (v·q, v·r1) and
    β²).  Same semantics as :func:`_sharded_minres`.

    v = (d⊙r2)·(1/β) is formed before the gather (torch ops), into the v
    buffer that is not v_prev; x is updated in place, w_new over w₋₂'s
    buffer and r2' over r1's, after which the w, r and v buffers trade names.
    A step after the end changes nothing: the kernels return at once, v is
    masked, and :func:`_settle` undoes the trades of the dead steps."""
    n_local = len(b)
    m = b[0].numel()
    dev = group.device
    f32 = dict(dtype=torch.float32, device=dev)
    offsets = [group.row_offset(s, m) for s in group.shards]

    def zeros():
        return _views(torch.zeros(n_local * m, **f32), n_local, bn)

    x = _joined_f32(x0, bn)
    d = None if inv_diag is None else _joined_f32(inv_diag, bn)
    q, wa, wb, va, vb = zeros(), zeros(), zeros(), zeros(), zeros()
    dots = torch.empty(n_local, 2, **f32)

    def gather(vs):
        return group.all_gather(vs).view(-1, bn)

    # r0 = b − A·x0 through the same kernel: su = 0 makes its pending update
    # a no-op on zero vectors, on a work that is always live
    init_work = fm.MinresWork.new(dev)
    z = zeros()
    full = gather(x)
    for i in range(n_local):
        fm.minres_shard_spmv_dot(blocks[i], cols[i], full, z[i], z[i], z[i], z[i], z[i],
                                 init_work.su, offsets[i], out=(q[i], wa[i], wb[i], dots[i]),
                                 work=init_work)
    r2 = _views(torch.cat([bi.reshape(-1) for bi in b]).to(torch.float32), n_local, bn)
    for ri, qi in zip(r2, q):
        ri.sub_(qi)
    r1 = _views(torch.cat([ri.reshape(-1) for ri in r2]), n_local, bn)
    y0 = r2 if d is None else [di * ri for di, ri in zip(d, r2)]
    beta1 = torch.sqrt(group.psum([torch.sum(ri * yi) for ri, yi in zip(r2, y0)]))
    work = fm.MinresWork.new(dev, maxiter=maxiter, tol=tol)
    work.start(beta1)
    st = _FusedMinresBuffers(x=x, r1=r1, r2=r2, vprev=va, vnext=vb, wm1=wa, wm2=wb)

    def step():
        live = work.ctl[C_LIVE] != 0
        inv_beta = work.scal[fm.SU_INV_BETA]
        for i in range(n_local):
            z_i = st.r2[i] if d is None else d[i] * st.r2[i]
            torch.where(live, z_i * inv_beta, st.vprev[i], out=st.vnext[i])
        full = gather(st.vnext)
        for i in range(n_local):
            fm.minres_shard_spmv_dot(
                blocks[i], cols[i], full, st.r1[i], st.vprev[i], st.wm1[i], st.wm2[i],
                st.x[i], work.su, offsets[i], out=(q[i], st.wm2[i], st.x[i], dots[i]),
                work=work)
        sums = group.psum([dots[i] for i in range(n_local)])
        fm.finish_dir(work, sums[0], sums[1])
        bsq = group.psum([
            fm.minres_update_dot(q[i], st.r1[i], st.r2[i], work.c1, work.ia,
                                 None if d is None else d[i], out=st.r1[i], work=work,
                                 partials_only=True)[1]
            for i in range(n_local)])[0, 0]
        fm.finish_update(work, bsq)
        st.trade()

    run_chunked(step, lambda: work.ctl[C_LIVE], maxiter, done=lambda: work.ctl[C_DONE])
    _settle(st, work)
    # flush the pending update of the last iteration (a no-op at k = 0)
    su = work.scal
    x_out = [(xi + su[fm.SU_PHI] * ((vp - su[fm.SU_OLDEPS] * w2 - su[fm.SU_DELTA] * w1)
                                     * su[fm.SU_IGAMMA])).reshape(-1)
             for xi, vp, w1, w2 in zip(st.x, st.vprev, st.wm1, st.wm2)]
    phibar = work.scal[fm.M_PHIBAR]
    nan = work.ctl[fm.C_NAN].bool()
    rho = torch.where(nan, torch.full_like(phibar, float("nan")), phibar * phibar)
    # the work's history holds φ̄, the sharded solve reports φ̄²
    return (x_out, work.ctl[C_K].clone(), work.ctl[C_DONE].bool(), rho, rho.clone(),
            work.hist * work.hist)


@dataclasses.dataclass
class _FusedMinresBuffers:
    """The fused MINRES loop's vectors, one view per owned shard.
    ``launched`` counts the steps launched, live or not: each trades the
    names of the r, w and v buffers."""

    x: Vecs
    r1: Vecs
    r2: Vecs
    vprev: Vecs
    vnext: Vecs
    wm1: Vecs
    wm2: Vecs
    launched: int = 0

    def trade(self) -> None:
        self.r1, self.r2 = self.r2, self.r1
        self.wm1, self.wm2 = self.wm2, self.wm1
        self.vprev, self.vnext = self.vnext, self.vprev
        self.launched += 1


def _settle(st: _FusedMinresBuffers, work: fm.MinresWork) -> None:
    """Undo the name trades of the steps launched after the end (one host
    read of k).  Their v was masked to a copy of v_prev, so the v buffers
    hold the same vector and need no undo."""
    dead = st.launched - int(work.ctl[C_K])
    if dead % 2:
        st.r1, st.r2 = st.r2, st.r1
        st.wm1, st.wm2 = st.wm2, st.wm1
    st.launched -= dead


def _fused_shards_supported(blocks: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``use_fused="auto"`` takes the fused loops: the JAX gate
    (square tiles, bn and the rows per shard multiples of 128, float32 b,
    kmax <= 64; the tiles' dtype is not tested, so bf16 shards take the
    fused loops on the bf16 forms of kernels 6 and 17) with the operator on a CUDA
    device in place of its TPU-only terms (the VMEM byte cap on the
    gathered operand, a TPU backend)."""
    n_shards, _, kmax, bm, bn = blocks.shape
    m = b.shape[0] // n_shards
    return (bm == bn and bn % 128 == 0 and m % 128 == 0
            and b.dtype == torch.float32 and kmax <= 64 and blocks.is_cuda)


# ---- multi-RHS: lockstep (P)CG and block CG --------------------------------------

@dataclasses.dataclass(frozen=True)
class LaneCarry:
    """The multi-RHS carry: (m, R) slabs, per-lane (R,) scalars (ρ is the
    (R, R) Gram in block CG), the (maxiter + 1, R) history."""

    k: torch.Tensor
    done: torch.Tensor
    X: Vecs
    r: Vecs
    p: Vecs
    rho: torch.Tensor
    rnorm: torch.Tensor
    hist: torch.Tensor

    @property
    def live(self) -> torch.Tensor:
        """Per lane: not done and below the cap."""
        return (~self.done) & (self.k < self.hist.shape[0] - 1)


def _lane_dot(group, us: Vecs, vs: Vecs) -> torch.Tensor:
    """(R,) Σ over every shard of each lane's u·v (at least float32)."""
    def part(u, v):
        acc = torch.promote_types(u.dtype, torch.float32)
        return torch.sum(u.to(acc) * v.to(acc), dim=0)

    return group.psum([part(u, v) for u, v in zip(us, vs)])


def _gram(group, us: Vecs, vs: Vecs) -> torch.Tensor:
    """(R, R) Σ over every shard of uᵀv (at least float32)."""
    def part(u, v):
        acc = torch.promote_types(u.dtype, torch.float32)
        return u.to(acc).T @ v.to(acc)

    return group.psum([part(u, v) for u, v in zip(us, vs)])


def _lane_precond(pre, vs: Vecs) -> Vecs:
    """Jacobi (one (m,) diagonal per owned shard, shared by the lanes) or
    the identity."""
    if pre is None:
        return list(vs)
    return [d[:, None] * v for d, v in zip(pre, vs)]


def _put_lanes(hist: torch.Tensor, k: torch.Tensor, mask: torch.Tensor, new: torch.Tensor):
    """hist[k[j], j] = new[j] where ``mask``; the others keep their entry."""
    idx = (k.long(), torch.arange(k.shape[0], device=k.device))
    hist.index_put_(idx, torch.where(mask, new, hist[idx]))


def _lane_init(group, apply, B: Vecs, X0: Vecs, pre, maxiter: int, block: bool) -> LaneCarry:
    r0 = [b - ax for b, ax in zip(B, apply(X0))]
    z0 = _lane_precond(pre, r0)
    rnorm0 = _lane_dot(group, r0, r0)
    if block:
        rho0 = _gram(group, r0, z0)
    else:
        rho0 = rnorm0 if pre is None else _lane_dot(group, r0, z0)
    R, dev = rnorm0.shape[0], rnorm0.device
    hist = torch.full((maxiter + 1, R), float("nan"), dtype=rnorm0.dtype, device=dev)
    hist[0] = rnorm0
    return LaneCarry(k=torch.zeros(R, dtype=torch.int32, device=dev),
                     done=torch.zeros(R, dtype=torch.bool, device=dev),
                     X=list(X0), r=r0, p=z0, rho=rho0, rnorm=rnorm0, hist=hist)


def _lockstep_body(group, apply, pre, tol, c: LaneCarry) -> LaneCarry:
    """One lockstep iteration: per-lane α, β and pre-update termination,
    (R,) dots summed over the shards; lanes that are done or capped are
    frozen (their α is 0 and their p kept)."""
    active = c.live
    Q = apply(c.p)
    pap = _lane_dot(group, c.p, Q)
    exact = c.rho == 0
    alpha = torch.where(exact, 0, c.rho / torch.where(exact, 1, pap))
    am = torch.where(active, alpha, 0)
    X = [(x + am * p).to(x.dtype) for x, p in zip(c.X, c.p)]
    Rv = [(r - am * q).to(r.dtype) for r, q in zip(c.r, Q)]
    done_new = torch.isnan(c.rnorm) | (torch.sqrt(c.rnorm) <= tol)
    Z = _lane_precond(pre, Rv)
    rnorm_next = _lane_dot(group, Rv, Rv)
    rho_next = rnorm_next if pre is None else _lane_dot(group, Rv, Z)
    beta = torch.where(exact, 0, rho_next / torch.where(exact, 1, c.rho))
    P = [torch.where(active, (z + beta * p).to(p.dtype), p) for z, p in zip(Z, c.p)]
    k = torch.where(active, c.k + 1, c.k)
    _put_lanes(c.hist, k, active, rnorm_next)
    return LaneCarry(k=k, done=torch.where(active, done_new, c.done), X=X, r=Rv, p=P,
                     rho=torch.where(active, rho_next, c.rho),
                     rnorm=torch.where(active, rnorm_next, c.rnorm), hist=c.hist)


def _lockstep_replace(group, apply, B, pre, c: LaneCarry, every: int) -> LaneCarry:
    """Per-lane residual-replacement restart: only lanes that are not done
    and at a multiple of ``every`` restart, so frozen lanes keep their
    state exactly (no ``k < maxiter`` term, as the JAX loop)."""
    restart = (~c.done) & (c.k % every == 0)
    Rt = [b - ax for b, ax in zip(B, apply(c.X))]
    rnorm_t = _lane_dot(group, Rt, Rt)
    Zt = _lane_precond(pre, Rt)
    rho_t = rnorm_t if pre is None else _lane_dot(group, Rt, Zt)
    _put_lanes(c.hist, c.k, restart, rnorm_t)
    return LaneCarry(k=c.k, done=c.done, X=c.X, r=_keep(restart, Rt, c.r),
                     p=_keep(restart, Zt, c.p), rho=torch.where(restart, rho_t, c.rho),
                     rnorm=torch.where(restart, rnorm_t, c.rnorm), hist=c.hist)


def _block_body(group, apply, pre, tol, rcond: float, c: LaneCarry) -> LaneCarry:
    """One block-CG iteration (solver/blockcg.py's O'Leary recurrences):
    the (R, R) Gram blocks summed over the shards, the pseudo-solves on
    the summed blocks (once a process), the (m, R) × (R, R) updates local.
    Every lane moves while any is live (the shared space); after that the
    step is a no-op."""
    from ..solver.blockcg import _spd_pinv_apply

    active = c.live
    go = active.any()
    Q = apply(c.p)
    alpha = _spd_pinv_apply(_gram(group, c.p, Q), c.rho, rcond)
    X = [x + p @ alpha.to(p.dtype) for x, p in zip(c.X, c.p)]
    Rv = [r - q @ alpha.to(q.dtype) for r, q in zip(c.r, Q)]
    done_new = torch.isnan(c.rnorm) | (torch.sqrt(c.rnorm) <= tol)
    Z = _lane_precond(pre, Rv)
    rnorm_next = _lane_dot(group, Rv, Rv)
    rho_next = _gram(group, Rv, Z)
    beta = _spd_pinv_apply(c.rho, rho_next, rcond)
    P = [z + p @ beta.to(p.dtype) for z, p in zip(Z, c.p)]
    k = torch.where(active, c.k + 1, c.k)
    _put_lanes(c.hist, k, active, rnorm_next)
    return LaneCarry(k=k, done=torch.where(active, done_new, c.done),
                     X=_keep(go, X, c.X), r=_keep(go, Rv, c.r), p=_keep(go, P, c.p),
                     rho=torch.where(go, rho_next, c.rho),
                     rnorm=torch.where(go, rnorm_next, c.rnorm), hist=c.hist)


def _block_replace(group, apply, B, pre, c: LaneCarry, every: int) -> LaneCarry:
    """Full restart of the whole block (the shared space restarts as one)
    at block iterations that are multiples of ``every`` while a lane is
    live."""
    active = ~c.done
    fire = active.any() & (torch.max(torch.where(active, c.k, 0)) % every == 0)
    Rt = [b - ax for b, ax in zip(B, apply(c.X))]
    Zt = _lane_precond(pre, Rt)
    rnorm_t = _lane_dot(group, Rt, Rt)
    rho_t = _gram(group, Rt, Zt)
    _put_lanes(c.hist, c.k, fire & active, rnorm_t)
    return LaneCarry(k=c.k, done=c.done, X=c.X, r=_keep(fire, Rt, c.r),
                     p=_keep(fire, Zt, c.p), rho=torch.where(fire, rho_t, c.rho),
                     rnorm=torch.where(fire, rnorm_t, c.rnorm), hist=c.hist)


def _lane_loop(block: bool, group, apply, B: Vecs, X0: Vecs, pre, tol, maxiter: int,
               recompute_r_every: int = 0, rcond: float = 1e-10):
    full_precision_matmul()
    box = [_lane_init(group, apply, B, X0, pre, maxiter, block)]
    if block:
        body = lambda c: _block_body(group, apply, pre, tol, rcond, c)  # noqa: E731
        repl = _block_replace
    else:
        body = lambda c: _lockstep_body(group, apply, pre, tol, c)  # noqa: E731
        repl = _lockstep_replace

    def step():
        box[0] = body(box[0])

    def replace():
        box[0] = repl(group, apply, B, pre, box[0], recompute_r_every)

    def live():
        return box[0].live.any()

    run_chunked(step, live, maxiter, recompute_r_every, replace, done=lambda: ~live())
    c = box[0]
    rho = torch.diagonal(c.rho) if block else c.rho
    return c.X, c.k, c.done, rho, c.rnorm, c.hist.T


def _sharded_lockstep_pcg(group, apply: LocalMatvec, B: Vecs, X0: Vecs, precond, tol,
                          maxiter: int, recompute_r_every: int = 0):
    """Multi-RHS lockstep (P)CG per shard: solver/batched.py's lane-masked
    loop on the shards, per-lane residual replacement included.  ``B`` and
    ``X0``: each owned shard's (m, R) slab; ``precond``: None or the owned
    shards' (m,) Jacobi diagonals; ``tol``: a scalar or (R,) tensor."""
    return _lane_loop(False, group, apply, B, X0, precond, tol, maxiter, recompute_r_every)


def _sharded_block_cg(group, apply: LocalMatvec, B: Vecs, X0: Vecs, precond, tol,
                      maxiter: int, recompute_r_every: int = 0, rcond: float = 1e-10):
    """Block CG per shard (solver/blockcg.py): the same two sums over the
    shards an iteration as the lockstep loop, (R, R) payloads."""
    return _lane_loop(True, group, apply, B, X0, precond, tol, maxiter, recompute_r_every,
                      rcond)


def _batched_loop(method: str, recompute_r_every: int, rcond: float):
    """The multi-RHS loop of the sharded batched front ends."""
    if method == "block":
        return functools.partial(_sharded_block_cg, recompute_r_every=recompute_r_every,
                                 rcond=rcond)
    if method != "lockstep":
        raise ValueError(f"method must be 'lockstep' or 'block', got {method!r}")
    return functools.partial(_sharded_lockstep_pcg, recompute_r_every=recompute_r_every)
