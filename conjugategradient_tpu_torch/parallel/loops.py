"""The row-sharded loop cores.  Counterpart of the single-RHS blocked-ELL
part of ``conjugategradient_tpu/parallel/loops.py``: the portable (P)CG and
MINRES loops, the fused (P)CG and MINRES loops, and the fused path's gate.

The JAX package runs one loop body per shard inside ``shard_map``.  Here a
body is written as "for each shard this process owns: local work; then one
collective" against a shard group (``collectives.py``): ``group.all_gather``
for the SpMV operand and ``group.psum`` for the dots.  Vectors are lists with
one tensor per owned shard; scalars (α, β, ρ, ‖r‖², done, k, the history)
are one copy per process on its device, the same bits on every shard after
a psum, and are never read by the host inside the loop.

The loops run under ``solver/restart.run_chunked``.  A step after the end
is a no-op, so ``iterations`` and ``rho_history`` match the JAX
``while_loop``: the portable steps mask every field (as solver/cg.py does);
in the fused steps every kernel returns at once once the solve's ``live``
flag is 0, and the one-card scalar steps they call after each psum
(``ops/cuda/fused_cg.finish_update``, ``fused_minres.finish_update``) are
masked to a live solve.  Every loop here
passes its ``done`` flag, so at most ``LOOKAHEAD - 1`` steps follow it: a
step after the end still costs its host launches, several per shard (the
one-device fused loops, two launches a step, do not poll).

Semantics are those of solver/cg.py and solver/minres.py: recurrence
residual, Hestenes–Stiefel α/β, termination on the pre-update ‖r‖² against
an absolute tol, the ρ == 0 guard; MINRES's Paige–Saunders recurrence with
``rho_history`` holding φ̄² (the CGInfo convention of the JAX sharded loop).

Each loop returns ``(x, k, done, rho, rnorm, hist)`` with ``x`` one tensor
per owned shard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from ..ops.blas import dot
from ..ops.cuda.fused_cg import (C_DONE, C_K, C_LIVE, S_BETA, S_RHO, S_RNORM, FusedWork,
                                 bell_spmv_dot, finish_dir, finish_update, fused_update_dot,
                                 fused_update_dot_pcg, put_hist)
from ..ops.cuda import fused_minres as fm
from ..solver.restart import run_chunked

Vecs = List[torch.Tensor]
#: local_matvec(i, v_full) -> A_i v: the i-th OWNED shard's rows of A times
#: the all-gathered operand (flat)
LocalMatvec = Callable[[int, torch.Tensor], torch.Tensor]


def _precond(inv_diag: Optional[Vecs], vs: Vecs) -> Vecs:
    """The per-shard preconditioner on every owned shard: None = identity,
    (m,) tensors = Jacobi scaling."""
    return list(vs) if inv_diag is None else [d * v for d, v in zip(inv_diag, vs)]


def _pdot(group, us: Vecs, vs: Vecs) -> torch.Tensor:
    """Σ over every shard of u·v (float32 accumulation at least)."""
    return group.psum([dot(u, v) for u, v in zip(us, vs)])


@dataclasses.dataclass(frozen=True)
class _Ctx:
    """What a portable body needs besides its carry."""

    group: object
    matvec: LocalMatvec
    b: Vecs
    inv_diag: Optional[Vecs]
    tol: torch.Tensor

    def apply(self, vs: Vecs) -> Vecs:
        """A·v on every owned shard: one all_gather, then the local SpMVs."""
        full = self.group.all_gather(vs)
        return [self.matvec(i, full) for i in range(len(vs))]


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
    r0 = [b - ax for b, ax in zip(ctx.b, ctx.apply(x0))]
    z0 = _precond(ctx.inv_diag, r0)
    rnorm0 = _pdot(ctx.group, r0, r0)
    rho0 = rnorm0 if ctx.inv_diag is None else _pdot(ctx.group, r0, z0)
    dev = rnorm0.device
    hist = torch.full((maxiter + 1,), float("nan"), dtype=rnorm0.dtype, device=dev)
    hist[0] = rnorm0
    return PCGCarry(k=torch.zeros((), dtype=torch.int32, device=dev),
                    done=torch.zeros((), dtype=torch.bool, device=dev),
                    x=list(x0), r=r0, p=z0, rho=rho0, rnorm=rnorm0, hist=hist)


def _pcg_body_fn(ctx: _Ctx, c: PCGCarry) -> PCGCarry:
    """One per-shard (P)CG iteration: one gather, two psum rounds (three
    with Jacobi: ρ and ‖r‖² apart, as in the JAX loop); a masked no-op once
    the solve is done or capped."""
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
    z = _precond(ctx.inv_diag, r)
    rnorm_next = _pdot(ctx.group, r, r)
    rho_next = rnorm_next if ctx.inv_diag is None else _pdot(ctx.group, r, z)
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
    solve that is not done.  The extra SpMV's gather and the dots ride the
    same collectives as an iteration."""
    mask = (~c.done) & (c.k % every == 0)
    r_true = [b - ax for b, ax in zip(ctx.b, ctx.apply(c.x))]
    rnorm_t = _pdot(ctx.group, r_true, r_true)
    z_t = _precond(ctx.inv_diag, r_true)
    rho_t = rnorm_t if ctx.inv_diag is None else _pdot(ctx.group, r_true, z_t)
    put_hist(c.hist, c.k, mask, rnorm_t)
    return PCGCarry(
        k=c.k, done=c.done, x=c.x,
        r=[torch.where(mask, rt, r) for rt, r in zip(r_true, c.r)],
        p=[torch.where(mask, zt, p) for zt, p in zip(z_t, c.p)],
        rho=torch.where(mask, rho_t, c.rho),
        rnorm=torch.where(mask, rnorm_t, c.rnorm), hist=c.hist)


def _sharded_pcg(group, matvec: LocalMatvec, b: Vecs, x0: Vecs,
                 inv_diag: Optional[Vecs], tol: float, maxiter: int,
                 recompute_r_every: int = 0):
    """The per-shard (P)CG loop, solver/cg.py's semantics (residual
    replacement included)."""
    ctx = _Ctx(group, matvec, b, inv_diag,
               torch.as_tensor(tol, dtype=b[0].dtype, device=group.device))
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
    r1 = [b - ax for b, ax in zip(ctx.b, ctx.apply(x0))]
    y0 = _precond(ctx.inv_diag, r1)
    beta1 = torch.sqrt(_pdot(ctx.group, r1, y0))
    sdt, dev = beta1.dtype, beta1.device
    hist = torch.full((maxiter + 1,), float("nan"), dtype=sdt, device=dev)
    hist[0] = beta1 * beta1
    zero = torch.zeros((), dtype=sdt, device=dev)
    nan = torch.isnan(beta1)
    return MinresCarry(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        done=nan | (beta1 <= ctx.tol), nan=nan, x=list(x0), r1=r1, r2=r1,
        y=[y.to(b.dtype) for y, b in zip(y0, ctx.b)],
        oldb=zero, beta=beta1, dbar=zero, epsln=zero, phibar=beta1,
        cs=-torch.ones((), dtype=sdt, device=dev), sn=zero,
        w=[torch.zeros_like(b) for b in ctx.b], w2=[torch.zeros_like(b) for b in ctx.b],
        hist=hist)


def _minres_body_fn(ctx: _Ctx, s: MinresCarry) -> MinresCarry:
    """One per-shard MINRES iteration: one gather and two psum rounds (v·y
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
    y_next = [y.to(dt) for y in _precond(ctx.inv_diag, r2n)]
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

    def keep_all(new, old):
        return [keep(a, b) for a, b in zip(new, old)]

    return MinresCarry(
        k=k, done=keep(done, s.done), nan=keep(is_nan, s.nan),
        x=keep_all(x, s.x), r1=keep_all(s.r2, s.r1), r2=keep_all(r2n, s.r2),
        y=keep_all(y_next, s.y), oldb=keep(s.beta, s.oldb), beta=keep(beta, s.beta),
        dbar=keep(dbar, s.dbar), epsln=keep(epsln, s.epsln),
        phibar=keep(phibar, s.phibar), cs=keep(cs, s.cs), sn=keep(sn, s.sn),
        w=keep_all(w, s.w), w2=keep_all(s.w, s.w2), hist=s.hist)


def _sharded_minres(group, matvec: LocalMatvec, b: Vecs, x0: Vecs,
                    inv_diag: Optional[Vecs], tol: float, maxiter: int):
    """Per-shard MINRES (Paige–Saunders) for symmetric, possibly indefinite
    systems, at CG's collective cost.  ``inv_diag`` must be SPD: an
    indefinite M NaNs the Lanczos inner product and reports
    ``converged=False``.  rho = rnorm = φ̄², NaN after a breakdown."""
    ctx = _Ctx(group, matvec, b, inv_diag,
               torch.as_tensor(tol, dtype=b[0].dtype, device=group.device))
    box = [_minres_init_carry(ctx, x0, maxiter)]

    def step():
        box[0] = _minres_body_fn(ctx, box[0])

    run_chunked(step, lambda: box[0].live, maxiter, done=lambda: box[0].done)
    s = box[0]
    rho = torch.where(s.nan, torch.full_like(s.phibar, float("nan")), s.phibar * s.phibar)
    return s.x, s.k, s.done, rho, rho, s.hist


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
    """Per-shard (P)CG on the fused kernels, float32: each shard's SpMV and
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
    """Per-shard MINRES on the fused kernels, float32: each shard's pending
    w/x update, SpMV on the gathered v and the v·q, v·r1 partials as one
    kernel (``minres_shard_spmv_dot``), the Lanczos projections and the β²
    partial as another (``minres_update_dot`` in partials-only mode).  One
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
    (square tiles, bn and the rows per shard multiples of 128, float32,
    kmax <= 64) with the operator on a CUDA device in place of its TPU-only
    terms (the VMEM byte cap on the gathered operand, a TPU backend)."""
    n_shards, _, kmax, bm, bn = blocks.shape
    m = b.shape[0] // n_shards
    return (bm == bn and bn % 128 == 0 and m % 128 == 0
            and b.dtype == torch.float32 and kmax <= 64 and blocks.is_cuda)
