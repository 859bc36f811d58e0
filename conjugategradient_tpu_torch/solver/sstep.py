"""s-step (communication-avoiding) CG, the Chronopoulos–Gear block
variant.  Counterpart of ``conjugategradient_tpu/solver/sstep.py``, with
the same block algebra, scaling and semantics.

Standard CG needs two dependent reductions per iteration; the pipelined
variant (solver/pipelined.py) one.  The s-step form advances CG by ``s``
iterations per reduction:

    per block:  K = [r, Ar, …, Aˢr]              (s matvecs)
                G = UᵀU,  U = [K, P₋, W₋]        (one (3s+1)² Gram)
                B = −(P₋ᵀW₋)⁺ (W₋ᵀR)             (A-conjugate the new block
                                                  against the previous one)
                P = R + P₋B,   W = AP = S + W₋B  (R = K[:,:s], S = K[:,1:])
                a = (PᵀW)⁺ (Pᵀr)                 (A-norm-optimal s-dim step)
                x += Pa,   r −= Wa

In exact arithmetic a block equals s consecutive CG iterations.  Every
inner product of a block is an entry of the one Gram G; the small solves
are the equilibrated eigh pseudo-inverse (:func:`_eq_pinv_apply`), so a
rank-deficient block (Krylov grade < s: exact convergence mid-block) takes
the least-squares step instead of breaking down.

The monomial basis conditions like κ(A)ˢ, so rounding grows with ``s``
(2 to 4 is the usable range, 4 the default); the basis rows are scaled by
a factor ν adapted from the Gram's own diagonal.  Semantics: the tolerance
is tested on the pre-block ‖r‖²; the detecting block still updates and
counts (at s = 1 the iteration count equals plain CG's); NaN exits; the cap
may overshoot ``maxiter`` by at most s − 1; ``rho_history`` holds ‖r‖² at
block boundaries and NaN between.

The loop is device-resident: each block is masked on the device once
``done`` is set or k reaches the cap, and the host follows ``done``
through ``restart.run_chunked``.  ``torch.linalg.eigh`` checks its result
on the host, so a block reads the device twice (its two small solves).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.spmv import full_precision_matmul
from ..types import as_linear_operator
from .blockcg import _spd_pinv_apply, default_gram_rcond
from .cg import CGInfo
from .restart import run_chunked

# one cutoff ladder for every Gram solve in the package
_default_rcond = default_gram_rcond


def _eq_pinv_apply(M: torch.Tensor, Y: torch.Tensor, rcond: float) -> torch.Tensor:
    """Diagonally equilibrated SPD pseudo-inverse apply: M⁺Y computed as
    D⁻¹ (D⁻¹MD⁻¹)⁺ D⁻¹Y with D = √diag(M).  The monomial-basis Gram's
    diagonal spans many orders of magnitude (‖Aᵏr‖² ~ λᵏ); without the
    equilibration the relative eigenvalue cutoff would drop the
    small-diagonal directions wholesale.

    A Gram with a non-finite entry (a solve that has broken down) gives a
    NaN result, as the eigendecomposition of such a matrix does in the JAX
    package; it is not handed to ``eigh``, whose CUDA form raises on it."""
    dt = torch.promote_types(M.dtype, torch.float32)
    diag = torch.abs(torch.diagonal(M)).to(dt)
    d = torch.sqrt(torch.where(diag > 0, diag, 1.0))
    Ms = M.to(dt) / d[:, None] / d[None, :]
    bad = ~torch.isfinite(Ms).all()
    Ms = torch.where(bad, torch.eye(Ms.shape[0], dtype=dt, device=Ms.device), Ms)
    Ys = Y.to(dt) / d[:, None] if Y.ndim == 2 else Y.to(dt) / d
    out = _spd_pinv_apply(Ms, Ys if Ys.ndim == 2 else Ys[:, None], rcond)
    out = out / d[:, None] if Y.ndim == 2 else out[:, 0] / d
    return torch.where(bad, float("nan"), out).to(Y.dtype)


@dataclasses.dataclass(frozen=True)
class _Block:
    """The s-step carry: P₋ and W₋ = A·P₋ as (s, n) rows, ν the basis
    scale, ``rho`` the last pre-block ‖r‖²."""

    k: torch.Tensor  # inner iterations completed
    done: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    Pb: torch.Tensor
    Wb: torch.Tensor
    nu: torch.Tensor
    rho: torch.Tensor
    hist: torch.Tensor


def make_sstep_loop(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    reduce_gram: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    s: int,
    tol_arr: torch.Tensor,
    maxiter: int,
    rcond: float,
    basis_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    gram_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Run the s-step loop shared by the single-device and sharded solvers.

    ``matvec`` maps a (possibly shard-local) vector to A·v; ``reduce_gram``
    maps the local (3s+1, 3s+1) Gram partial to the global Gram (the
    identity on one device, one sum over the shards otherwise);
    ``basis_fn(r, inv_nu)`` optionally replaces the matvec-at-a-time Krylov
    basis, returning the (s+1, n_local) scaled rows.  ``gram_fn(U)``
    optionally replaces both steps of the Gram: it maps the (rows, n_local)
    block U, in the accumulation dtype, to the global UUᵀ (the sharded loop
    of a process that owns several shards forms one partial per shard, so
    that the sum over the shards runs in the shard group's fixed order).
    Returns ``(x, k, done, rnorm, hist)`` with the framework's carry
    conventions.
    """
    acc = torch.promote_types(b.dtype, torch.float32)
    n_local = b.shape[0]
    dev = b.device

    def gram(U):
        U = U.to(acc)
        return reduce_gram(U @ U.T) if gram_fn is None else gram_fn(U)

    def basis(r, inv_nu):
        """Scaled monomial basis K'_j = (A/ν)ʲ r stacked as (s+1, n_local)
        rows: the raw basis grows like λmaxˢ per block, which overflows
        float32 on ill-conditioned operators long before the Gram algebra
        breaks down.  A·K'_j = ν·K'_{j+1}, so ν reappears only as scalar
        factors on the S-terms of PᵀW and dr below."""
        if basis_fn is not None:
            return basis_fn(r, inv_nu)
        rows = [r]
        for _ in range(s):
            nxt = matvec(rows[-1]).to(acc) * inv_nu
            rows.append(nxt.to(r.dtype))
        return torch.stack(rows, dim=0)

    r0 = b - matvec(x0)
    hist = torch.full((maxiter + 1,), float("nan"), dtype=acc, device=dev)
    zeros_block = torch.zeros((s, n_local), dtype=b.dtype, device=dev)
    eye_s = torch.eye(s, dtype=acc, device=dev)
    box = [_Block(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        x=x0, r=r0, Pb=zeros_block, Wb=zeros_block,
        nu=torch.ones((), dtype=acc, device=dev),
        rho=torch.full((), float("nan"), dtype=acc, device=dev),
        hist=hist,
    )]
    # index blocks of G: K -> 0..s, P₋ -> s+1..2s, W₋ -> 2s+1..3s
    iR, iS = slice(0, s), slice(1, s + 1)
    iP, iW = slice(s + 1, 2 * s + 1), slice(2 * s + 1, 3 * s + 1)

    def live(c: _Block) -> torch.Tensor:
        return (~c.done) & (c.k < maxiter)

    def step():
        c = box[0]
        go = live(c)
        K = basis(c.r, 1.0 / c.nu)  # (s+1, n)
        U = torch.cat([K, c.Pb.to(K.dtype), c.Wb.to(K.dtype)], 0)
        G = gram(U)  # (3s+1, 3s+1): the block's only reduction

        rho = G[0, 0]  # pre-block ‖r_k‖², the termination observable
        done_now = torch.isnan(rho) | (torch.sqrt(rho) <= tol_arr)

        # conjugation against the previous block; the first block has
        # P₋ = W₋ = 0, so W₋ᵀR = 0 and B = 0 (the identity keeps the solve
        # well-posed)
        PbtWb = torch.where(c.k == 0, eye_s, G[iP, iW])
        B = -_eq_pinv_apply(PbtWb, G[iW, iR], rcond)  # (s, s)
        # ν enters where A·R = ν·S does: the S-terms of PᵀW and dr
        nu = c.nu
        PtW = nu * (G[iR, iS] + B.T @ G[iP, iS]) + (G[iR, iW] + B.T @ G[iP, iW]) @ B
        Ptr = G[iR, 0] + B.T @ G[iP, 0]
        a = _eq_pinv_apply(PtW, Ptr, rcond)  # (s,)

        R_rows, S_rows = K[:s].to(acc), K[1:].to(acc)
        Pb, Wb = c.Pb.to(acc), c.Wb.to(acc)
        c_prev = B @ a  # the previous block's coefficient in the step
        dx = a @ R_rows + c_prev @ Pb
        dr = nu * (a @ S_rows) + c_prev @ Wb
        x_new = (c.x.to(acc) + dx).to(c.x.dtype)
        r_new = (c.r.to(acc) - dr).to(c.r.dtype)
        P_new = (R_rows + B.T.to(acc) @ Pb).to(b.dtype)
        W_new = (nu * S_rows + B.T.to(acc) @ Wb).to(b.dtype)

        # adapt ν so the next block's scaled rows stay O(‖r‖): this block's
        # per-level growth is (G[s,s]/G[0,0])^(1/2s); a converged or broken
        # block leaves ν alone
        g = (G[s, s] / rho) ** (1.0 / (2 * s))
        nu_new = torch.where(torch.isfinite(g) & (g > 0), nu * g, nu)

        # the detecting block still updates and counts (the framework's
        # one-update-late semantics at block granularity); an exactly
        # converged block is a no-op: r = 0, so G = 0 and a = B = 0
        kk = torch.clamp(c.k, max=maxiter).long().reshape(1)
        box[0] = _Block(
            k=torch.where(go, c.k + s, c.k),
            done=torch.where(go, done_now, c.done),
            x=torch.where(go, x_new, c.x), r=torch.where(go, r_new, c.r),
            Pb=torch.where(go, P_new, c.Pb), Wb=torch.where(go, W_new, c.Wb),
            nu=torch.where(go, nu_new, c.nu), rho=torch.where(go, rho, c.rho),
            hist=c.hist.index_put(
                (kk,), torch.where(go, rho, c.hist.gather(0, kk)[0]).reshape(1)),
        )

    blocks = -(-maxiter // s)  # the loop's cap in blocks
    run_chunked(step, lambda: live(box[0]), blocks, done=lambda: box[0].done)
    c = box[0]
    # one reduction after the loop records the final recurrence residual
    # (k may overshoot maxiter by up to s − 1: the slot is clamped)
    rnorm = gram(c.r[None, :])[0, 0]
    kk = torch.clamp(c.k, max=maxiter).long().reshape(1)
    hist = c.hist.index_put((kk,), rnorm.reshape(1))
    return c.x, c.k, c.done, rnorm, hist


def sstep_cg_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    s: int = 4,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    n: Optional[int] = None,
    rcond: Optional[float] = None,
) -> Tuple[torch.Tensor, CGInfo]:
    """Solve SPD ``A x = b`` with s-step CG: one reduction per ``s``
    iterations.  Same call shape and ``CGInfo`` contract as
    :func:`~.cg.cg_solve`, with block-granular semantics: the tolerance is
    tested on the pre-block ‖r‖², ``iterations`` advances in multiples of
    ``s`` (overshooting ``maxiter`` by at most s − 1), and ``rho_history``
    holds ‖r‖² at block boundaries (NaN between).  ``rcond``: the relative
    eigenvalue cutoff of the block solves (None: the dtype's
    ``default_gram_rcond``).
    """
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    full_precision_matmul()
    op = as_linear_operator(A, device=b.device, n=n, dtype=b.dtype)
    maxiter = int(op.shape[0] + 1 if maxiter is None else maxiter)
    rcond = _default_rcond(b.dtype) if rcond is None else float(rcond)
    tol_arr = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    x0 = torch.zeros_like(b) if x0 is None else x0
    x, k, done, rnorm, hist = make_sstep_loop(
        op.matvec, lambda G: G, b, x0, s=int(s), tol_arr=tol_arr, maxiter=maxiter,
        rcond=rcond,
    )
    return x, CGInfo(
        iterations=k,
        converged=done & ~torch.isnan(rnorm),
        rho=rnorm,
        rnorm_sq=rnorm,
        rho_history=hist,
    )
