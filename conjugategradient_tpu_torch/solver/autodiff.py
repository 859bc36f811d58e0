"""Differentiable solves: gradients through CG and GMRES by the implicit
function theorem.  Counterpart of ``conjugategradient_tpu/solver/autodiff.py``,
with the same signatures, defaults and reverse rules.

For ``x(θ, b) = A(θ)⁻¹ b`` the backward pass is one adjoint solve and one
vector-Jacobian product of the matvec at the fixed solution:

    w = A⁻ᵀ ḡ                       (CG: A is symmetric, so A w = ḡ with
                                     the same solver, tol and M)
    ∂L/∂b = w,   ∂L/∂θ = −wᵀ ∂(A(θ) x)/∂θ,   ∂L/∂x₀ = 0

so its cost does not depend on how many iterations the forward solve took,
and nothing of the forward iteration is stored.

Each solve is a ``torch.autograd.Function`` whose differentiable inputs are
b, x₀ and the operator's floating-point tensor fields (CSR ``data``, DIA
``diags``, blocked-ELL ``blocks``, symmetric blocked-ELL ``diag_blocks`` and
``off_blocks``, SELL ``diag`` and ``vals_flat``, a dense operator's ``a``,
and a stencil's coefficient tensors, ``StencilOperator.coefficient_tensors``).
The forward runs ``cg_solve`` / ``gmres_solve`` unchanged on the operator
rebuilt from those fields (``dataclasses.replace``), so on a CUDA device it
runs the same kernels.  The kernels have no backward: the matvec's VJP goes
through the layout's plain form (``use_kernel="never"``; for symmetric
blocked-ELL the JAX package's scatter form, :func:`_sym_bell_scatter`), so
each layout gets the JAX package's gradient — per stored nonzero, per diagonal slot, per
tile element, and per stored symmetric element with both mirrored
contributions.  The transposed matvec of the GMRES adjoint is the VJP of
that plain matvec (``torch.func.vjp``), the counterpart of
``jax.linear_transpose``; no transposed storage is built.

Caveats, as in the JAX package: the rule is exact at the solution (use a
tight ``tol``, or 0 to run to the cap); ``A`` must be symmetric for
:func:`implicit_cg_solve`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional, Tuple

import torch

from ..types import (BlockedEllMatrix, DIAMatrix, StencilOperator, SymBellMatrix,
                     SymDIAMatrix, as_linear_operator)
from .cg import CGInfo, cg_solve
from .gmres import GmresInfo, gmres_solve


def _leaf_names(op) -> Tuple[str, ...]:
    """The operator's fields that receive gradients: its floating-point
    tensors (a stencil's coefficient tensors)."""
    if isinstance(op, StencilOperator):
        return tuple(op.coefficient_tensors)
    if not dataclasses.is_dataclass(op):
        return ()
    return tuple(f.name for f in dataclasses.fields(op)
                 if isinstance(getattr(op, f.name), torch.Tensor)
                 and getattr(op, f.name).is_floating_point())


def _rebuild(op, names, tensors):
    """``op`` with the named fields replaced by ``tensors``.  A packed
    blocked-ELL view built for ``op`` is carried over: it is keyed on the
    storage and version of the tiles (``types/bell._cached_pack``), so the
    new operator uses it only while its tiles are the same tensor data."""
    if not names or isinstance(op, StencilOperator):
        return op
    new = dataclasses.replace(op, **dict(zip(names, tensors)))
    if "_packed" in op.__dict__:
        object.__setattr__(new, "_packed", op.__dict__["_packed"])
    return new


def _plain_matvec(op, names, tensors, x: torch.Tensor) -> torch.Tensor:
    """A·x through the layout's plain form, differentiable in ``tensors``
    (the fields ``names`` of ``op``) and in ``x``."""
    from ..ops.spmv import bell_spmv, dia_spmv, sym_dia_spmv
    from ..ops.stencil import _neighbor_sum

    if isinstance(op, StencilOperator):
        coef = dict(zip(names, tensors))
        u = x.to(torch.promote_types(op.dtype, x.dtype)).reshape(op.grid_shape)
        center = coef.get("center", op.center)
        off = coef.get("off", op.off)
        return (center * u + off * _neighbor_sum(u)).reshape(-1)
    a = _rebuild(op, names, tensors)
    if isinstance(a, SymBellMatrix):
        return _sym_bell_scatter(a, x)
    if isinstance(a, BlockedEllMatrix):
        return bell_spmv(a, x, use_kernel="never")
    if isinstance(a, SymDIAMatrix):
        return sym_dia_spmv(a, x, use_kernel="never")
    if isinstance(a, DIAMatrix):
        return dia_spmv(a, x, use_kernel="never")
    return a.matvec(x)  # CSR, SELL, dense and matrix-free: plain already


def _sym_bell_scatter(a, x: torch.Tensor) -> torch.Tensor:
    """(D + U + Uᵀ) x as the JAX package writes it (``ops/spmv.sym_bell_spmv``
    there): the mirror products land by a scatter-add over ``off_cols``,
    padding slots included.  Its VJP gives the JAX gradient in every stored
    element, padding tiles too; the port's ``sym_bell_apply`` lands the
    mirror by a gather that skips the padding slots, so a padding tile's
    gradient would lack its mirrored term."""
    from ..ops.spmv import _acc, full_precision_matmul

    full_precision_matmul()
    n, _ = a.shape
    _, mp = a.padded_shape
    xp = x if mp == x.shape[0] else torch.nn.functional.pad(x, (0, mp - x.shape[0]))
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    acc = _acc(out_dtype)
    x2d = xp.reshape(mp // a.bn, a.bn).to(acc)
    diag, off, cols = a.diag_blocks.to(acc), a.off_blocks.to(acc), a.off_cols.long()
    qd = torch.einsum("rmn,rn->rm", diag, x2d)
    qu = torch.einsum("rkmn,rkn->rm", off, x2d[cols])
    v = torch.einsum("rkmn,rm->rkn", off, x2d)
    qt = torch.zeros_like(qd).index_add(0, cols.reshape(-1), v.reshape(-1, a.bn))
    return (qd + qu + qt).reshape(-1)[:n].to(out_dtype)


class _Rule:
    """What one implicit solve needs: the operator and the names of its
    leaves; a subclass adds ``forward(op, b, x0)`` (the solve) and
    ``adjoint(op, leaves, g)`` (w of the adjoint system)."""

    def __init__(self, op, names):
        self.op, self.names = op, names


class _ImplicitSolve(torch.autograd.Function):
    """Forward: ``rule.forward``; backward: ``rule.adjoint`` and one VJP of
    the plain matvec at x.  Outputs: x, then the info's fields, marked not
    differentiable."""

    @staticmethod
    def forward(ctx, rule, b, x0, *leaves):
        detached = [t.detach() for t in leaves]
        op = _rebuild(rule.op, rule.names, detached)
        x, info = rule.forward(op, b.detach(), None if x0 is None else x0.detach())
        fields = tuple(getattr(info, f.name) for f in dataclasses.fields(info))
        ctx.rule, ctx.op, ctx.has_x0 = rule, op, x0 is not None
        ctx.save_for_backward(x, *leaves)
        ctx.mark_non_differentiable(*fields)
        return (x,) + fields

    @staticmethod
    def backward(ctx, gx, *_):
        x, *leaves = ctx.saved_tensors
        rule = ctx.rule
        none = (None, None, None) + (None,) * len(leaves)
        if gx is None:
            return none
        detached = [t.detach() for t in leaves]
        with torch.no_grad():
            w = rule.adjoint(ctx.op, detached, gx.to(x.dtype))
        grads = [None] * len(leaves)
        want = [i for i in range(len(leaves)) if ctx.needs_input_grad[3 + i]]
        if want:
            with torch.enable_grad():
                ts = [t.detach().requires_grad_(i in want) for i, t in enumerate(leaves)]
                y = _plain_matvec(rule.op, rule.names, ts, x.detach())
                got = torch.autograd.grad(y, [ts[i] for i in want], (-w).to(y.dtype),
                                          allow_unused=True)
            for i, g in zip(want, got):
                grads[i] = torch.zeros_like(leaves[i]) if g is None else g
        gb = w.to(x.dtype) if ctx.needs_input_grad[1] else None
        gx0 = torch.zeros_like(x) if ctx.has_x0 and ctx.needs_input_grad[2] else None
        return (None, gb, gx0, *grads)


def _apply(rule, info_cls, b, x0):
    leaves = ([rule.op.coefficient_tensors[k] for k in rule.names]
              if isinstance(rule.op, StencilOperator)
              else [getattr(rule.op, k) for k in rule.names])
    out = _ImplicitSolve.apply(rule, b, x0, *leaves)
    return out[0], info_cls(*out[1:])


class _CGRule(_Rule):
    def __init__(self, op, names, tol, maxiter, M, recompute_r_every, fused):
        super().__init__(op, names)
        self.kw = dict(tol=tol, maxiter=maxiter, M=M, recompute_r_every=recompute_r_every,
                       fused=fused)

    def forward(self, op, b, x0):
        return cg_solve(op, b, x0, **self.kw)

    def adjoint(self, op, leaves, g):
        # A is symmetric: the adjoint system is the same CG, with the same M
        # (M⁻¹ is symmetric too for every built-in preconditioner)
        w, _ = cg_solve(op, g, **self.kw)
        return w


def implicit_cg_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
    recompute_r_every: int = 0,
    fused: str = "auto",
) -> Tuple[torch.Tensor, CGInfo]:
    """:func:`~.cg.cg_solve` with the implicit reverse rule.

    Same signature and forward values.  Under autograd the backward pass is
    one adjoint CG solve (same ``tol``, ``maxiter``, ``M``,
    ``recompute_r_every`` and ``fused``, so on the card the same fused
    kernels) plus one VJP of the plain matvec.  Gradients flow to ``b``, to
    the operator's floating-point tensor fields that require them (module
    doc) and, as zeros, to ``x0``.  ``maxiter`` defaults to n + 1.

    Example::

        op = CSRMatrix.from_scipy(a, device="cpu")
        op.data.requires_grad_()
        x, _ = implicit_cg_solve(op, b, tol=1e-10)
        (x ** 2).sum().backward()      # op.data.grad, per stored nonzero
    """
    op = as_linear_operator(A, n=n, dtype=b.dtype, device=b.device)
    if maxiter is None:
        maxiter = op.shape[0] + 1
    rule = _CGRule(op, _leaf_names(op), float(tol), int(maxiter), M, int(recompute_r_every),
                   fused)
    return _apply(rule, CGInfo, b, x0)


def _transpose_preconditioner(M, b: torch.Tensor):
    """Mᵀ for the adjoint GMRES, as the JAX package chooses it: a linear M
    is transposed (here the VJP of M at zero, ``torch.func.vjp``); an M
    that is not linear is reused untransposed — it steers convergence only,
    the converged w does not depend on it.  ``jax.linear_transpose`` tells
    the two apart by structure; ``torch.func.vjp`` never fails (on a
    nonlinear M it gives the Jacobian at zero), so linearity is probed:
    M(u + 2v) against M(u) + 2·M(v) on two vectors drawn from a seeded
    generator, to √eps of the values' dtype.  That costs three applies of M
    and one host read."""
    if M is None:
        return None
    gen = torch.Generator(device=b.device)
    gen.manual_seed(0)
    u, v = (torch.randn(b.shape, generator=gen, dtype=torch.float32,
                        device=b.device).to(b.dtype) for _ in range(2))
    mu, mv, muv = M(u), M(v), M(u + 2 * v)
    gap = torch.linalg.vector_norm((muv - (mu + 2 * mv)).double())
    scale = torch.linalg.vector_norm(mu.double()) + 2 * torch.linalg.vector_norm(mv.double())
    eps = torch.finfo(mu.dtype).eps
    if not bool(gap <= eps ** 0.5 * scale):
        return M
    try:
        _, vjp_m = torch.func.vjp(M, torch.zeros_like(b))
    except (RuntimeError, TypeError):  # an M that autograd cannot trace
        return M
    return lambda r: vjp_m(r.to(b.dtype))[0]


class _GmresRule(_Rule):
    def __init__(self, op, names, tol, maxiter, restart, M):
        super().__init__(op, names)
        self.tol, self.maxiter, self.restart, self.M = tol, maxiter, restart, M

    def forward(self, op, b, x0):
        return gmres_solve(op, b, x0, tol=self.tol, maxiter=self.maxiter,
                           restart=self.restart, M=self.M)

    def adjoint(self, op, leaves, g):
        # the adjoint system is Aᵀ w = ḡ: the transposed matvec is the VJP
        # of the plain matvec (linear in v, so its VJP at zero is Aᵀ)
        def mv(v):
            return _plain_matvec(self.op, self.names, leaves, v)

        zero = torch.zeros_like(g)
        y, vjp_a = torch.func.vjp(mv, zero)

        def at_matvec(u):
            return vjp_a(u.to(y.dtype))[0].to(g.dtype)

        w, winfo = gmres_solve(at_matvec, g, tol=self.tol, maxiter=self.maxiter,
                               restart=self.restart, M=_transpose_preconditioner(self.M, g),
                               n=int(g.shape[0]))
        if self.tol > 0:
            # an adjoint that missed tol leaves the gradient inaccurate beyond
            # the O(||r||) caveat; one host read says so
            ok, rnorm = torch.stack([winfo.converged.to(winfo.rnorm.dtype),
                                     winfo.rnorm]).tolist()
            if not ok:
                warnings.warn(
                    f"implicit_gmres_solve: adjoint GMRES did not converge "
                    f"(rnorm={rnorm:.3e}, tol={self.tol:.3e}) — gradient may be "
                    "inaccurate", RuntimeWarning, stacklevel=4)
        return w


def implicit_gmres_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    restart: int = 30,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    n: Optional[int] = None,
) -> Tuple[torch.Tensor, GmresInfo]:
    """:func:`~.gmres.gmres_solve` with the implicit reverse rule, for
    NONSYMMETRIC operators.

    Same signature and forward values; the backward pass is one adjoint
    GMRES solve of ``Aᵀ w = ḡ`` (the transposed matvec from the plain
    matvec's VJP, no transposed storage) plus one VJP of the plain matvec at
    the solution.  A linear ``M`` is transposed for the adjoint solve, one
    that is not is reused as it is (:func:`_transpose_preconditioner`).  If
    the adjoint misses ``tol`` within ``maxiter`` a ``RuntimeWarning`` says
    so.  ``maxiter`` defaults to n and ``x0`` to zeros.
    """
    op = as_linear_operator(A, n=n, dtype=b.dtype, device=b.device)
    if maxiter is None:
        maxiter = op.shape[0]
    x0 = torch.zeros_like(b) if x0 is None else x0
    rule = _GmresRule(op, _leaf_names(op), float(tol), int(maxiter), int(restart), M)
    return _apply(rule, GmresInfo, b, x0)
