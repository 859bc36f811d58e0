"""GMRES(m), restarted minimal-residual solver for nonsymmetric systems.
Counterpart of ``conjugategradient_tpu/solver/gmres.py``, with the same
semantics:

* ``tol`` is absolute on the TRUE residual ‖b − A x‖₂.  The in-cycle Givens
  estimate only ends a cycle early; the solve ends when the residual
  recomputed at a cycle's end meets it (every restart is a residual
  replacement).
* ``maxiter`` counts inner Arnoldi steps (default N); the restart length is
  min(restart, maxiter, N).
* Orthogonalization is CGS2 (classical Gram-Schmidt, twice) as four
  products with the live rows of the (m+1, n) basis.
* The Hessenberg matrix never forms: the previous Givens rotations are
  applied to each new column as it arrives; the history holds the Givens
  estimate per step, each cycle's last slot overwritten with the true norm,
  NaN past the end; masked writes land in a scratch slot.
* A happy breakdown (the Krylov space exhausted) is convergence; a NaN is a
  clean ``breakdown``.
* Preconditioning is right preconditioning (x = x₀ + M z), so the observed
  residual is the true one; ``flexible=True`` is FGMRES, which keeps the
  preconditioned vectors as a second basis.

The loop: the JAX package runs one jitted while loop over cycles with a
masked loop over the steps.  Here the cycles and steps are a Python loop of
device work, every recurrence scalar a 0-d device tensor and every update
masked on the device, so no step reads anything back.  The host follows two
flags through ``solver/restart.py``'s ``_DonePoll`` (non-blocking copies, at
most ``LOOKAHEAD`` in flight): the step flag (the cycle ended early or hit
the cap) ends a cycle's steps, the solve flag (done, or the cap) ends the
cycles.  Steps and cycles launched after a flag was set are masked no-ops,
so the result is the one the loop without polls gives (on CPU tensors the
flags are read directly and none runs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.blas import dot
from ..ops.spmv import full_precision_matmul
from ..types import as_linear_operator
from .restart import _DonePoll

UNROLL_CHOICES = ("auto", "never", "always")


@dataclasses.dataclass(frozen=True)
class GmresInfo:
    """Solve metadata; every field a tensor on the solve's device."""

    iterations: torch.Tensor  # int32 — inner Arnoldi steps (= SpMVs in the loop)
    cycles: torch.Tensor  # int32 — restart cycles executed
    converged: torch.Tensor  # bool — the TRUE residual met the tolerance
    breakdown: torch.Tensor  # bool — a NaN / non-finite value ended the solve
    rnorm: torch.Tensor  # final TRUE residual norm ‖b − A x‖₂
    # (maxiter+1,) Givens estimates per inner step, each cycle boundary
    # overwritten with the recomputed true norm; NaN past the end
    rnorm_history: torch.Tensor
    rnorm_true: torch.Tensor  # rnorm (the restart recompute is the true residual)

    @property
    def residual_norms(self) -> torch.Tensor:
        """Norms (not squared, like MinresInfo; unlike CGInfo.rho_history)."""
        return self.rnorm_history


class _Solve:
    """The outer carry (k, cycles, done, broke, x, rnorm, hist) and one
    cycle's basis, Hessenberg columns, rotations and flags."""

    def __init__(self, op, apply_m, b, x0, tol, maxiter, m, flexible):
        self.op, self.apply_m, self.b = op, apply_m, b
        self.maxiter, self.m, self.flexible = maxiter, m, flexible
        dev = b.device
        self.vdt = b.dtype
        self.sdt = dot(b[:1], b[:1]).dtype  # widened scalar dtype (>= f32)
        self.x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
        r0 = b - op.matvec(self.x).to(self.vdt)
        self.rnorm = torch.sqrt(dot(r0, r0)).to(self.sdt)
        # slot maxiter + 1 absorbs masked writes; trimmed on return
        self.hist = torch.full((maxiter + 2,), float("nan"), dtype=self.sdt, device=dev)
        self.hist[0] = self.rnorm
        self.tol = torch.as_tensor(tol, dtype=b.dtype, device=dev).to(self.sdt)
        self.k = torch.zeros((), dtype=torch.int32, device=dev)
        self.cycles = torch.zeros((), dtype=torch.int32, device=dev)
        self.broke = torch.isnan(self.rnorm)
        self.done = self.broke | (self.rnorm <= self.tol)

    def finished(self) -> torch.Tensor:
        """The solve flag: no further cycle does anything."""
        return self.done | (self.k >= self.maxiter)

    def stopped(self) -> torch.Tensor:
        """The step flag: no further step of this cycle does anything."""
        return self.idone | (self.k + self.jused >= self.maxiter)

    def start_cycle(self) -> None:
        """r = b − A x, v₀ = r/‖r‖; masked by whether the solve is live."""
        m, n, sdt, dev = self.m, self.b.shape[0], self.sdt, self.b.device
        self.live = ~self.finished()
        r = self.b - self.op.matvec(self.x).to(self.vdt)
        beta = torch.sqrt(dot(r, r)).to(sdt)
        # beta == 0 cannot reach a live cycle (done would be set): the where
        # keeps the 0/0 out of the masked-off work
        v0 = torch.where(beta > 0, r / beta.to(self.vdt), torch.zeros_like(r))
        self.V = torch.zeros((m + 1, n), dtype=self.vdt, device=dev)
        self.V[0] = v0
        self.Z = torch.zeros((m if self.flexible else 1, n), dtype=self.vdt, device=dev)
        self.R = torch.zeros((m + 1, m), dtype=sdt, device=dev)
        self.g = torch.zeros(m + 1, dtype=sdt, device=dev)
        self.g[0] = beta
        # rotation i as [[c_i, s_i], [-s_i, c_i]]: identity until built
        self.G = torch.eye(2, dtype=sdt, device=dev).repeat(m, 1, 1)
        self.idone = ~self.live
        self.ibroke = torch.zeros((), dtype=torch.bool, device=dev)
        self.jused = torch.zeros((), dtype=torch.int32, device=dev)

    def step(self, j: int) -> None:
        """Arnoldi step j: z = M v_j, w = A z, CGS2 against the j + 2 live
        basis rows (the rows past them are zero, so the products over the
        whole basis give the same values), the previous rotations on the
        new column, then the new rotation and the Givens estimate."""
        m, sdt, V = self.m, self.sdt, self.V
        active = ~self.idone & (self.k + j < self.maxiter)
        z = self.apply_m(V[j]).to(self.vdt)
        if self.flexible:
            self.Z[j] = torch.where(active, z, self.Z[j])
        w = self.op.matvec(z).to(self.vdt)
        Va = V[: j + 2].to(sdt)
        wa = w.to(sdt)
        h1 = Va @ wa
        w1 = wa - Va.T @ h1
        h2 = Va @ w1
        w2 = w1 - Va.T @ h2
        h = h1 + h2
        hsub = torch.sqrt(torch.sum(w2 * w2))
        vnext = torch.where(hsub > 0, w2 / hsub, torch.zeros_like(w2))
        V[j + 1] = torch.where(active, vnext.to(self.vdt), V[j + 1])

        col = torch.zeros(m + 1, dtype=sdt, device=V.device)
        col[: j + 2] = h
        col[j + 1] = hsub
        # the chain of previous rotations: j dependent 2 x 2 products
        for i in range(j):
            col[i: i + 2] = self.G[i] @ col[i: i + 2]
        a0, a1 = col[j], col[j + 1]
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
        resid_est = torch.abs(g_new[j + 1])

        self.R[:, j] = torch.where(active, col, self.R[:, j])
        rot = torch.stack((torch.stack((csj, snj)), torch.stack((-snj, csj))))
        self.G[j] = torch.where(active, rot, self.G[j])
        self.g = torch.where(active, g_new, self.g)

        nonfinite = ~torch.isfinite(resid_est)
        # hsub == 0 is the happy breakdown: the rotation zeroes g[j+1], so
        # resid_est = 0 and the tolerance test fires on its own
        step_done = active & (nonfinite | (resid_est <= self.tol))
        self.jused = self.jused + active.to(torch.int32)
        idx = torch.where(active, self.k + self.jused, self.maxiter + 1)
        self.hist.index_put_((idx.long().reshape(1),), resid_est.reshape(1))
        self.idone = self.idone | step_done
        self.ibroke = self.ibroke | (active & nonfinite)

    def end_cycle(self) -> None:
        """The small triangular solve on the leading jused columns, the
        update, and the TRUE-residual restart that decides the solve."""
        m, sdt = self.m, self.sdt
        valid = torch.arange(m, device=self.b.device) < self.jused
        Rm = torch.where(valid[None, :], self.R[:m, :m],
                         torch.eye(m, dtype=sdt, device=self.b.device))
        gm = torch.where(valid, self.g[:m], torch.zeros((), dtype=sdt, device=self.b.device))
        y = torch.linalg.solve_triangular(Rm, gm[:, None], upper=True)[:, 0]
        if self.flexible:
            dx = (self.Z.to(sdt).T @ y).to(self.vdt)  # FGMRES: x += Z y
        else:
            dx = self.apply_m((self.V[:m].to(sdt).T @ y).to(self.vdt)).to(self.vdt)
        x_new = (self.x + dx).to(self.x.dtype)
        r_new = self.b - self.op.matvec(x_new).to(self.vdt)
        rnorm_new = torch.sqrt(dot(r_new, r_new)).to(sdt)
        finite = torch.isfinite(rnorm_new) & ~self.ibroke
        take = self.live & finite
        self.x = torch.where(take, x_new, self.x)
        self.rnorm = torch.where(take, rnorm_new, self.rnorm)
        self.k = self.k + self.jused
        idx = torch.where(take, self.k, self.maxiter + 1)
        self.hist.index_put_((idx.long().reshape(1),), rnorm_new.reshape(1))
        broke = ~finite
        done = broke | (self.rnorm <= self.tol) | (self.jused == 0)
        self.broke = torch.where(self.live, broke, self.broke)
        self.done = torch.where(self.live, done, self.done)
        self.cycles = self.cycles + self.live.to(torch.int32)
        del self.V, self.Z  # the basis is a cycle's: free it before the next


def gmres_solve(
    A: Any,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    restart: int = 30,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    flexible: bool = False,
    n: Optional[int] = None,
    unroll: str = "auto",
) -> Tuple[torch.Tensor, GmresInfo]:
    """Solve the (possibly nonsymmetric) system ``A x = b`` with GMRES(m).

    ``A``: an operator, a dense or sparse matrix, or an ``x -> A x``
    callable with ``n=``; its vectors live on b's device.  ``tol``:
    absolute, on the true residual (0 runs to the cap).  ``maxiter``: cap
    on the inner Arnoldi steps (default N; each cycle's end adds one
    matvec for the true residual).  ``restart``: the cycle length m, the
    (m+1, n) basis held on the device.  ``M``: the right preconditioner
    ``v -> M⁻¹ v`` (the objects ``cg_solve`` takes).  ``flexible``: FGMRES,
    for an M that is not one fixed linear operator (an inner Krylov solve);
    with ``M=None`` it is plain GMRES.  ``unroll`` is validated
    (``"auto"``, ``"never"`` or ``"always"``); every value reads only the
    j + 2 live basis rows at step j, which gives the same values as the
    whole basis (the rows past them are zero).

    Returns ``(x, GmresInfo)``; a happy breakdown is ``converged=True``.
    """
    if unroll not in UNROLL_CHOICES:
        raise ValueError(f"unroll must be auto/never/always, got {unroll!r}")
    full_precision_matmul()
    op = as_linear_operator(A, device=b.device, n=n, dtype=b.dtype)
    N = op.shape[0]
    maxiter = N if maxiter is None else int(maxiter)
    m = max(1, min(int(restart), maxiter, N))
    if flexible and M is None:
        flexible = False  # FGMRES with the identity is GMRES
    apply_m = (lambda v: v) if M is None else M
    s = _Solve(op, apply_m, b, x0, tol, maxiter, m, bool(flexible))

    cycles = _DonePoll(s.finished)
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
        rnorm_history=s.hist[: maxiter + 1],
        rnorm_true=s.rnorm,
    )
    return s.x, info
