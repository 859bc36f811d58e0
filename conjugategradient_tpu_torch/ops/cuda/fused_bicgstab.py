"""The fused BiCGStab iteration's kernels: hand-written CUDA for Hopper
(``csrc/fused_bicgstab.cu``), each beside its plain-torch version.

Counterpart of ``conjugategradient_tpu/ops/pallas/fused_bicgstab.py``:

* :func:`bicgstab_dir_spmv_dot` — one pass over full blocked-ELL tiles:
  p' = r + β·(p − ω·v); p̂ = d⊙p' (Jacobi) or p'; v' = A·p̂; rv = r̂₀·v'
  (replaces ``bicgstab_dir_spmv_dot``, fused_bicgstab.py:84);
* :func:`bicgstab_s_spmv_dot` — the second tile pass: s = r − α·v';
  ŝ = d⊙s or s; x_h = x + α·p̂; t = A·ŝ; s·s, t·s, t·t (replaces
  ``bicgstab_s_spmv_dot``, fused_bicgstab.py:200);
* :func:`bicgstab_update_dot` — x' = x_h + ω·ŝ; r' = s − ω·t; r'·r' and
  r̂₀·r', the next iteration's ρ (replaces ``bicgstab_update_dot``,
  fused_bicgstab.py:293).

The first two have packed forms, :func:`bicgstab_dir_spmv_dot_packed` and
:func:`bicgstab_s_spmv_dot_packed`: the same functions on the operator's
packed nonzeros (``BlockedEllMatrix.packed()``), for sparse tiles
(``ops/spmv.bell_packed_route``).  Each pair shares one plain body, which
takes the product as a callable: the tiles' ``bell_apply`` or the view's
``packed_apply``, whose order and rounding the packed kernels copy, so they
match their plain versions bit for bit in every vector.

Dispatch is that of ``ops/cuda/fused_cg.py``: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors, no fallback between them;
``LAUNCHES`` and ``PLAIN_ON_CUDA`` (``_common``) count per wrapper.

Inside a solve the wrappers take a :class:`BicgstabWork`: the device
scalars of the recurrence (``B_*`` slots), the control words, the history
and scratch.  The kernels' final reductions then do the solver's scalar
steps on the device (kernel 1: α and its clamp; kernel 2: the half-step
test, ω and its clamp; kernel 3: the breakdown taxonomy, k, hist[k], done,
live, the sticky breakdown flag and the next β), every kernel is a no-op
once ``live`` is 0, and the dots a kernel returns are views of the work's
scalars, valid until the solve's next step.  The plain versions do the same
scalar steps with torch 0-d float32 ops: ``/`` and ``sqrt`` round
correctly and every product and sum rounds once, as the kernels'
``__fmul_rn``/``__fadd_rn`` tails do.

A non-finite α or ω is clamped to 0 before its kernel (its update becomes
an exact no-op), and the finiteness test is made on the unclamped values,
before any clamp: ``fmaxf`` would drop a NaN where ``jnp.maximum`` keeps it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..spmv import bell_apply
from ._common import (
    CUDA_BN,
    LAUNCHES,
    PLAIN_ON_CUDA,
    check_cuda_operands,
    on_cuda,
    ptr,
    raise_on_error,
    stream,
)
from .bell_spmv import check_packed_vectors, packed_product
from .fused_cg import C_DONE, C_K, C_LIVE, C_MAXITER, _extra, _live, auto_row_group

# BicgstabWork.scal, shared with csrc/fused_bicgstab.cu: the recurrence
# (ρ_{k-1}, ρ_k prefetched by kernel 3, α, ω, the unclamped β of the coming
# step), the kernels' clamped operands, the norms, the tolerance
(B_RHO, B_RHO_NEXT, B_ALPHA, B_OMEGA, B_BETA, B_BETA_C, B_ALPHA_C, B_OMEGA_C,
 B_RNORM, B_RNORM_PREV, B_TOL) = range(11)
# where a solve's kernels leave their dots (their (1, 1) outputs, no allocation)
B_RV, B_SS, B_TS, B_TT, B_RN, B_RHO_PREF = range(11, 17)
N_SCAL = 17
# control words: fused_cg's four, the sticky breakdown flag, the half-step
# exit of the current step (kernel 2 sets it, kernel 3 reads it)
C_BROKE, C_HALF = 4, 5

_UPDATE_MAX_GRID = 1024
_THREADS = 256


@dataclasses.dataclass
class BicgstabWork:
    """Device scalars, history and scratch of one fused BiCGStab solve."""

    scal: torch.Tensor  # (17,) f32: the B_* slots
    ctl: torch.Tensor  # (6,) i32: k, done, maxiter, live, broke, half
    hist: torch.Tensor  # (maxiter + 1,) f32 ‖r‖ per iteration, NaN past k
    partials: torch.Tensor  # f32 per-CTA dot partials (three dots in kernel 2)
    counter: torch.Tensor  # (1,) i32 arrival ticket, 0 between launches
    # (1, 1) views of scal, the per-step kernel operands: made once, since a
    # view costs a few microseconds of host time every step
    beta_c: torch.Tensor = dataclasses.field(init=False, repr=False)
    omega: torch.Tensor = dataclasses.field(init=False, repr=False)
    alpha_c: torch.Tensor = dataclasses.field(init=False, repr=False)
    omega_c: torch.Tensor = dataclasses.field(init=False, repr=False)
    dots: tuple = dataclasses.field(init=False, repr=False)  # rv ss ts tt rn rho'

    @staticmethod
    def new(device, maxiter: int = 1, tol: float = 0.0) -> "BicgstabWork":
        device = torch.device(device)
        scal = torch.zeros(N_SCAL, dtype=torch.float32)
        scal[[B_RHO, B_ALPHA, B_OMEGA]] = 1.0
        scal[B_TOL] = tol
        ctl = torch.tensor([0, 0, maxiter, int(maxiter > 0), 0, 0], dtype=torch.int32)
        return BicgstabWork(
            scal=scal.to(device),
            ctl=ctl.to(device),
            hist=torch.full((maxiter + 1,), float("nan"), device=device),
            partials=torch.empty(3 * _UPDATE_MAX_GRID, device=device),
            counter=torch.zeros(1, dtype=torch.int32, device=device),
        )

    def scalar(self, i: int) -> torch.Tensor:
        """(1, 1) view of scalar ``i`` (a kernel operand, no copy)."""
        return self.scal[i:i + 1].view(1, 1)

    def __post_init__(self):
        self.beta_c = self.scalar(B_BETA_C)
        self.omega = self.scalar(B_OMEGA)
        self.alpha_c = self.scalar(B_ALPHA_C)
        self.omega_c = self.scalar(B_OMEGA_C)
        self.dots = tuple(self.scalar(i) for i in range(B_RV, N_SCAL))

    def start(self, rnsq: torch.Tensor) -> None:
        """Enter ‖r₀‖² (a 0-d tensor): ρ₀ = r̂₀·r₀ = ‖r₀‖² as the prefetched
        ρ, the first β, hist[0], and done at once when ‖r₀‖ is NaN or
        already within the tolerance."""
        scal, ctl = self.scal, self.ctl
        rnorm0 = torch.sqrt(rnsq)
        scal[B_RHO_NEXT] = rnsq
        scal[B_RNORM] = rnorm0
        scal[B_RNORM_PREV] = rnorm0
        set_beta(scal, rnsq)
        self.hist[0] = rnorm0
        nan = torch.isnan(rnorm0)
        done = nan | (rnorm0 <= scal[B_TOL])
        ctl[C_BROKE] = nan.to(torch.int32)
        ctl[C_DONE] = done.to(torch.int32)
        ctl[C_LIVE] = ((~done) & (ctl[C_K] < ctl[C_MAXITER])).to(torch.int32)


def _clamp(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def set_beta(scal: torch.Tensor, rho_next: torch.Tensor) -> None:
    """β of the coming step, (ρ_k/ρ_{k-1})·(α/ω), and its clamp."""
    beta = (rho_next / scal[B_RHO]) * (scal[B_ALPHA] / scal[B_OMEGA])
    scal[B_BETA] = beta
    scal[B_BETA_C] = _clamp(beta)


def finish_dir(work: BicgstabWork, rv: torch.Tensor) -> None:
    """The scalar step after kernel 1 (its last CTA does the same): rv into
    its slot, α = ρ_k / (r̂₀·v') and its clamp.  ``rv``: 0-d float32.  (The
    other two steps also store their dots in their slots first.)"""
    scal = work.scal
    scal[B_RV] = rv
    alpha = scal[B_RHO_NEXT] / rv
    scal[B_ALPHA] = alpha
    scal[B_ALPHA_C] = _clamp(alpha)


def finish_s(work: BicgstabWork, ss: torch.Tensor, ts: torch.Tensor, tt: torch.Tensor) -> None:
    """The scalar step after kernel 2: the half-step exit ‖s‖ ≤ tol, ω =
    (t·s)/(t·t), and ω's clamp (0 also on the half-step exit, which makes
    kernel 3 return x_h and s)."""
    scal, ctl = work.scal, work.ctl
    scal[B_SS], scal[B_TS], scal[B_TT] = ss, ts, tt
    half = torch.sqrt(ss) <= scal[B_TOL]
    omega = ts / tt
    ctl[C_HALF] = half.to(torch.int32)
    scal[B_OMEGA] = omega
    scal[B_OMEGA_C] = torch.where(torch.isfinite(omega) & ~half, omega, torch.zeros_like(omega))


def finish_update(work: BicgstabWork, rn: torch.Tensor, rho_pref: torch.Tensor) -> None:
    """The scalar step after kernel 3: the breakdown taxonomy on the step's
    unclamped β, α, ω and ‖r'‖, k, hist[k], done, the sticky breakdown flag,
    live, the norms, and the next step's ρ and β."""
    scal, ctl = work.scal, work.ctl
    scal[B_RN], scal[B_RHO_PREF] = rn, rho_pref
    rnorm = torch.sqrt(rn)
    beta, alpha, omega, rho_new = (scal[i].clone() for i in (B_BETA, B_ALPHA, B_OMEGA,
                                                             B_RHO_NEXT))
    half = ctl[C_HALF].bool()
    finite = (torch.isfinite(beta) & torch.isfinite(alpha) & torch.isfinite(omega)
              & torch.isfinite(rnorm))
    converged = half | (finite & (rnorm <= scal[B_TOL]))
    broke = (~finite & ~half) | (finite & ((omega == 0) | (rho_new == 0)) & ~converged)
    k = ctl[C_K] + 1
    ctl[C_K] = k
    work.hist.index_put_((k.long().reshape(1),), rnorm.reshape(1))
    done = ctl[C_DONE].bool() | converged | broke
    ctl[C_DONE] = done.to(torch.int32)
    ctl[C_BROKE] = ctl[C_BROKE] | broke.to(torch.int32)
    ctl[C_LIVE] = ((~done) & (k < ctl[C_MAXITER])).to(torch.int32)
    scal[B_RNORM_PREV] = scal[B_RNORM].clone()
    scal[B_RNORM] = rnorm
    scal[B_RHO] = rho_new
    scal[B_RHO_NEXT] = rho_pref
    set_beta(scal, rho_pref)


def _one_f32(name, **scalars) -> None:
    for what, t in scalars.items():
        if t.numel() != 1 or t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be one float32")


def _check_tiles(name, blocks, block_cols):
    if blocks.dim() != 4:
        raise ValueError(f"{name}: blocks must be (nrb, kmax, bm, bn), got "
                         f"{tuple(blocks.shape)}")
    nrb, kmax, bm, bn = blocks.shape
    if bm != bn:
        raise ValueError(f"fused kernel needs square tiles, got {bm}x{bn}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"{name}: tiles must be float32, got {blocks.dtype} "
                        "(bf16 tiles are not ported yet)")
    if tuple(block_cols.shape) != (nrb, kmax) or block_cols.dtype != torch.int32:
        raise ValueError(f"{name}: block_cols must be ({nrb}, {kmax}) int32")
    return nrb, kmax, bn


def _check_vectors(name, shape, vecs):
    for v in vecs:
        if v is not None and (tuple(v.shape) != tuple(shape) or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must be {tuple(shape)} float32, got "
                             f"{tuple(v.shape)} {v.dtype}")


def _check_out(name, out, n_out, gathered, own=()):
    """``out`` holds ``n_out`` distinct buffers of the vectors' shape; none
    may lie on a ``gathered`` input (other CTAs read every row of those
    while a row's owner writes).  ``own`` pairs an output index with the
    one input it may replace (read and written by the same thread)."""
    if out is None:
        return
    if len(out) != n_out:
        raise ValueError(f"{name}: out must hold {n_out} buffers")
    ptrs = [o.data_ptr() for o in out]
    if len(set(ptrs)) != n_out:
        raise ValueError(f"{name}: out buffers must be distinct")
    banned = {g.data_ptr() for g in gathered if g is not None}
    allowed = dict(own)
    for i, p in enumerate(ptrs):
        if p in banned and allowed.get(i) != p:
            raise ValueError(f"{name}: an out buffer aliases an input that other "
                             "rows gather (double-buffer it)")


def _operands(r2d, work, out, dots, n_out):
    """A launch's work, dot outputs and vector outputs: a solve's own (its
    dots live in its work, valid until its next step), or new ones."""
    if work is None:
        work = BicgstabWork.new(r2d.device)
        dots = tuple(r2d.new_empty(1, 1) for _ in dots)
    else:
        dots = tuple(work.dots[i] for i in dots)
    if out is None:
        out = tuple(torch.empty_like(r2d) for _ in range(n_out))
    return work, dots, out


def _launch_cuda(name, entry, operator, vecs, scalars, outs, dots, work, grid, sizes):
    """One launch of a tile or packed kernel: ``operator`` (tiles and
    columns, or the packed view's four tensors) and ``sizes`` lead and end
    the C arguments; ``work.partials`` grows to ``len(dots)`` per CTA."""
    from ._build import load_library

    dev = vecs[0].device
    check_cuda_operands(name, (*operator, *vecs, *scalars, *outs))
    if work.partials.numel() < len(dots) * grid:
        work.partials = torch.empty(len(dots) * grid, device=dev)
    err = getattr(load_library(), entry)(
        *(ptr(t) for t in operator), *(ptr(v) for v in vecs), *(ptr(s) for s in scalars),
        *(ptr(o) for o in outs), *(ptr(d) for d in dots), ptr(work.partials),
        ptr(work.counter), ptr(work.scal), ptr(work.ctl), *sizes, stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)


def _tile_launch_cuda(name, entry, blocks, block_cols, vecs, scalars, outs, dots, work,
                      row_group):
    nrb, kmax, _, bn = blocks.shape
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    if row_group is None:
        row_group = auto_row_group(nrb, blocks.device)
    _launch_cuda(name, entry, (blocks, block_cols), vecs, scalars, outs, dots, work,
                 -(-nrb // row_group), (nrb, kmax, bn, row_group))


def _packed_launch_cuda(name, entry, pk, vecs, scalars, outs, dots, work):
    _launch_cuda(name, entry, (pk.vals, pk.cols, pk.row_len, pk.chunk_off), vecs, scalars,
                 outs, dots, work, -(-pk.rows // _THREADS), (pk.rows,))


# ---- kernel 18 -----------------------------------------------------------------

def bicgstab_dir_spmv_dot(
    blocks: torch.Tensor,
    block_cols: torch.Tensor,
    r2d: torch.Tensor,
    p2d: torch.Tensor,
    v2d: torch.Tensor,
    rhat2d: torch.Tensor,
    beta: torch.Tensor,
    omega: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    row_group: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[BicgstabWork] = None,
):
    """Kernel 1 of the fused BiCGStab iteration: ``(p', p̂, v', rv)``.

    ``blocks`` (nrb, kmax, bn, bn) float32 and ``block_cols`` (nrb, kmax)
    int32 (a square padded system); the vectors and ``inv_diag2d`` (nrb,
    bn) float32; ``beta`` and ``omega`` one float32 each (β arrives
    clamped).  Returns three (nrb, bn) vectors and rv (1, 1).

    ``out``: (p', p̂, v') buffers to fill.  Every CTA gathers rows of r, p,
    v and d, so no output may lie on them: the solver double-buffers p and
    v (r̂₀, read at the dot, is refused too).  ``row_group``: block-rows per CTA (None: ``auto_row_group``).
    ``work``: see module doc.
    """
    name = "bicgstab_dir_spmv_dot"
    nrb, _, bn = _check_tiles(name, blocks, block_cols)
    vecs = _check_dir(name, (nrb, bn), r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out)
    if row_group is not None and row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if not on_cuda(name, blocks, block_cols, *vecs, beta, omega, *_extra(out, work)):
        return _tile_dir_plain(blocks, block_cols, r2d, p2d, v2d, rhat2d, beta, omega,
                               inv_diag2d, out, work)
    work, dots, out = _operands(r2d, work, out, (0,), 3)
    _tile_launch_cuda(name, "bicgstab_dir", blocks, block_cols, vecs, (beta, omega), out, dots,
                      work, row_group)
    return (*out, *dots)


def bicgstab_dir_spmv_dot_packed(
    pk,
    r2d: torch.Tensor,
    p2d: torch.Tensor,
    v2d: torch.Tensor,
    rhat2d: torch.Tensor,
    beta: torch.Tensor,
    omega: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[BicgstabWork] = None,
):
    """Kernel 1 on full blocked-ELL storage read as its packed nonzeros
    ``pk`` (``BlockedEllMatrix.packed()``, float32): the contract of
    :func:`bicgstab_dir_spmv_dot` for a square padded system of ``pk.rows``
    rows, vectors (nrb, bn) float32 with nrb·bn = ``pk.rows``.  Any tile
    width."""
    name = "bicgstab_dir_spmv_dot_packed"
    shape = check_packed_vectors(name, pk, r2d)
    vecs = _check_dir(name, shape, r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out)
    if not on_cuda(name, pk.vals, pk.cols, pk.row_len, pk.chunk_off, *vecs, beta, omega,
                   *_extra(out, work)):
        return _packed_dir_plain(pk, r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out, work)
    work, dots, out = _operands(r2d, work, out, (0,), 3)
    _packed_launch_cuda(name, "bicgstab_dir_packed", pk, vecs, (beta, omega), out, dots, work)
    return (*out, *dots)


def _check_dir(name, shape, r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out):
    vecs = (r2d, p2d, v2d, rhat2d, inv_diag2d)
    _check_vectors(name, shape, (*vecs, *(out or ())))
    _one_f32(name, beta=beta, omega=omega)
    _check_out(name, out, 3, vecs)
    return vecs


def _tile_dir_plain(blocks, block_cols, r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out,
                    work):
    return _dir_plain("bicgstab_dir_spmv_dot", lambda y: bell_apply(blocks, block_cols, y),
                      r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out, work)


def _packed_dir_plain(pk, r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out, work):
    return _dir_plain("bicgstab_dir_spmv_dot_packed", packed_product(pk),
                      r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out, work)


def _dir_plain(name, apply, r2d, p2d, v2d, rhat2d, beta, omega, inv_diag2d, out, work):
    """Plain kernel 1 with the product ``apply`` (the tiles' or the packed
    view's), and its scalar step (α) on ``work``."""
    if r2d.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    if work is not None and not _live(work):
        return (*out, work.scal.new_zeros(1, 1))
    pn = r2d + beta.reshape(()) * (p2d - omega.reshape(()) * v2d)
    ph = pn if inv_diag2d is None else inv_diag2d * pn
    vn = apply(ph)
    rv = torch.sum(rhat2d * vn).reshape(1, 1)
    res = (pn, ph, vn)
    if out is not None:
        for o, t in zip(out, res):
            o.copy_(t)
        res = out
    if work is not None:
        finish_dir(work, rv[0, 0])
    return (*res, rv)


# ---- kernel 19 -----------------------------------------------------------------

def bicgstab_s_spmv_dot(
    blocks: torch.Tensor,
    block_cols: torch.Tensor,
    r2d: torch.Tensor,
    vnew2d: torch.Tensor,
    x2d: torch.Tensor,
    phat2d: torch.Tensor,
    alpha: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    row_group: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[BicgstabWork] = None,
):
    """Kernel 2: ``(s, ŝ, x_h, t, s·s, t·s, t·t)``, with the operands of
    :func:`bicgstab_dir_spmv_dot`; ``alpha`` one float32 (arrives
    clamped).

    ``out``: (s, ŝ, x_h, t) buffers to fill.  Every CTA gathers rows of r,
    v' and d, so no output may lie on them; x_h may be ``x2d`` itself (each
    element is read and written by its owner only), but the solver writes
    it into the other x buffer, which keeps the previous x for a breakdown.
    """
    name = "bicgstab_s_spmv_dot"
    nrb, _, bn = _check_tiles(name, blocks, block_cols)
    vecs = _check_s(name, (nrb, bn), r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out)
    if row_group is not None and row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if not on_cuda(name, blocks, block_cols, *vecs, alpha, *_extra(out, work)):
        return _tile_s_plain(blocks, block_cols, r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d,
                             out, work)
    work, dots, out = _operands(r2d, work, out, (1, 2, 3), 4)
    _tile_launch_cuda(name, "bicgstab_s", blocks, block_cols, vecs, (alpha,), out, dots, work,
                      row_group)
    return (*out, *dots)


def bicgstab_s_spmv_dot_packed(
    pk,
    r2d: torch.Tensor,
    vnew2d: torch.Tensor,
    x2d: torch.Tensor,
    phat2d: torch.Tensor,
    alpha: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[BicgstabWork] = None,
):
    """Kernel 2 on the packed nonzeros ``pk``: the contract of
    :func:`bicgstab_s_spmv_dot` with the operator and vectors of
    :func:`bicgstab_dir_spmv_dot_packed`."""
    name = "bicgstab_s_spmv_dot_packed"
    shape = check_packed_vectors(name, pk, r2d)
    vecs = _check_s(name, shape, r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out)
    if not on_cuda(name, pk.vals, pk.cols, pk.row_len, pk.chunk_off, *vecs, alpha,
                   *_extra(out, work)):
        return _packed_s_plain(pk, r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out, work)
    work, dots, out = _operands(r2d, work, out, (1, 2, 3), 4)
    _packed_launch_cuda(name, "bicgstab_s_packed", pk, vecs, (alpha,), out, dots, work)
    return (*out, *dots)


def _check_s(name, shape, r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out):
    vecs = (r2d, vnew2d, x2d, phat2d, inv_diag2d)
    _check_vectors(name, shape, (*vecs, *(out or ())))
    _one_f32(name, alpha=alpha)
    _check_out(name, out, 4, (r2d, vnew2d, inv_diag2d, phat2d, x2d), own=((2, x2d.data_ptr()),))
    return vecs


def _tile_s_plain(blocks, block_cols, r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out, work):
    return _s_plain("bicgstab_s_spmv_dot", lambda y: bell_apply(blocks, block_cols, y),
                    r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out, work)


def _packed_s_plain(pk, r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out, work):
    return _s_plain("bicgstab_s_spmv_dot_packed", packed_product(pk),
                    r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out, work)


def _s_plain(name, apply, r2d, vnew2d, x2d, phat2d, alpha, inv_diag2d, out, work):
    """Plain kernel 2 with the product ``apply``, and its scalar step (the
    half-step test, ω) on ``work``."""
    if r2d.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    if work is not None and not _live(work):
        z = work.scal.new_zeros(1, 1)
        return (*out, z, z, z)
    a = alpha.reshape(())
    s = r2d - a * vnew2d
    sh = s if inv_diag2d is None else inv_diag2d * s
    xh = x2d + a * phat2d
    t = apply(sh)
    ss, ts, tt = (torch.sum(u * w).reshape(1, 1) for u, w in ((s, s), (t, s), (t, t)))
    res = (s, sh, xh, t)
    if out is not None:
        for o, v in zip(out, res):
            o.copy_(v)
        res = out
    if work is not None:
        finish_s(work, ss[0, 0], ts[0, 0], tt[0, 0])
    return (*res, ss, ts, tt)


# ---- kernel 20 -----------------------------------------------------------------

def bicgstab_update_dot(
    xh2d: torch.Tensor,
    shat2d: torch.Tensor,
    s2d: torch.Tensor,
    t2d: torch.Tensor,
    rhat2d: torch.Tensor,
    omega: torch.Tensor,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[BicgstabWork] = None,
):
    """Kernel 3: ``(x', r', r'·r', r̂₀·r')`` with x' = x_h + ω·ŝ and r' =
    s − ω·t; vectors of one shape and any length, float32; ``omega`` one
    float32 (arrives clamped; 0 gives the half-step exit's x_h and s).
    ``out``: (x', r') buffers, which may be any of the inputs (each element
    is read and written by one thread): the solver writes x' over x_h and
    r' over the old r."""
    name = "bicgstab_update_dot"
    _check_vectors(name, xh2d.shape, (xh2d, shat2d, s2d, t2d, rhat2d, *(out or ())))
    _one_f32(name, omega=omega)
    if out is not None and (len(out) != 2 or out[0].data_ptr() == out[1].data_ptr()):
        raise ValueError(f"{name}: out must be two distinct buffers (x', r')")
    vecs = (xh2d, shat2d, s2d, t2d, rhat2d)
    if not on_cuda(name, *vecs, omega, *_extra(out, work)):
        return _update_plain(*vecs, omega, out, work)
    from ._build import load_library

    dev = xh2d.device
    if work is None:
        work = BicgstabWork.new(dev)
        rn, rho = xh2d.new_empty(1, 1), xh2d.new_empty(1, 1)
    else:
        rn, rho = work.dots[4:6]
    if out is None:
        out = (torch.empty_like(xh2d), torch.empty_like(xh2d))
    check_cuda_operands(name, vecs + (omega,) + out, vec4=vecs + out)
    n = xh2d.numel()
    grid = max(1, min(-(-n // (4 * _THREADS)), _UPDATE_MAX_GRID))
    if work.partials.numel() < 2 * grid:
        work.partials = torch.empty(2 * grid, device=dev)
    err = load_library().bicgstab_update(
        ptr(omega), *(ptr(v) for v in vecs), *(ptr(o) for o in out), ptr(rn), ptr(rho),
        ptr(work.partials), ptr(work.counter), ptr(work.scal), ptr(work.ctl),
        ptr(work.hist), work.hist.numel(), n, grid, stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return (*out, rn, rho)


def _update_plain(xh2d, shat2d, s2d, t2d, rhat2d, omega, out, work):
    if xh2d.is_cuda:
        PLAIN_ON_CUDA["bicgstab_update_dot"] += 1
    if work is not None and not _live(work):
        z = work.scal.new_zeros(1, 1)
        return (*out, z, z)
    w = omega.reshape(())
    x_new = xh2d + w * shat2d
    r_new = s2d - w * t2d
    rn = torch.sum(r_new * r_new).reshape(1, 1)
    rho = torch.sum(rhat2d * r_new).reshape(1, 1)
    if out is not None:
        out[0].copy_(x_new)
        out[1].copy_(r_new)
        x_new, r_new = out
    if work is not None:
        finish_update(work, rn[0, 0], rho[0, 0])
    return x_new, r_new, rn, rho
