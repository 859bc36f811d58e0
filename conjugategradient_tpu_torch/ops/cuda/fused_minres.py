"""The fused MINRES iteration's kernels: hand-written CUDA for Hopper
(``csrc/fused_minres.cu``), each beside its plain-torch version.

Counterpart of ``conjugategradient_tpu/ops/pallas/fused_minres.py``:

* :func:`minres_dir_spmv_dot` — one pass over full blocked-ELL tiles:
  the PREVIOUS iteration's solution update w = (v_prev − ε̄·w₋₂ − δ̄·w₋₁)·(1/γ̄),
  x += φ̄·w; the Lanczos vector v = (d⊙r2)·(1/β) (d: Jacobi, or absent);
  q = A·v − σ·v; the dots v·q and v·r1 (replaces ``minres_dir_spmv_dot``,
  fused_minres.py:113);
* :func:`sym_minres_dir_spmv_dot` — the same on symmetric tiles D + U + Uᵀ
  (replaces ``sym_minres_dir_spmv_dot``, fused_minres.py:298);
* :func:`minres_dir_spmv_dot_packed` — the same as either of the two on
  the operator's packed nonzeros (``BlockedEllMatrix.packed()`` or
  ``SymBellMatrix.packed()``, whose view holds D + U + Uᵀ), for sparse
  tiles (``ops/spmv.bell_packed_route``): one kernel for both storages,
  counted as ``minres_dir_spmv_dot_packed`` or
  ``sym_minres_dir_spmv_dot_packed`` by the view's storage.  The three
  share one plain body, which takes the product as a callable; the packed
  form's is ``bell_spmv.packed_apply``, whose order and rounding the
  kernel copies, so the two match bit for bit in every vector;
* :func:`minres_update_dot` — r2' = q − c1·r1 − ia·r2 and β² = r2'·(d⊙r2')
  (replaces ``minres_update_dot``, fused_minres.py:425);
* :func:`minres_shard_spmv_dot` — one shard of the row-sharded loop: the
  pending w/x update on the shard's rows, q = A_loc·v − σ·v_window on the
  all-gathered v, and the partials v·q and v·r1 (replaces
  ``minres_shard_spmv_dot``, fused_minres.py:528).

Dispatch is that of ``ops/cuda/fused_cg.py``: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors, no fallback between them;
``LAUNCHES`` and ``PLAIN_ON_CUDA`` (``_common``) count per wrapper.

Inside a solve the wrappers take a :class:`MinresWork`: the device scalars
of the recurrence, the control words, the history and scratch.  The
kernels' final reductions then do the solver's scalar steps on the device
(kernel 1: c1, α, α/β; kernel 2: β' = √β², the Givens rotation, the next
pending-update scalars, k, hist[k], done, the sticky NaN flag, live), and
every kernel is a no-op once ``live`` is 0; the (1, 1) dots a kernel
returns are then views of the work's scalars, valid until the solve's next
step.  The plain versions do the same
scalar steps with torch 0-d float32 ops, one rounding per product and sum,
as the kernels' ``__fmul_rn``/``__fadd_rn`` tails do.

The row-sharded loop (``parallel/loops.py``) steps only after summing every
shard's dots: there kernel 2 runs with ``partials_only=True`` (this shard's
β² only; ``work.ctl`` still makes a step after the end a no-op), and
:func:`minres_shard_spmv_dot` never steps; the loop runs :func:`finish_dir`
and :func:`finish_update` on the summed dots.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..spmv import bell_apply, sym_bell_apply
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
from .fused_cg import (C_DONE, C_K, C_LIVE, C_MAXITER, _extra, _live,  # noqa: F401
                       auto_row_group, put_hist)

# slots of the (1, 8) scalar row kernel 1 reads (the JAX kernels' SU_* row)
SU_INV_BETA = 0
SU_SHIFT = 1
SU_OLDEPS = 2  # ε̄ of the pending (previous-iteration) solution update
SU_DELTA = 3  # δ̄ of the pending update
SU_IGAMMA = 4  # 1/γ̄ of the pending update (0: no pending update)
SU_PHI = 5  # φ̄ of the pending update
# the rest of MinresWork.scal, shared with csrc/fused_minres.cu
M_BETA, M_OLDB, M_DBAR, M_EPSLN, M_PHIBAR, M_CS, M_SN, M_TOL, M_C1, M_IA, M_ALFA = range(8, 19)
# where a solve's kernels leave their dots (their (1, 1) outputs, no allocation)
M_VQ, M_VR1, M_BSQ = 19, 20, 21
N_SCAL = 24
# control words: fused_cg's four, and the sticky NaN flag
C_NAN = 4

MIRRORS = ("scatter", "banded")
_UPDATE_MAX_GRID = 1024
_THREADS = 256
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass
class MinresWork:
    """Device scalars, history and scratch of one fused MINRES solve."""

    scal: torch.Tensor  # (24,) f32: the SU_* row, then the M_* slots
    ctl: torch.Tensor  # (5,) i32: k, done, maxiter, live, nan
    hist: torch.Tensor  # (maxiter + 1,) f32 φ̄ per iteration, NaN past k
    partials: torch.Tensor  # f32 per-CTA dot partials (two dots in kernel 1)
    counter: torch.Tensor  # (1,) i32 arrival ticket, 0 between launches
    tparts: Optional[torch.Tensor] = None  # general mirror landing buffer
    # views of scal, the per-step kernel operands: made once, since a view
    # costs a few microseconds of host time every step
    su: torch.Tensor = dataclasses.field(init=False, repr=False)
    c1: torch.Tensor = dataclasses.field(init=False, repr=False)
    ia: torch.Tensor = dataclasses.field(init=False, repr=False)
    dots: tuple = dataclasses.field(init=False, repr=False)  # vq, vr1, bsq

    @staticmethod
    def new(device, maxiter: int = 1, tol: float = 0.0, shift: float = 0.0) -> "MinresWork":
        device = torch.device(device)
        scal = torch.zeros(N_SCAL, dtype=torch.float32)
        scal[M_TOL] = tol
        scal[SU_SHIFT] = shift
        scal[M_CS] = -1.0
        ctl = torch.tensor([0, 0, maxiter, int(maxiter > 0), 0], dtype=torch.int32)
        return MinresWork(
            scal=scal.to(device),
            ctl=ctl.to(device),
            hist=torch.full((maxiter + 1,), float("nan"), device=device),
            partials=torch.empty(2 * _UPDATE_MAX_GRID, device=device),
            counter=torch.zeros(1, dtype=torch.int32, device=device),
        )

    def scalar(self, i: int) -> torch.Tensor:
        """(1, 1) view of scalar ``i`` (a kernel operand, no copy)."""
        return self.scal[i:i + 1].view(1, 1)

    def __post_init__(self):
        self.su = self.scal[:8].view(1, 8)
        self.c1 = self.scalar(M_C1)
        self.ia = self.scalar(M_IA)
        self.dots = tuple(self.scalar(i) for i in (M_VQ, M_VR1, M_BSQ))

    def start(self, beta1: torch.Tensor) -> None:
        """Enter β₁ = φ̄₀ (a 0-d tensor): the scalars, hist[0], and done at
        once when β₁ is NaN or already within the tolerance."""
        scal, ctl = self.scal, self.ctl
        scal[M_BETA] = beta1
        scal[M_PHIBAR] = beta1
        scal[SU_INV_BETA] = torch.div(torch.ones_like(beta1), beta1)
        self.hist[0] = beta1
        nan = torch.isnan(beta1)
        done = nan | (beta1 <= scal[M_TOL])
        ctl[C_NAN] = nan.to(torch.int32)
        ctl[C_DONE] = done.to(torch.int32)
        ctl[C_LIVE] = ((~done) & (ctl[C_K] < ctl[C_MAXITER])).to(torch.int32)


def finish_dir(work: MinresWork, vq: torch.Tensor, vr1: torch.Tensor) -> None:
    """The scalar step after kernel 1 (its last CTA does the same): c1 =
    β/β_old (0 on the first step, which has no v_{k−1} term), α = v·q −
    c1·(v·r1), and α/β for kernel 2.  ``vq``, ``vr1``: 0-d float32.  Not
    masked: once the solve is not live, kernel 2 and :func:`finish_update`
    ignore these three."""
    scal = work.scal
    beta, oldb = scal[M_BETA], scal[M_OLDB]
    noprev = oldb == 0
    c1 = torch.where(noprev, 0.0, beta / torch.where(noprev, 1.0, oldb))
    alfa = vq - c1 * vr1
    ia = alfa / beta
    scal[M_C1:M_ALFA + 1] = torch.stack([c1, ia, alfa])


#: the scalar slots :func:`finish_update` writes, in the order it stacks them
_UPDATE_SLOTS = (SU_OLDEPS, SU_DELTA, SU_IGAMMA, SU_PHI, SU_INV_BETA, M_OLDB, M_BETA,
                 M_DBAR, M_EPSLN, M_PHIBAR, M_CS, M_SN)


@functools.lru_cache(maxsize=None)
def _update_slots(device: torch.device) -> torch.Tensor:
    return torch.tensor(_UPDATE_SLOTS, dtype=torch.long, device=device)


def finish_update(work: MinresWork, bsq: torch.Tensor) -> None:
    """The scalar step after kernel 2 (its last CTA does the same): β' =
    √β², the Givens rotation, the scalars of the solution update that the
    next kernel 1 applies, hist[k] = φ̄, k, done, the NaN flag and live; a
    no-op once the solve is not live."""
    scal, ctl = work.scal, work.ctl
    live = ctl[C_LIVE] != 0
    (beta, dbar0, oldeps, phibar0, cs0, sn0, tol, alfa) = (
        scal[i] for i in (M_BETA, M_DBAR, M_EPSLN, M_PHIBAR, M_CS, M_SN, M_TOL, M_ALFA))
    beta_new = torch.sqrt(bsq)  # NaN iff M is not SPD
    delta = cs0 * dbar0 + sn0 * alfa
    gbar = sn0 * dbar0 - cs0 * alfa
    epsln_new = sn0 * beta_new
    dbar_new = (-cs0) * beta_new
    gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta_new * beta_new), _TINY)
    cs_new = gbar / gamma
    sn_new = beta_new / gamma
    phi = cs_new * phibar0
    phibar_new = sn_new * phibar0
    one = torch.ones_like(gamma)
    k = ctl[C_K] + live.to(torch.int32)
    put_hist(work.hist, k, live, phibar_new)
    is_nan = torch.isnan(phibar_new) | torch.isnan(beta_new)
    done = is_nan | (phibar_new <= tol) | (beta_new == 0)
    vals = torch.stack([oldeps, delta, torch.div(one, gamma), phi, torch.div(one, beta_new),
                        beta, beta_new, dbar_new, epsln_new, phibar_new, cs_new, sn_new])
    slots = _update_slots(scal.device)
    scal.index_put_((slots,), torch.where(live, vals, scal[slots]))
    ctl.copy_(torch.stack([
        k, torch.where(live, done.to(torch.int32), ctl[C_DONE]), ctl[C_MAXITER],
        (live & ~done & (k < ctl[C_MAXITER])).to(torch.int32),
        ctl[C_NAN] | (live & is_nan).to(torch.int32)]))


# ---- kernels 14 and 15 ------------------------------------------------------

def _check_dir_operands(name, nrb, bn, vecs, su, inv_diag2d, out):
    for v in (*vecs, inv_diag2d):
        if v is not None and (tuple(v.shape) != (nrb, bn) or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must be ({nrb}, {bn}) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if tuple(su.shape) != (1, 8) or su.dtype != torch.float32:
        raise ValueError(f"{name}: su must be (1, 8) float32")
    if out is None:
        return
    if len(out) != 4:
        raise ValueError(f"{name}: out must be (v, q, w_new, x_new)")
    r2, r1, vprev, wm1, wm2, x = vecs
    for o in out:
        if tuple(o.shape) != (nrb, bn) or o.dtype != torch.float32:
            raise ValueError(f"{name}: out buffers must be ({nrb}, {bn}) float32")
    ptrs = [o.data_ptr() for o in out]
    if len(set(ptrs)) != 4:
        raise ValueError(f"{name}: out buffers must be distinct")
    # other CTAs gather r2 (and d) while the owner of a row writes: no
    # output may lie on them; r1 and w-1 are read after x is written.  An
    # output may only lie on the input it replaces.
    inputs = {v.data_ptr() for v in (*vecs, inv_diag2d) if v is not None}
    replaces = (vprev.data_ptr(), None, wm2.data_ptr(), x.data_ptr())
    for p, own, what in zip(ptrs, replaces, ("v", "q", "w_new", "x_new")):
        if p in inputs and p != own:
            raise ValueError(
                f"{name}: {what} must not alias an input other than "
                "the one it replaces (v: v_prev, w_new: w-2, x_new: x)")


def minres_dir_spmv_dot(
    blocks: torch.Tensor,
    block_cols: torch.Tensor,
    r2_2d: torch.Tensor,
    r1_2d: torch.Tensor,
    vprev2d: torch.Tensor,
    wm1_2d: torch.Tensor,
    wm2_2d: torch.Tensor,
    x2d: torch.Tensor,
    su: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    row_group: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[MinresWork] = None,
):
    """Kernel 1 of the fused MINRES iteration on full blocked-ELL storage.

    ``blocks`` (nrb, kmax, bn, bn) float32, ``block_cols`` (nrb, kmax)
    int32; the six vectors and ``inv_diag2d`` (nrb, bn) float32 (a square
    padded system); ``su`` (1, 8) float32, the ``SU_*`` slots.  Returns
    ``(v, q, w_new, x_new, vq, vr1)``: four (nrb, bn) vectors and two
    (1, 1) dots; v·q uses the shifted q.

    ``out``: (v, q, w_new, x_new) buffers to fill.  v may be ``vprev2d``
    itself, w_new may be ``wm2_2d`` and x_new may be ``x2d`` (each element
    is read and written by its owner only); no other aliasing is allowed.
    ``row_group``: block-rows per CTA (None: ``auto_row_group``).
    ``work``: see module doc.
    """
    name = "minres_dir_spmv_dot"
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
    vecs = (r2_2d, r1_2d, vprev2d, wm1_2d, wm2_2d, x2d)
    _check_dir_operands(name, nrb, bn, vecs, su, inv_diag2d, out)
    if row_group is not None and row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if not on_cuda(name, blocks, block_cols, *vecs, su, inv_diag2d, *_extra(out, work)):
        return _dir_plain(name, lambda v: bell_apply(blocks, block_cols, v),
                          vecs, su, inv_diag2d, out, work)
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    if row_group is None:
        row_group = auto_row_group(nrb, r2_2d.device)

    def launch(lib, common, w):
        return lib.minres_full_dir(ptr(blocks), ptr(block_cols), *common,
                                   nrb, kmax, bn, row_group, stream(r2_2d.device))

    return _dir_cuda(name, (blocks, block_cols), vecs, su, inv_diag2d, out, work,
                     -(-nrb // row_group), launch)


def sym_minres_dir_spmv_dot(
    diag_blocks: torch.Tensor,
    off_blocks: torch.Tensor,
    off_cols: torch.Tensor,
    r2_2d: torch.Tensor,
    r1_2d: torch.Tensor,
    vprev2d: torch.Tensor,
    wm1_2d: torch.Tensor,
    wm2_2d: torch.Tensor,
    x2d: torch.Tensor,
    su: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    mirror_src: torch.Tensor,
    mirror: str = "scatter",
    row_group: int = 8,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[MinresWork] = None,
):
    """Kernel 1 on symmetric blocked-ELL storage: the contract of
    :func:`minres_dir_spmv_dot` with the operator as ``diag_blocks``
    (nrb, bn, bn), ``off_blocks`` (nrb, ku, bn, bn) and ``off_cols``
    (nrb, ku) int32.

    ``mirror``: ``"scatter"`` lands each slot's Bᵀ product in its block-row
    in the fixed order of ``mirror_src`` (``SymBellMatrix.mirror_src``), in
    a second launch which also applies the shift and takes the dots, since
    a row's q is final only there; ``"banded"`` (block-tridiagonal storage
    only; the caller checks ``SymBellMatrix.banded``) carries each row's
    mirror into the next row, with a one-tile halo per CTA strip of
    ``row_group`` rows.
    """
    name = "sym_minres_dir_spmv_dot"
    if mirror not in MIRRORS:
        raise ValueError(f"unknown mirror scheme {mirror!r}")
    nrb, bm, bn = diag_blocks.shape
    if bm != bn:
        raise ValueError(f"fused kernel needs square tiles, got {bm}x{bn}")
    if (off_blocks.dim() != 4 or off_blocks.shape[0] != nrb
            or tuple(off_blocks.shape[2:]) != (bm, bn)):
        raise ValueError(f"{name}: off_blocks shape {tuple(off_blocks.shape)}")
    ku = off_blocks.shape[1]
    if mirror == "banded" and ku != 1:
        raise ValueError("mirror='banded' requires ku == 1 storage")
    for t in (diag_blocks, off_blocks):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: tiles must be float32, got {t.dtype} "
                            "(bf16 tiles are not ported yet)")
    if tuple(off_cols.shape) != (nrb, ku) or off_cols.dtype != torch.int32:
        raise ValueError(f"{name}: off_cols must be ({nrb}, {ku}) int32")
    vecs = (r2_2d, r1_2d, vprev2d, wm1_2d, wm2_2d, x2d)
    _check_dir_operands(name, nrb, bn, vecs, su, inv_diag2d, out)
    if row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if (mirror_src.dim() != 2 or mirror_src.shape[0] != nrb
            or mirror_src.dtype != torch.int32):
        raise ValueError(f"{name}: mirror_src must be ({nrb}, kin) int32")
    if not on_cuda(name, diag_blocks, off_blocks, off_cols, mirror_src, *vecs, su,
                   inv_diag2d, *_extra(out, work)):
        return _dir_plain(
            name, lambda v: sym_bell_apply(diag_blocks, off_blocks, off_cols, mirror_src, v),
            vecs, su, inv_diag2d, out, work)
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    dev = r2_2d.device

    def launch(lib, common, w):
        if mirror == "banded":
            return lib.minres_sym_dir_banded(
                ptr(diag_blocks), ptr(off_blocks), ptr(off_cols), *common,
                nrb, bn, row_group, stream(dev))
        if w.tparts is None or w.tparts.numel() < nrb * ku * bn:
            w.tparts = torch.empty(nrb * ku * bn, device=dev)
        return lib.minres_sym_dir_general(
            ptr(diag_blocks), ptr(off_blocks), ptr(off_cols), ptr(mirror_src), *common,
            ptr(w.tparts), nrb, ku, mirror_src.shape[1], bn, row_group, stream(dev))

    return _dir_cuda(name, (diag_blocks, off_blocks, off_cols, mirror_src), vecs, su,
                     inv_diag2d, out, work, -(-nrb // row_group), launch)


def minres_dir_spmv_dot_packed(
    pk,
    r2_2d: torch.Tensor,
    r1_2d: torch.Tensor,
    vprev2d: torch.Tensor,
    wm1_2d: torch.Tensor,
    wm2_2d: torch.Tensor,
    x2d: torch.Tensor,
    su: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[MinresWork] = None,
):
    """Kernel 1 on the packed nonzeros ``pk`` (``types/bell.PackedBell``,
    float32) of either storage: the contract of :func:`minres_dir_spmv_dot`
    (the same returns and aliasing rules) for a square padded system of
    ``pk.rows`` rows, vectors (nrb, bn) float32 with nrb·bn = ``pk.rows``.
    Any tile width.  Launches are counted as ``sym_minres_dir_spmv_dot_packed``
    when ``pk.symmetric`` (kernel 15's function), else as
    ``minres_dir_spmv_dot_packed`` (kernel 14's)."""
    name = "sym_minres_dir_spmv_dot_packed" if pk.symmetric else "minres_dir_spmv_dot_packed"
    nrb, bn = check_packed_vectors(name, pk, r2_2d)
    vecs = (r2_2d, r1_2d, vprev2d, wm1_2d, wm2_2d, x2d)
    _check_dir_operands(name, nrb, bn, vecs, su, inv_diag2d, out)
    view = (pk.vals, pk.cols, pk.row_len, pk.chunk_off)
    if not on_cuda(name, *view, *vecs, su, inv_diag2d, *_extra(out, work)):
        return _dir_plain(name, packed_product(pk), vecs, su, inv_diag2d, out, work)

    def launch(lib, common, w):
        return lib.minres_dir_packed(*(ptr(t) for t in view), *common, pk.rows,
                                     stream(r2_2d.device))

    return _dir_cuda(name, view, vecs, su, inv_diag2d, out, work, -(-pk.rows // _THREADS),
                     launch)


def _dir_plain(name, apply, vecs, su, inv_diag2d, out, work):
    """Plain kernel 1: the pending w/x update, v, q = apply(v) − σ·v, the
    two dots, and the kernel's scalar step on ``work``."""
    r2, r1, vprev, wm1, wm2, x = vecs
    if r2.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    if work is not None and not _live(work):
        z = work.scal.new_zeros(1, 1)
        return (*out, z, z)
    s = su.reshape(-1)
    w_new = (vprev - s[SU_OLDEPS] * wm2 - s[SU_DELTA] * wm1) * s[SU_IGAMMA]
    x_new = x + s[SU_PHI] * w_new
    z = r2 if inv_diag2d is None else inv_diag2d * r2
    v = z * s[SU_INV_BETA]
    q = apply(v) - s[SU_SHIFT] * v
    vq = torch.sum(v * q).reshape(1, 1)
    vr1 = torch.sum(v * r1).reshape(1, 1)
    if out is not None:
        for o, t in zip(out, (v, q, w_new, x_new)):
            o.copy_(t)
        v, q, w_new, x_new = out
    if work is not None:
        finish_dir(work, vq[0, 0], vr1[0, 0])
    return v, q, w_new, x_new, vq, vr1


def _dir_cuda(name, operator, vecs, su, inv_diag2d, out, work, grid, launch):
    from ._build import load_library

    r2 = vecs[0]
    dev = r2.device
    if work is None:
        work = MinresWork.new(dev)
        vq, vr1 = r2.new_empty(1, 1), r2.new_empty(1, 1)
    else:  # a solve's dots live in its work: valid until its next step
        vq, vr1, _ = work.dots
    if out is None:
        out = tuple(torch.empty_like(r2) for _ in range(4))
    check_cuda_operands(name, (*operator, *vecs, su, inv_diag2d, *out))
    if work.partials.numel() < 2 * grid:
        work.partials = torch.empty(2 * grid, device=dev)
    common = (*(ptr(v) for v in vecs), ptr(inv_diag2d), ptr(su),
              *(ptr(o) for o in out), ptr(vq), ptr(vr1), ptr(work.partials),
              ptr(work.counter), ptr(work.scal), ptr(work.ctl))
    err = launch(load_library(), common, work)
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return (*out, vq, vr1)


# ---- kernel 17 ---------------------------------------------------------------

def minres_shard_spmv_dot(
    blocks: torch.Tensor,
    block_cols: torch.Tensor,
    vfull2d: torch.Tensor,
    r1_2d: torch.Tensor,
    vprev2d: torch.Tensor,
    wm1_2d: torch.Tensor,
    wm2_2d: torch.Tensor,
    x2d: torch.Tensor,
    su: torch.Tensor,
    row_offset: int,
    *,
    row_group: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, ...]] = None,
    work: Optional[MinresWork] = None,
):
    """One shard's kernel 1 of the row-sharded MINRES loop:
    ``(q, w_new, x_new, vq, vr1)``.

    ``blocks`` (nrb, kmax, bn, bn) float32 and ``block_cols`` (nrb, kmax)
    int32 GLOBAL column blocks; ``vfull2d`` the all-gathered, normalised
    Lanczos vector (ncb, bn); ``r1_2d``, ``vprev2d``, ``wm1_2d``,
    ``wm2_2d``, ``x2d`` this shard's (nrb, bn) float32 slices; ``su``
    (1, 8) float32, the ``SU_*`` slots (``SU_INV_BETA`` unused: v is
    normalised before the gather); ``row_offset`` this shard's first global
    row, a multiple of bn (a host int).  w_new = (v_prev − ε̄·w₋₂ −
    δ̄·w₋₁)·(1/γ̄), x_new = x + φ̄·w_new, q = A_loc·v − σ·v[window], and the
    partials vq = v[window]·q, vr1 = v[window]·r1 as (1, 1) views of one
    (2,) buffer.

    ``out``: (q, w_new, x_new, dots) buffers, dots a (2,) float32.  w_new
    may be ``wm2_2d`` and x_new may be ``x2d`` (each element is read and
    written by one thread); no other aliasing is allowed.  ``work``:
    scratch, and the solve's ``ctl`` (a step after the end is a no-op); the
    kernel does no scalar step.  ``row_group``: block-rows per CTA (None:
    ``auto_row_group``).
    """
    name = "minres_shard_spmv_dot"
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
    if vfull2d.dim() != 2 or vfull2d.shape[1] != bn or vfull2d.dtype != torch.float32:
        raise ValueError(f"{name}: vfull2d must be (ncb, {bn}) float32, got "
                         f"{tuple(vfull2d.shape)} {vfull2d.dtype}")
    row_offset = int(row_offset)
    if row_offset % bn or not 0 <= row_offset <= (vfull2d.shape[0] - nrb) * bn:
        raise ValueError(f"{name}: row_offset {row_offset} must be a multiple of "
                         f"{bn} with its {nrb} block-rows inside vfull2d")
    vecs = (r1_2d, vprev2d, wm1_2d, wm2_2d, x2d)
    for v in vecs:
        if tuple(v.shape) != (nrb, bn) or v.dtype != torch.float32:
            raise ValueError(f"{name}: local vectors must be ({nrb}, {bn}) float32, "
                             f"got {tuple(v.shape)} {v.dtype}")
    if tuple(su.shape) != (1, 8) or su.dtype != torch.float32:
        raise ValueError(f"{name}: su must be (1, 8) float32")
    if row_group is not None and row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if out is not None:
        _check_shard_out(name, nrb, bn, vfull2d, vecs, out)
    args = (blocks, block_cols, vfull2d, vecs, su, row_offset, out, work)
    if not on_cuda(name, blocks, block_cols, vfull2d, *vecs, su, *_extra(out, work)):
        return _shard_plain(*args)
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    if row_group is None:
        row_group = auto_row_group(nrb, vfull2d.device)
    return _shard_cuda(*args, row_group)


def _check_shard_out(name, nrb, bn, vfull2d, vecs, out):
    if len(out) != 4:
        raise ValueError(f"{name}: out must be (q, w_new, x_new, dots)")
    q, w, xo, dots = out
    for o in (q, w, xo):
        if tuple(o.shape) != (nrb, bn) or o.dtype != torch.float32:
            raise ValueError(f"{name}: out vectors must be ({nrb}, {bn}) float32")
    if dots.numel() != 2 or dots.dtype != torch.float32 or not dots.is_contiguous():
        raise ValueError(f"{name}: dots must be two contiguous float32")
    ptrs = [o.data_ptr() for o in out]
    if len(set(ptrs)) != 4:
        raise ValueError(f"{name}: out buffers must be distinct")
    # other CTAs read v; a row's r1 is read after its w is written.  An
    # output may only lie on the input it replaces.
    inputs = {v.data_ptr() for v in (vfull2d, *vecs)}
    r1, vprev, wm1, wm2, x = vecs
    for p, own, what in zip(ptrs, (None, wm2.data_ptr(), x.data_ptr(), None),
                            ("q", "w_new", "x_new", "dots")):
        if p in inputs and p != own:
            raise ValueError(f"{name}: {what} must not alias an input other than the "
                             "one it replaces (w_new: w-2, x_new: x)")


def _shard_plain(blocks, block_cols, vfull2d, vecs, su, row_offset, out, work):
    name = "minres_shard_spmv_dot"
    r1, vprev, wm1, wm2, x = vecs
    if r1.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    if out is None:
        out = (torch.empty_like(r1), torch.empty_like(r1), torch.empty_like(r1),
               r1.new_zeros(2))
    q_o, w_o, x_o, dots = out
    if work is None or _live(work):
        nrb, bn = blocks.shape[0], blocks.shape[3]
        s = su.reshape(-1)
        w_new = (vprev - s[SU_OLDEPS] * wm2 - s[SU_DELTA] * wm1) * s[SU_IGAMMA]
        x_new = x + s[SU_PHI] * w_new
        r0 = row_offset // bn
        vwin = vfull2d[r0:r0 + nrb]
        q = bell_apply(blocks, block_cols, vfull2d) - s[SU_SHIFT] * vwin
        dots.copy_(torch.stack([torch.sum(vwin * q), torch.sum(vwin * r1)]).reshape(dots.shape))
        q_o.copy_(q)
        w_o.copy_(w_new)
        x_o.copy_(x_new)
    flat = dots.reshape(-1)
    return q_o, w_o, x_o, flat[0:1].view(1, 1), flat[1:2].view(1, 1)


def _shard_cuda(blocks, block_cols, vfull2d, vecs, su, row_offset, out, work, row_group):
    from ._build import load_library

    name = "minres_shard_spmv_dot"
    nrb, kmax, _, bn = blocks.shape
    r1 = vecs[0]
    dev = r1.device
    if work is None:
        work = MinresWork.new(dev)
    if out is None:
        out = (torch.empty_like(r1), torch.empty_like(r1), torch.empty_like(r1),
               r1.new_empty(2))
    check_cuda_operands(name, (blocks, block_cols, vfull2d, *vecs, su, *out))
    grid = -(-nrb // row_group)
    if work.partials.numel() < 2 * grid:
        work.partials = torch.empty(2 * grid, device=dev)
    err = load_library().minres_shard_dir(
        ptr(blocks), ptr(block_cols), ptr(vfull2d), *(ptr(v) for v in vecs), ptr(su),
        *(ptr(o) for o in out), ptr(work.partials), ptr(work.counter), ptr(work.ctl),
        row_offset // bn, nrb, kmax, bn, row_group, stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    flat = out[3].reshape(-1)
    return (*out[:3], flat[0:1].view(1, 1), flat[1:2].view(1, 1))


# ---- kernel 16 ---------------------------------------------------------------

def minres_update_dot(
    q2d: torch.Tensor,
    r1_2d: torch.Tensor,
    r2_2d: torch.Tensor,
    c1: torch.Tensor,
    ia: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    out: Optional[torch.Tensor] = None,
    work: Optional[MinresWork] = None,
    partials_only: bool = False,
):
    """Kernel 2: ``(r2', βsq) = (q − c1·r1 − ia·r2, r2'·(d⊙r2'))``.

    Vectors of one shape, float32, a multiple of 4 entries; ``c1``
    (= β/β_old) and ``ia`` (= α/β) one float32 each.  ``out``: the r2'
    buffer, which may be any of the inputs (each element is read and
    written by one thread): the solver passes r1's.  Returns r2' and βsq
    (1, 1).  ``work``: see module doc; ``partials_only`` (with a ``work``):
    no scalar step, and βsq in a (1, 1) of its own.
    """
    name = "minres_update_dot"
    for v in (r1_2d, r2_2d, inv_diag2d, out):
        if v is not None and (v.shape != q2d.shape or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must share shape {tuple(q2d.shape)} and "
                             f"be float32, got {tuple(v.shape)} {v.dtype}")
    if q2d.dtype != torch.float32:
        raise ValueError(f"{name}: vectors must be float32, got {q2d.dtype}")
    for s in (c1, ia):
        if s.numel() != 1 or s.dtype != torch.float32:
            raise ValueError(f"{name}: c1 and ia must be one float32 each")
    if partials_only and work is None:
        raise ValueError(f"{name}: partials_only needs the solve's work")
    extra = _extra(None if out is None else (out,), work)
    args = (q2d, r1_2d, r2_2d, c1, ia, inv_diag2d, out, work, partials_only)
    if not on_cuda(name, q2d, r1_2d, r2_2d, c1, ia, inv_diag2d, *extra):
        return _update_plain(*args)
    return _update_cuda(*args)


def _update_plain(q2d, r1_2d, r2_2d, c1, ia, inv_diag2d, out, work, partials_only=False):
    if q2d.is_cuda:
        PLAIN_ON_CUDA["minres_update_dot"] += 1
    if work is not None and not _live(work):
        return (out if out is not None else r2_2d), work.scal.new_zeros(1, 1)
    y = q2d - c1.reshape(()) * r1_2d - ia.reshape(()) * r2_2d
    bsq = torch.sum((y if inv_diag2d is None else inv_diag2d * y) * y).reshape(1, 1)
    if out is not None:
        out.copy_(y)
        y = out
    if work is not None and not partials_only:
        finish_update(work, bsq[0, 0])
    return y, bsq


def _update_cuda(q2d, r1_2d, r2_2d, c1, ia, inv_diag2d, out, work, partials_only):
    from ._build import load_library

    name = "minres_update_dot"
    dev = q2d.device
    n = q2d.numel()
    if n % 4:
        raise ValueError(f"{name}: the CUDA kernel reads float4, got {n} entries")
    if work is None:
        work = MinresWork.new(dev)
        bsq = q2d.new_empty(1, 1)
    else:  # a solve's βsq lives in its work, a shard's in a (1, 1) of its own
        bsq = q2d.new_empty(1, 1) if partials_only else work.dots[2]
    if out is None:
        out = torch.empty_like(q2d)
    vecs = (q2d, r1_2d, r2_2d, inv_diag2d, out)
    check_cuda_operands(name, vecs + (c1, ia), vec4=vecs)
    grid = max(1, min(-(-n // (4 * _THREADS)), _UPDATE_MAX_GRID))
    if work.partials.numel() < grid:
        work.partials = torch.empty(grid, device=dev)
    err = load_library().minres_update(
        ptr(c1), ptr(ia), ptr(q2d), ptr(r1_2d), ptr(r2_2d), ptr(inv_diag2d),
        ptr(out), ptr(bsq), ptr(work.partials), ptr(work.counter),
        None if partials_only else ptr(work.scal), ptr(work.ctl), ptr(work.hist),
        work.hist.numel(), n, grid, stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return out, bsq
