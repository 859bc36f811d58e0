"""The fused CG iteration's kernels: hand-written CUDA for Hopper
(``csrc/fused_cg.cu``), each beside its plain-torch version.

Counterpart of ``conjugategradient_tpu/ops/pallas/fused_cg.py``:

* :func:`sym_fused_dir_spmv_dot` — (p_new, q, pap) = (z + β·p_old,
  (D+U+Uᵀ)·p_new, p_new·q) with z = d⊙r (Jacobi) or r, on symmetric
  blocked-ELL tiles (replaces ``sym_fused_dir_spmv_dot``, fused_cg.py:338);
* :func:`fused_dir_spmv_dot` — the same on full blocked-ELL tiles
  (replaces ``fused_dir_spmv_dot``, fused_cg.py:111), and
  :func:`fused_dir_spmv_dot_packed`, the same function on the tiles'
  packed nonzeros (``types/bell.PackedBell``), for sparse tiles;
* :func:`fused_update_dot` — (x + α·p, r − α·q, r'·r') (replaces
  ``fused_update_dot``, fused_cg.py:608);
* :func:`fused_update_dot_pcg` — the same plus ρ = Σ d·r'² (replaces
  ``fused_update_dot_pcg``, fused_cg.py:555);
* :func:`bell_spmv_dot` — (q, pap) = (A_loc·x, x[window]·q) on one shard of
  the row-sharded loop, x the all-gathered operand (replaces
  ``bell_spmv_dot``, fused_cg.py:467).

Dispatch: a wrapper runs its plain version when the tensors it is given lie
on the CPU, and launches its CUDA kernel when they lie on a CUDA device;
anything else raises.  There is no fallback from a CUDA tensor to the plain
version.  ``LAUNCHES`` and ``PLAIN_ON_CUDA`` (``_common``) count kernel
launches and plain-version calls given CUDA tensors, per wrapper.

Inside a solve the wrappers also take a :class:`FusedWork`: the device
scalars of the solve (ρ, ‖r‖², β, α, tol; k, done, maxiter, live), the
residual history and reusable scratch.  The kernels' final reductions then
perform the solver's scalar step on the device (K1: α; K2: done, β, k,
hist[k], live), and every kernel is a no-op once ``live`` is 0 — so steps
after convergence change nothing and the host reads the flag only every few
steps.  The plain versions perform the same scalar step with torch ops.

The row-sharded loop (``parallel/loops.py``) steps only after summing every
shard's dots, so there K2 runs with ``partials_only=True``: it updates x and
r and returns this shard's sums, reads the solve's ``live`` flag from
``work.ctl`` and leaves the rest of ``work`` alone; :func:`bell_spmv_dot`
never steps.  The loop then runs :func:`finish_dir` and :func:`finish_update`
on the summed dots.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..spmv import bell_apply, sym_bell_apply
from .bell_spmv import check_packed, packed_product
from ._common import (
    CUDA_BN,
    LAUNCHES,
    PLAIN_ON_CUDA,
    check_cuda_operands,
    on_cuda,
    ptr,
    raise_on_error,
    reset_counts,  # noqa: F401  (re-exported with the counters)
    stream,
)

# scalar-buffer layout shared with csrc/fused_cg.cu
S_RHO, S_RNORM, S_BETA, S_ALPHA, S_TOL = range(5)
C_K, C_DONE, C_MAXITER, C_LIVE = range(4)

MIRRORS = ("scatter", "split", "banded")
#: most block-rows per CTA of the full-storage K1 (its automatic row group)
DIR_ROW_GROUP = 4
_UPDATE_MAX_GRID = 1024
_THREADS = 256


@dataclasses.dataclass
class FusedWork:
    """Device scalars, history and scratch of one fused solve."""

    scal: torch.Tensor  # (5,) f32: rho, rnorm, beta, alpha, tol
    ctl: torch.Tensor  # (4,) i32: k, done, maxiter, live
    hist: torch.Tensor  # (maxiter + 1,) f32, NaN past k
    partials: torch.Tensor  # f32 per-CTA dot partials
    counter: torch.Tensor  # (1,) i32 arrival ticket, 0 between launches
    tparts: Optional[torch.Tensor] = None  # general mirror landing buffer
    # (1, 1) views of scal, the two per-step kernel operands: made once,
    # since a view costs a few microseconds of host time every step
    beta: torch.Tensor = dataclasses.field(init=False, repr=False)
    alpha: torch.Tensor = dataclasses.field(init=False, repr=False)

    @staticmethod
    def new(device, maxiter: int = 1, tol: float = 0.0) -> "FusedWork":
        device = torch.device(device)
        scal = torch.zeros(5, dtype=torch.float32)
        scal[S_TOL] = tol
        ctl = torch.tensor([0, 0, maxiter, int(maxiter > 0)], dtype=torch.int32)
        return FusedWork(
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
        self.beta = self.scalar(S_BETA)
        self.alpha = self.scalar(S_ALPHA)


def _extra(out, work) -> tuple:
    """The caller-provided buffers, for the device check (any fused
    iteration's work: ``scal`` and ``ctl``)."""
    return (*(out or ()), *((work.scal, work.ctl) if work is not None else ()))


def _live(work) -> bool:
    """Whether a fused iteration's ``ctl`` says to step; a host read, on the
    plain versions' CPU path only (free there)."""
    return bool(work.ctl[C_LIVE])


# ---- kernel 1 --------------------------------------------------------------

def sym_fused_dir_spmv_dot(
    diag_blocks: torch.Tensor,
    off_blocks: torch.Tensor,
    off_cols: torch.Tensor,
    r2d: torch.Tensor,
    pold2d: torch.Tensor,
    beta: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    mirror_src: torch.Tensor,
    mirror: str = "scatter",
    row_group: int = 8,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
):
    """(p_new, q, pap) on symmetric blocked-ELL storage.

    ``r2d``/``pold2d``/``inv_diag2d``: vectors as (nrb, bn) f32; ``beta``:
    one-element f32 tensor.  Returns p_new (nrb, bn), q (nrb, bm), pap (1, 1).

    ``mirror`` keeps the TPU kernel's argument and validation.  On the GPU
    ``"scatter"`` and ``"split"`` are ONE landing (per-slot mirror products
    summed per block-row in the fixed order of ``mirror_src``), and
    ``"banded"`` (block-tridiagonal storage only; the caller checks
    ``SymBellMatrix.banded``) carries each row's mirror into the next row
    with a one-tile halo per CTA strip of ``row_group`` rows.
    ``mirror_src``: the operator's transposed tile index
    (``SymBellMatrix.mirror_src``, types/bell.mirror_index).  ``out``: (p_new, q) buffers to fill; p_new must not alias
    ``pold2d``.  ``work``: see module doc.
    """
    name = "sym_fused_dir_spmv_dot"
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
    for v in (r2d, pold2d, inv_diag2d):
        if v is not None and (tuple(v.shape) != (nrb, bn) or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must be ({nrb}, {bn}) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if beta.numel() != 1 or beta.dtype != torch.float32:
        raise ValueError(f"{name}: beta must be one float32")
    if row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if (mirror_src.dim() != 2 or mirror_src.shape[0] != nrb
            or mirror_src.dtype != torch.int32):
        raise ValueError(f"{name}: mirror_src must be ({nrb}, kin) int32")
    if out is not None and out[0].data_ptr() == pold2d.data_ptr():
        raise ValueError(f"{name}: p_new must not alias p_old")
    args = (diag_blocks, off_blocks, off_cols, r2d, pold2d, beta, inv_diag2d,
            mirror_src, out, work)
    if not on_cuda(name, diag_blocks, off_blocks, off_cols, r2d, pold2d,
                   beta, inv_diag2d, mirror_src, *_extra(out, work)):
        return _sym_dir_plain(*args)
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    return _sym_dir_cuda(*args, mirror=mirror, row_group=row_group)


def _sym_dir_plain(diag, off, off_cols, r2d, pold2d, beta, inv_diag2d,
                   mirror_src, out, work):
    return _dir_plain(
        "sym_fused_dir_spmv_dot",
        lambda p: sym_bell_apply(diag, off, off_cols, mirror_src, p),
        r2d, pold2d, beta, inv_diag2d, out, work)


def _dir_plain(name, apply, r2d, pold2d, beta, inv_diag2d, out, work):
    """Plain K1: p_new = z + β·p_old, q = apply(p_new), pap = p_new·q, and
    the kernel's scalar step (α) on ``work``."""
    if r2d.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    if work is not None and not _live(work):
        return out[0], out[1], work.scal.new_zeros(1, 1)
    z = r2d if inv_diag2d is None else inv_diag2d * r2d
    p_new = z + beta.reshape(()) * pold2d
    q = apply(p_new)
    pap = torch.sum(p_new * q).reshape(1, 1)
    if out is not None:
        out[0].copy_(p_new)
        out[1].copy_(q)
        p_new, q = out
    if work is not None:
        finish_dir(work, pap[0, 0])
    return p_new, q, pap


def _sym_dir_cuda(diag, off, off_cols, r2d, pold2d, beta, inv_diag2d,
                  mirror_src, out, work, *, mirror, row_group):
    from ._build import load_library

    name = "sym_fused_dir_spmv_dot"
    nrb, bm, bn = diag.shape
    ku = off.shape[1]
    dev = r2d.device
    if work is None:
        work = FusedWork.new(dev)
    p_new, q = out if out is not None else (torch.empty_like(r2d),
                                             r2d.new_empty(nrb, bm))
    pap = r2d.new_empty(1, 1)
    check_cuda_operands(name, (diag, off, off_cols, r2d, pold2d, beta,
                               inv_diag2d, mirror_src, p_new, q))
    grid = -(-nrb // row_group)
    if work.partials.numel() < grid:
        work.partials = torch.empty(grid, device=dev)
    lib = load_library()
    common = (ptr(r2d), ptr(pold2d), ptr(inv_diag2d), ptr(beta),
              ptr(p_new), ptr(q), ptr(pap))
    if mirror == "banded":
        err = lib.cg_sym_dir_banded(
            ptr(diag), ptr(off), ptr(off_cols), *common,
            ptr(work.partials), ptr(work.counter), ptr(work.scal),
            ptr(work.ctl), nrb, bn, row_group, stream(dev))
    else:
        if work.tparts is None or work.tparts.numel() < nrb * ku * bn:
            work.tparts = torch.empty(nrb * ku * bn, device=dev)
        kin = mirror_src.shape[1]
        err = lib.cg_sym_dir_general(
            ptr(diag), ptr(off), ptr(off_cols), ptr(mirror_src), *common,
            ptr(work.tparts), ptr(work.partials), ptr(work.counter),
            ptr(work.scal), ptr(work.ctl), nrb, ku, kin, bn, row_group,
            stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return p_new, q, pap


# ---- kernel 4 --------------------------------------------------------------

def fused_dir_spmv_dot(
    blocks: torch.Tensor,
    block_cols: torch.Tensor,
    r2d: torch.Tensor,
    pold2d: torch.Tensor,
    beta: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    row_group: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
):
    """(p_new, q, pap) on full blocked-ELL storage: the same contract as
    :func:`sym_fused_dir_spmv_dot`, with the operator as ``blocks``
    (nrb, kmax, bn, bn) float32 and ``block_cols`` (nrb, kmax) int32
    (padding slots: zero tiles at column block 0).

    ``r2d``/``pold2d``/``inv_diag2d``: vectors as (nrb, bn) float32 (a
    square padded system); ``beta``: one float32.  Returns p_new (nrb, bn),
    q (nrb, bm), pap (1, 1).  ``row_group``: block-rows per CTA; None picks
    :func:`auto_row_group`.  ``out``: (p_new, q) buffers to fill; p_new
    must not alias ``pold2d``.  ``work``: see module doc.
    """
    name = "fused_dir_spmv_dot"
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
    for v in (r2d, pold2d, inv_diag2d):
        if v is not None and (tuple(v.shape) != (nrb, bn) or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must be ({nrb}, {bn}) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if beta.numel() != 1 or beta.dtype != torch.float32:
        raise ValueError(f"{name}: beta must be one float32")
    if row_group is not None and row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if out is not None and out[0].data_ptr() == pold2d.data_ptr():
        raise ValueError(f"{name}: p_new must not alias p_old")
    if not on_cuda(name, blocks, block_cols, r2d, pold2d, beta, inv_diag2d,
                   *_extra(out, work)):
        return _full_dir_plain(blocks, block_cols, r2d, pold2d, beta,
                               inv_diag2d, out, work)
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    if row_group is None:
        row_group = auto_row_group(nrb, r2d.device)
    return _full_dir_cuda(blocks, block_cols, r2d, pold2d, beta, inv_diag2d,
                          out, work, row_group)


def auto_row_group(nrb: int, device) -> int:
    """Block-rows per CTA of the full-storage K1: up to ``DIR_ROW_GROUP``,
    but never so many that the grid gives an SM fewer than two CTAs (a CTA
    walks its rows' slots in order, so a short grid leaves SMs idle: at
    nrb = 96, R = 4 ran the elasticity3d_16 tester at twice the time of
    R = 1 on an H100)."""
    sms = _sm_count(torch.device(device).index or 0)
    return max(1, min(DIR_ROW_GROUP, nrb // (2 * sms)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _full_dir_plain(blocks, block_cols, r2d, pold2d, beta, inv_diag2d, out, work):
    return _dir_plain("fused_dir_spmv_dot",
                      lambda p: bell_apply(blocks, block_cols, p),
                      r2d, pold2d, beta, inv_diag2d, out, work)


def _full_dir_cuda(blocks, block_cols, r2d, pold2d, beta, inv_diag2d, out,
                   work, row_group):
    from ._build import load_library

    name = "fused_dir_spmv_dot"
    nrb, kmax, bm, bn = blocks.shape
    dev = r2d.device
    if work is None:
        work = FusedWork.new(dev)
    p_new, q = out if out is not None else (torch.empty_like(r2d),
                                             r2d.new_empty(nrb, bm))
    pap = r2d.new_empty(1, 1)
    check_cuda_operands(name, (blocks, block_cols, r2d, pold2d, beta,
                               inv_diag2d, p_new, q))
    grid = -(-nrb // row_group)
    if work.partials.numel() < grid:
        work.partials = torch.empty(grid, device=dev)
    err = load_library().cg_full_dir(
        ptr(blocks), ptr(block_cols), ptr(r2d), ptr(pold2d), ptr(inv_diag2d),
        ptr(beta), ptr(p_new), ptr(q), ptr(pap), ptr(work.partials),
        ptr(work.counter), ptr(work.scal), ptr(work.ctl), nrb, kmax, bn,
        row_group, stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return p_new, q, pap


def fused_dir_spmv_dot_packed(
    pk,
    r2d: torch.Tensor,
    pold2d: torch.Tensor,
    beta: torch.Tensor,
    inv_diag2d: Optional[torch.Tensor] = None,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
):
    """(p_new, q, pap) on full blocked-ELL storage read as its packed
    nonzeros ``pk`` (``BlockedEllMatrix.packed()``, float32): the contract
    of :func:`fused_dir_spmv_dot` for a square padded system of
    ``pk.rows`` rows, vectors as (nrb, bn) float32 with nrb·bn =
    ``pk.rows``.  Any tile width."""
    name = "fused_dir_spmv_dot_packed"
    check_packed(name, pk)
    if pk.ncols != pk.rows:
        raise ValueError(f"{name}: needs a square padded system, got {pk.rows} rows and "
                         f"{pk.ncols} columns")
    shape = r2d.shape
    for v in (r2d, pold2d, inv_diag2d):
        if v is not None and (v.dim() != 2 or v.shape != shape or v.numel() != pk.rows
                              or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must be one (nrb, bn) float32 shape of "
                             f"{pk.rows} entries, got {tuple(v.shape)} {v.dtype}")
    if beta.numel() != 1 or beta.dtype != torch.float32:
        raise ValueError(f"{name}: beta must be one float32")
    if out is not None and out[0].data_ptr() == pold2d.data_ptr():
        raise ValueError(f"{name}: p_new must not alias p_old")
    args = (pk, r2d, pold2d, beta, inv_diag2d, out, work)
    if not on_cuda(name, pk.vals, pk.cols, pk.row_len, pk.chunk_off, r2d, pold2d, beta,
                   inv_diag2d, *_extra(out, work)):
        return _packed_dir_plain(*args)
    return _packed_dir_cuda(*args)


def _packed_dir_plain(pk, r2d, pold2d, beta, inv_diag2d, out, work):
    return _dir_plain("fused_dir_spmv_dot_packed", packed_product(pk),
                      r2d, pold2d, beta, inv_diag2d, out, work)


def _packed_dir_cuda(pk, r2d, pold2d, beta, inv_diag2d, out, work):
    from ._build import load_library

    name = "fused_dir_spmv_dot_packed"
    dev = r2d.device
    if work is None:
        work = FusedWork.new(dev)
    p_new, q = out if out is not None else (torch.empty_like(r2d), torch.empty_like(r2d))
    pap = r2d.new_empty(1, 1)
    check_cuda_operands(name, (pk.vals, pk.cols, pk.row_len, pk.chunk_off, r2d, pold2d,
                               beta, inv_diag2d, p_new, q))
    grid = -(-pk.rows // _THREADS)
    if work.partials.numel() < grid:
        work.partials = torch.empty(grid, device=dev)
    err = load_library().cg_full_dir_packed(
        ptr(pk.vals), ptr(pk.cols), ptr(pk.row_len), ptr(pk.chunk_off), ptr(r2d),
        ptr(pold2d), ptr(inv_diag2d), ptr(beta), ptr(p_new), ptr(q), ptr(pap),
        ptr(work.partials), ptr(work.counter), ptr(work.scal), ptr(work.ctl), pk.rows,
        stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return p_new, q, pap


# ---- kernel 6 --------------------------------------------------------------

def bell_spmv_dot(
    blocks: torch.Tensor,
    block_cols: torch.Tensor,
    x2d: torch.Tensor,
    row_offset: int,
    *,
    row_group: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
):
    """(q, pap) = (A_loc·x, x[row_offset : row_offset + nrb·bm]·q): one
    shard's SpMV on the all-gathered operand and its dot partial.

    ``blocks`` (nrb, kmax, bn, bn) float32, ``block_cols`` (nrb, kmax) int32
    GLOBAL column blocks; ``x2d`` the gathered operand as (ncb, bn) float32;
    ``row_offset`` this shard's first global row, a multiple of bn (a host
    int: it is fixed when the operator is partitioned).  Returns q (nrb, bn)
    and pap (1, 1).  ``out``: (q, pap) buffers to fill; q must not lie on
    ``x2d``.  ``work``: scratch, and the solve's ``ctl`` (a step after the
    end is a no-op); the kernel does no scalar step.  ``row_group``:
    block-rows per CTA (None: :func:`auto_row_group`).
    """
    name = "bell_spmv_dot"
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
    if x2d.dim() != 2 or x2d.shape[1] != bn or x2d.dtype != torch.float32:
        raise ValueError(f"{name}: x2d must be (ncb, {bn}) float32, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    row_offset = int(row_offset)
    if row_offset % bn or not 0 <= row_offset <= (x2d.shape[0] - nrb) * bn:
        raise ValueError(f"{name}: row_offset {row_offset} must be a multiple of "
                         f"{bn} with its {nrb} block-rows inside x2d")
    if row_group is not None and row_group < 1:
        raise ValueError(f"{name}: row_group must be >= 1")
    if out is not None:
        q, pap = out
        if tuple(q.shape) != (nrb, bn) or q.dtype != torch.float32 or pap.numel() != 1:
            raise ValueError(f"{name}: out must be (nrb, bn) and one float32")
        if q.data_ptr() == x2d.data_ptr():
            raise ValueError(f"{name}: q must not alias x2d")
    args = (blocks, block_cols, x2d, row_offset, out, work)
    if not on_cuda(name, blocks, block_cols, x2d, *_extra(out, work)):
        return _spmv_dot_plain(*args)
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    if row_group is None:
        row_group = auto_row_group(nrb, x2d.device)
    return _spmv_dot_cuda(*args, row_group)


def _spmv_dot_plain(blocks, block_cols, x2d, row_offset, out, work):
    name = "bell_spmv_dot"
    if x2d.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    nrb, bn = blocks.shape[0], blocks.shape[3]
    if work is not None and not _live(work):
        return out if out is not None else (x2d.new_zeros(nrb, bn), x2d.new_zeros(1, 1))
    q = bell_apply(blocks, block_cols, x2d)
    r0 = row_offset // bn
    pap = torch.sum(x2d[r0:r0 + nrb] * q).reshape(1, 1)
    if out is None:
        return q, pap
    out[0].copy_(q)
    out[1].copy_(pap.reshape(out[1].shape))
    return out


def _spmv_dot_cuda(blocks, block_cols, x2d, row_offset, out, work, row_group):
    from ._build import load_library

    name = "bell_spmv_dot"
    nrb, kmax, _, bn = blocks.shape
    dev = x2d.device
    if work is None:
        work = FusedWork.new(dev)
    q, pap = out if out is not None else (x2d.new_empty(nrb, bn), x2d.new_empty(1, 1))
    check_cuda_operands(name, (blocks, block_cols, x2d, q, pap))
    grid = -(-nrb // row_group)
    if work.partials.numel() < grid:
        work.partials = torch.empty(grid, device=dev)
    err = load_library().cg_bell_spmv_dot(
        ptr(blocks), ptr(block_cols), ptr(x2d), row_offset // bn, ptr(q), ptr(pap),
        ptr(work.partials), ptr(work.counter), ptr(work.ctl), nrb, kmax, bn,
        row_group, stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return q, pap


# ---- kernels 2 and 3 -------------------------------------------------------

def fused_update_dot(
    x2d: torch.Tensor,
    p2d: torch.Tensor,
    r2d: torch.Tensor,
    q2d: torch.Tensor,
    alpha: torch.Tensor,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
    partials_only: bool = False,
):
    """(x', r', rnorm) = (x + α·p, r − α·q, r'·r'); vectors of one shape
    and any length (the kernel reads float4 and finishes the last n % 4
    entries one by one), f32, ``alpha`` one f32.  ``out``: (x', r')
    buffers, which may be ``x2d`` and ``r2d`` themselves (in-place
    update).  ``partials_only`` (with a ``work``): no scalar step, see the
    module doc."""
    return _update("fused_update_dot", x2d, p2d, r2d, q2d, None, alpha, out, work,
                   partials_only)


def fused_update_dot_pcg(
    x2d: torch.Tensor,
    p2d: torch.Tensor,
    r2d: torch.Tensor,
    q2d: torch.Tensor,
    d2d: torch.Tensor,
    alpha: torch.Tensor,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
    partials_only: bool = False,
):
    """(x', r', rnorm, rho) with rho = r'·(d⊙r') — the Jacobi-PCG update."""
    return _update("fused_update_dot_pcg", x2d, p2d, r2d, q2d, d2d, alpha,
                   out, work, partials_only)


def _update(name, x2d, p2d, r2d, q2d, d2d, alpha, out, work, partials_only):
    for v in (x2d, p2d, r2d, q2d, d2d):
        if v is not None and (v.shape != x2d.shape or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must share shape {tuple(x2d.shape)} and "
                             f"be float32, got {tuple(v.shape)} {v.dtype}")
    if alpha.numel() != 1 or alpha.dtype != torch.float32:
        raise ValueError(f"{name}: alpha must be one float32")
    for o in out or ():
        if o.shape != x2d.shape or o.dtype != torch.float32:
            raise ValueError(f"{name}: out buffers must match the vectors")
    if partials_only and work is None:
        raise ValueError(f"{name}: partials_only needs the solve's work")
    args = (name, x2d, p2d, r2d, q2d, d2d, alpha, out, work, partials_only)
    if not on_cuda(name, x2d, p2d, r2d, q2d, d2d, alpha, *_extra(out, work)):
        return _update_plain(*args)
    return _update_cuda(*args)


def put_hist(hist: torch.Tensor, k: torch.Tensor, live: torch.Tensor,
             value: torch.Tensor) -> None:
    """hist[k] = value where ``live`` (k a device int; no host read)."""
    kk = k.long().reshape(1)
    hist.index_put_((kk,), torch.where(live, value, hist.gather(0, kk)[0]).reshape(1))


def finish_dir(work: FusedWork, pap: torch.Tensor) -> None:
    """The solver's scalar step after K1 (its last CTA does the same): α =
    ρ/(p·q), 0 when ρ == 0.  Not masked: once the solve is not live, K2 and
    :func:`finish_update` ignore α."""
    scal = work.scal
    rho = scal[S_RHO]
    exact = rho == 0
    scal[S_ALPHA] = torch.where(exact, 0.0, rho / torch.where(exact, 1.0, pap))


def finish_update(work: FusedWork, rn: torch.Tensor, rz: torch.Tensor) -> None:
    """The solver's scalar step after K2 (its last CTA does the same) from
    the updated residual's ‖r‖² ``rn`` and ρ = r·z ``rz`` (0-d float32):
    done from the PRE-update ‖r‖², β with the ρ == 0 guard, k, hist[k] and
    live; a no-op once the solve is not live."""
    scal, ctl = work.scal, work.ctl
    live = ctl[C_LIVE] != 0
    rn_pre, rho, tol = scal[S_RNORM], scal[S_RHO], scal[S_TOL]
    exact = rho == 0
    done = torch.isnan(rn_pre) | (torch.sqrt(rn_pre) <= tol)
    beta = torch.where(exact, 0.0, rz / torch.where(exact, 1.0, rho))
    k = ctl[C_K] + live.to(torch.int32)
    put_hist(work.hist, k, live, rn)
    new_ctl = torch.stack([
        k, torch.where(live, done.to(torch.int32), ctl[C_DONE]), ctl[C_MAXITER],
        (live & ~done & (k < ctl[C_MAXITER])).to(torch.int32)])
    new_scal = torch.where(live, torch.stack([rz, rn, beta, scal[S_ALPHA], tol]), scal)
    ctl.copy_(new_ctl)
    scal.copy_(new_scal)


def _update_plain(name, x2d, p2d, r2d, q2d, d2d, alpha, out, work, partials_only=False):
    if x2d.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    if work is not None and not _live(work):
        z = work.scal.new_zeros(1, 1)
        xr = out if out is not None else (x2d, r2d)
        return (*xr, z) if d2d is None else (*xr, z, z)
    a = alpha.reshape(())
    x_new = x2d + a * p2d
    r_new = r2d - a * q2d
    r2 = r_new * r_new
    rnorm = torch.sum(r2).reshape(1, 1)
    rho = None if d2d is None else torch.sum(d2d * r2).reshape(1, 1)
    if out is not None:
        out[0].copy_(x_new)
        out[1].copy_(r_new)
        x_new, r_new = out
    if work is not None and not partials_only:
        finish_update(work, rnorm[0, 0], rnorm[0, 0] if rho is None else rho[0, 0])
    return (x_new, r_new, rnorm) if rho is None else (x_new, r_new, rnorm, rho)


def _update_cuda(name, x2d, p2d, r2d, q2d, d2d, alpha, out, work, partials_only):
    from ._build import load_library

    dev = x2d.device
    if work is None:
        work = FusedWork.new(dev)
    xo, ro = out if out is not None else (torch.empty_like(x2d), torch.empty_like(r2d))
    rnorm = x2d.new_empty(1, 1)
    rho = None if d2d is None else x2d.new_empty(1, 1)
    vecs = (x2d, p2d, r2d, q2d, d2d, xo, ro)
    check_cuda_operands(name, vecs + (alpha,), vec4=vecs)
    n = x2d.numel()
    grid = max(1, min(-(-n // (4 * _THREADS)), _UPDATE_MAX_GRID))
    if work.partials.numel() < 2 * grid:
        work.partials = torch.empty(2 * grid, device=dev)
    err = load_library().cg_update(
        ptr(alpha), ptr(x2d), ptr(p2d), ptr(r2d), ptr(q2d), ptr(d2d),
        ptr(xo), ptr(ro), ptr(rnorm), ptr(rho), ptr(work.partials),
        ptr(work.counter), None if partials_only else ptr(work.scal), ptr(work.ctl),
        ptr(work.hist), work.hist.numel(), n, grid, stream(dev))
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return (xo, ro, rnorm) if rho is None else (xo, ro, rnorm, rho)
