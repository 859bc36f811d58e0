"""The fused CG iteration's kernels: hand-written CUDA for Hopper
(``csrc/fused_cg.cu``), each beside its plain-torch version.

Counterpart of ``conjugategradient_tpu/ops/pallas/fused_cg.py``:

* :func:`sym_fused_dir_spmv_dot` — (p_new, q, pap) = (z + β·p_old,
  (D+U+Uᵀ)·p_new, p_new·q) with z = d⊙r (Jacobi) or r, on symmetric
  blocked-ELL tiles (replaces ``sym_fused_dir_spmv_dot``, fused_cg.py:338);
* :func:`fused_update_dot` — (x + α·p, r − α·q, r'·r') (replaces
  ``fused_update_dot``, fused_cg.py:608);
* :func:`fused_update_dot_pcg` — the same plus ρ = Σ d·r'² (replaces
  ``fused_update_dot_pcg``, fused_cg.py:555).

Dispatch: a wrapper runs its plain version when the tensors it is given lie
on the CPU, and launches its CUDA kernel when they lie on a CUDA device;
anything else raises.  There is no fallback from a CUDA tensor to the plain
version.  ``LAUNCHES`` counts kernel launches per wrapper;
``PLAIN_ON_CUDA`` counts plain-version calls that were given CUDA tensors
(only direct comparisons make those).

Inside a solve the wrappers also take a :class:`FusedWork`: the device
scalars of the solve (ρ, ‖r‖², β, α, tol; k, done, maxiter, live), the
residual history and reusable scratch.  The kernels' final reductions then
perform the solver's scalar step on the device (K1: α; K2: done, β, k,
hist[k], live), and every kernel is a no-op once ``live`` is 0 — so steps
after convergence change nothing and the host reads the flag only every few
steps.  The plain versions perform the same scalar step with torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..spmv import sym_bell_apply

# scalar-buffer layout shared with csrc/fused_cg.cu
S_RHO, S_RNORM, S_BETA, S_ALPHA, S_TOL = range(5)
C_K, C_DONE, C_MAXITER, C_LIVE = range(4)

MIRRORS = ("scatter", "split", "banded")
CUDA_BN = (32, 64, 128, 256)
_UPDATE_MAX_GRID = 1024
_THREADS = 256

LAUNCHES = {
    "sym_fused_dir_spmv_dot": 0,
    "fused_update_dot": 0,
    "fused_update_dot_pcg": 0,
}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


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


def _on_cuda(name: str, *tensors) -> bool:
    """True for all-CUDA operands (one device), False for all-CPU ones."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _check_cuda_operands(name, tensors, vec4=()):
    """Contiguous operands; ``vec4`` ones are read as float4 (16-byte
    aligned)."""
    for t in tensors:
        if t is not None:
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
    for t in vec4:
        if t is not None:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: vectors must be 16-byte aligned")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {err})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _extra(out, work) -> tuple:
    """The caller-provided buffers, for the device check."""
    return (*(out or ()), *((work.scal, work.ctl) if work is not None else ()))


def _live(work: FusedWork) -> bool:
    # host read; the plain versions are the CPU path (free there)
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
    if not _on_cuda(name, diag_blocks, off_blocks, off_cols, r2d, pold2d,
                    beta, inv_diag2d, mirror_src, *_extra(out, work)):
        return _sym_dir_plain(*args)
    if bn not in CUDA_BN:
        raise ValueError(f"{name}: the CUDA kernel takes bn in {CUDA_BN}, got {bn}")
    return _sym_dir_cuda(*args, mirror=mirror, row_group=row_group)


def _sym_dir_plain(diag, off, off_cols, r2d, pold2d, beta, inv_diag2d,
                   mirror_src, out, work):
    if r2d.is_cuda:
        PLAIN_ON_CUDA["sym_fused_dir_spmv_dot"] += 1
    if work is not None and not _live(work):
        return out[0], out[1], work.scal.new_zeros(1, 1)
    z = r2d if inv_diag2d is None else inv_diag2d * r2d
    p_new = z + beta.reshape(()) * pold2d
    q = sym_bell_apply(diag, off, off_cols, mirror_src, p_new)
    pap = torch.sum(p_new * q).reshape(1, 1)
    if out is not None:
        out[0].copy_(p_new)
        out[1].copy_(q)
        p_new, q = out
    if work is not None:
        rho = work.scal[S_RHO]
        exact = rho == 0
        work.scal[S_ALPHA] = torch.where(
            exact, 0.0, rho / torch.where(exact, 1.0, pap[0, 0]))
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
    _check_cuda_operands(name, (diag, off, off_cols, r2d, pold2d, beta,
                                inv_diag2d, mirror_src, p_new, q))
    grid = -(-nrb // row_group)
    if work.partials.numel() < grid:
        work.partials = torch.empty(grid, device=dev)
    lib = load_library()
    common = (_ptr(r2d), _ptr(pold2d), _ptr(inv_diag2d), _ptr(beta),
              _ptr(p_new), _ptr(q), _ptr(pap))
    if mirror == "banded":
        err = lib.cg_sym_dir_banded(
            _ptr(diag), _ptr(off), _ptr(off_cols), *common,
            _ptr(work.partials), _ptr(work.counter), _ptr(work.scal),
            _ptr(work.ctl), nrb, bn, row_group, _stream(dev))
    else:
        if work.tparts is None or work.tparts.numel() < nrb * ku * bn:
            work.tparts = torch.empty(nrb * ku * bn, device=dev)
        kin = mirror_src.shape[1]
        err = lib.cg_sym_dir_general(
            _ptr(diag), _ptr(off), _ptr(off_cols), _ptr(mirror_src), *common,
            _ptr(work.tparts), _ptr(work.partials), _ptr(work.counter),
            _ptr(work.scal), _ptr(work.ctl), nrb, ku, kin, bn, row_group,
            _stream(dev))
    LAUNCHES[name] += 1
    _raise_on_error(name, err)
    return p_new, q, pap


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
):
    """(x', r', rnorm) = (x + α·p, r − α·q, r'·r'); vectors (rows, lanes)
    f32, ``alpha`` one f32.  ``out``: (x', r') buffers, which may be ``x2d``
    and ``r2d`` themselves (in-place update)."""
    return _update("fused_update_dot", x2d, p2d, r2d, q2d, None, alpha, out, work)


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
):
    """(x', r', rnorm, rho) with rho = r'·(d⊙r') — the Jacobi-PCG update."""
    return _update("fused_update_dot_pcg", x2d, p2d, r2d, q2d, d2d, alpha,
                   out, work)


def _update(name, x2d, p2d, r2d, q2d, d2d, alpha, out, work):
    for v in (x2d, p2d, r2d, q2d, d2d):
        if v is not None and (v.shape != x2d.shape or v.dtype != torch.float32):
            raise ValueError(f"{name}: vectors must share shape {tuple(x2d.shape)} and "
                             f"be float32, got {tuple(v.shape)} {v.dtype}")
    if alpha.numel() != 1 or alpha.dtype != torch.float32:
        raise ValueError(f"{name}: alpha must be one float32")
    for o in out or ():
        if o.shape != x2d.shape or o.dtype != torch.float32:
            raise ValueError(f"{name}: out buffers must match the vectors")
    args = (name, x2d, p2d, r2d, q2d, d2d, alpha, out, work)
    if not _on_cuda(name, x2d, p2d, r2d, q2d, d2d, alpha, *_extra(out, work)):
        return _update_plain(*args)
    if x2d.numel() % 4:
        raise ValueError(f"{name}: the CUDA kernel needs a length divisible by 4")
    return _update_cuda(*args)


def _finish_update(work: FusedWork, rn, rz):
    """The solver's scalar step after K2 (same as the kernel's last CTA)."""
    scal, ctl = work.scal, work.ctl
    rn_pre, rho = scal[S_RNORM].clone(), scal[S_RHO].clone()
    exact = rho == 0
    done = torch.isnan(rn_pre) | (torch.sqrt(rn_pre) <= scal[S_TOL])
    k = ctl[C_K] + 1
    ctl[C_K] = k
    ctl[C_DONE] = done.to(torch.int32)
    ctl[C_LIVE] = ((~done) & (k < ctl[C_MAXITER])).to(torch.int32)
    work.hist.index_put_((k.long().reshape(1),), rn.reshape(1))
    scal[S_BETA] = torch.where(exact, 0.0, rz / torch.where(exact, 1.0, rho))
    scal[S_RHO] = rz
    scal[S_RNORM] = rn


def _update_plain(name, x2d, p2d, r2d, q2d, d2d, alpha, out, work):
    if x2d.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    if work is not None and not _live(work):
        z = work.scal.new_zeros(1, 1)
        return (*out, z) if d2d is None else (*out, z, z)
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
    if work is not None:
        _finish_update(work, rnorm[0, 0], rnorm[0, 0] if rho is None else rho[0, 0])
    return (x_new, r_new, rnorm) if rho is None else (x_new, r_new, rnorm, rho)


def _update_cuda(name, x2d, p2d, r2d, q2d, d2d, alpha, out, work):
    from ._build import load_library

    dev = x2d.device
    if work is None:
        work = FusedWork.new(dev)
    xo, ro = out if out is not None else (torch.empty_like(x2d), torch.empty_like(r2d))
    rnorm = x2d.new_empty(1, 1)
    rho = None if d2d is None else x2d.new_empty(1, 1)
    vecs = (x2d, p2d, r2d, q2d, d2d, xo, ro)
    _check_cuda_operands(name, vecs + (alpha,), vec4=vecs)
    n = x2d.numel()
    grid = max(1, min(-(-n // (4 * _THREADS)), _UPDATE_MAX_GRID))
    if work.partials.numel() < 2 * grid:
        work.partials = torch.empty(2 * grid, device=dev)
    err = load_library().cg_update(
        _ptr(alpha), _ptr(x2d), _ptr(p2d), _ptr(r2d), _ptr(q2d), _ptr(d2d),
        _ptr(xo), _ptr(ro), _ptr(rnorm), _ptr(rho), _ptr(work.partials),
        _ptr(work.counter), _ptr(work.scal), _ptr(work.ctl), _ptr(work.hist),
        work.hist.numel(), n, grid, _stream(dev))
    LAUNCHES[name] += 1
    _raise_on_error(name, err)
    return (xo, ro, rnorm) if rho is None else (xo, ro, rnorm, rho)
