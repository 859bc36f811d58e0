"""The fused stencil-CG iteration's kernels, each beside its plain-torch
version.  Counterpart of ``conjugategradient_tpu/ops/pallas/fused_stencil.py``:

* :func:`fused_stencil_dir_dot` — (p_new, q, pap) = (r + β·p_old,
  stencil(p_new), p_new·q) on (nx, ny, nz) float32 volumes: hand-written
  CUDA (``csrc/fused_stencil.cu``), replaces ``fused_stencil_dir_dot``
  (fused_stencil.py:69);
* :func:`fused_update_dot_3d` — (x + α·p, r − α·q, r'·r') on volumes:
  replaces ``fused_update_dot_3d`` (fused_stencil.py:150), which computes
  kernel 2's function on another layout, by calling
  :func:`~.fused_cg.fused_update_dot` on the volumes' flat views.

Dispatch and the solve-time ``FusedWork`` protocol (device scalars, no-op
once ``live`` is 0, the scalar step in the last CTA) are those of
``ops/cuda/fused_cg.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..stencil import stencil7_apply
from ._common import LAUNCHES, check_cuda_operands, on_cuda, ptr, raise_on_error, stream
from .fused_cg import FusedWork, _dir_plain, _extra, fused_update_dot
from .stencil import TILE_Y, TILE_Z, check_volume, xchunk

_NAME = "fused_stencil_dir_dot"


def fused_stencil_dir_dot(
    r3d: torch.Tensor,
    pold3d: torch.Tensor,
    beta: torch.Tensor,
    center: float,
    off: float,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
):
    """(p_new, q, pap) for the matrix-free 7-point operator.

    ``r3d``/``pold3d``: (nx, ny, nz) float32 volumes, any shape with every
    axis >= 1 (the TPU kernel's nz % 128, ny % 8 and even-nx rules are
    Mosaic's); ``beta``: one float32; ``center``/``off``: host floats.
    Returns p_new, q (volumes) and pap (1, 1).  ``out``: (p_new, q) buffers
    to fill, neither aliasing ``r3d`` or ``pold3d``.  ``work``: see
    ``ops/cuda/fused_cg.py``.
    """
    check_volume(_NAME, r3d)
    for v in (r3d, pold3d):
        if v.shape != r3d.shape or v.dtype != torch.float32:
            raise ValueError(f"{_NAME}: volumes must share shape {tuple(r3d.shape)} and be "
                             f"float32, got {tuple(v.shape)} {v.dtype}")
    if beta.numel() != 1 or beta.dtype != torch.float32:
        raise ValueError(f"{_NAME}: beta must be one float32")
    for o in out or ():
        if o.shape != r3d.shape or o.dtype != torch.float32:
            raise ValueError(f"{_NAME}: out buffers must match the volumes")
        if o.data_ptr() in (r3d.data_ptr(), pold3d.data_ptr()):
            raise ValueError(f"{_NAME}: p_new and q must not alias r or p_old")
    if not on_cuda(_NAME, r3d, pold3d, beta, *_extra(out, work)):
        return _fused_stencil_dir_plain(r3d, pold3d, beta, center, off, out, work)
    return _fused_stencil_dir_cuda(r3d, pold3d, beta, center, off, out, work)


def _fused_stencil_dir_plain(r3d, pold3d, beta, center, off, out, work):
    return _dir_plain(_NAME, lambda p: stencil7_apply(p, center, off),
                      r3d, pold3d, beta, None, out, work)


def _fused_stencil_dir_cuda(r3d, pold3d, beta, center, off, out, work):
    from ._build import load_library

    dev = r3d.device
    if work is None:
        work = FusedWork.new(dev)
    p_new, q = out if out is not None else (torch.empty_like(r3d), torch.empty_like(r3d))
    pap = r3d.new_empty(1, 1)
    check_cuda_operands(_NAME, (r3d, pold3d, beta, p_new, q))
    nx, ny, nz = r3d.shape
    xc = xchunk(r3d.shape, dev)
    grid = -(-ny // TILE_Y) * -(-nz // TILE_Z) * -(-nx // xc)
    if work.partials.numel() < grid:
        work.partials = torch.empty(grid, device=dev)
    err = load_library().cg_fused_stencil_dir(
        ptr(r3d), ptr(pold3d), ptr(beta), ptr(p_new), ptr(q), ptr(pap),
        ptr(work.partials), ptr(work.counter), ptr(work.scal), ptr(work.ctl),
        nx, ny, nz, center, off, xc, stream(dev))
    LAUNCHES[_NAME] += 1
    raise_on_error(_NAME, err)
    return p_new, q, pap


def fused_update_dot_3d(
    x3d: torch.Tensor,
    p3d: torch.Tensor,
    r3d: torch.Tensor,
    q3d: torch.Tensor,
    alpha: torch.Tensor,
    *,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[FusedWork] = None,
):
    """(x', r', rnorm) = (x + α·p, r − α·q, r'·r') on contiguous (nx, ny,
    nz) float32 volumes: kernel 2 (:func:`~.fused_cg.fused_update_dot`) on
    their flat views, so on a CUDA device it launches (and counts) that
    kernel.  ``out`` may be ``x3d`` and ``r3d`` themselves."""
    vols = (x3d, p3d, r3d, q3d, *(out or ()))
    check_volume("fused_update_dot_3d", x3d)
    for v in vols:
        if v.shape != x3d.shape or not v.is_contiguous():
            raise ValueError("fused_update_dot_3d: volumes must be contiguous and share shape "
                             f"{tuple(x3d.shape)}, got {tuple(v.shape)}")
    flat = lambda v: v.view(-1)
    xo, ro, rnorm = fused_update_dot(
        flat(x3d), flat(p3d), flat(r3d), flat(q3d), alpha,
        out=None if out is None else (flat(out[0]), flat(out[1])), work=work)
    return xo.view(x3d.shape), ro.view(x3d.shape), rnorm
