"""DIA and symmetric-DIA SpMV: two hand-written CUDA kernels for Hopper
(``csrc/dia_spmv.cu``) beside their plain-torch versions.

``dia_spmv_diags`` replaces ``dia_spmv_pallas``, ``dia_spmv_pallas_2d`` and
``dia_spmv_pallas_blocked`` (``conjugategradient_tpu/ops/pallas/dia_spmv.py:181,
130, 398``), which compute the same y = DIA·x on three layouts of x and of
the diagonals; ``sym_dia_spmv_diags`` replaces ``sym_dia_spmv_pallas_blocked``
(same file, :304).  Both read the row-major (ndiag, n) diagonals as they
are stored and return float32 y.  The wrappers run their plain versions
(``ops/spmv.dia_apply`` / ``sym_dia_apply``) when the tensors they are
given lie on the CPU and launch a kernel when they lie on a CUDA device;
anything else raises (``_common``).

The symmetric product has three kernels, one function and the same bits.
``sym_dia_spmv_tiled`` stages the x window and each diagonal a CTA's rows
share in shared memory, through a ring of diagonal stages, so a diagonal
value crosses L2 -> SM about once instead of twice (its row and its
mirror) and x a few times instead of 2·ndiag times; it takes the operators
whose tiling (:func:`sym_dia_tiling`, from the offsets and n alone) pays
at the tile height the diagonals' dtype launches.
``sym_dia_spmv_rows`` takes the stored offsets by value and a few rows a
thread, as ``dia_spmv_rows`` does, on the rest of at most 32 stored
offsets (small operators such as poisson3d_48); ``sym_dia_spmv``, one
thread per row reading everything from L2, on wider bands.
:func:`sym_dia_route` names the kernel; the launch counters tell the
routes apart.

The general product has two kernels too, one function and the same bits.
``dia_spmv_rows`` takes the offsets by value, as a kernel parameter filled
from the host tuple (:func:`host_offsets`, made once per tuple), so no CTA
waits on a global load and a barrier before its first diagonal load, and
gives each thread four consecutive rows, with a chunk of diagonals' loads
in flight before the first product (on bfloat16 diagonals as raw bits,
widened once the chunk's loads are issued).  ``dia_spmv``, one thread a row with
the offsets staged in shared memory, takes the operators :func:`dia_route`
gives it: more than 32 diagonals, where its 4x more warps hide latency
better.

All five kernels take float32 or bfloat16 diagonals (x and y float32): a
bfloat16 operator launches the route's bf16 form, counted as
``<route>_bf16`` (``_common.form``), bit-equal to the float32 launch on the
widened diagonals.  The route is chosen from the offsets and n (and, for
the symmetric product, the tile height the diagonals' dtype launches at)
alone; every route gives the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from ..spmv import dia_apply, sym_dia_apply
from ._common import (
    LAUNCHES,
    OPERATOR_DTYPES,
    PLAIN_ON_CUDA,
    check_cuda_operands,
    form,
    on_cuda,
    ptr,
    raise_on_error,
    stream,
)

#: offsets a CTA of ``dia_spmv`` / ``sym_dia_spmv`` stages in (dynamic, at
#: most 48 KB) shared memory; ``sym_dia_spmv_tiled`` reads them from global
#: memory and has no such limit
MAX_CUDA_DIAGS = 12288
#: offsets ``dia_spmv_rows`` and ``sym_dia_spmv_rows`` take as a kernel
#: parameter (csrc/dia_spmv.cu kDiaMaxOffs; compiled for 8, 16 and 32 of them)
MAX_PARAM_DIAGS = 32
#: the tiled kernel's CTA (csrc/dia_spmv.cu): TILE_COLS columns x
#: ``SymDiaTiling.planes`` planes spaced by the pitch; it is compiled for the
#: heights TILE_PLANE_CHOICES, and :func:`sym_dia_tiling` returns tiles
#: TILE_PLANES high (:func:`launch_tiling` gives each dtype's height)
TILE_COLS = 32
TILE_PLANE_CHOICES = (64, 128)
TILE_PLANES = 64
#: the tiled kernel's launch by the diagonals' dtype: tile height and
#: diagonal stages in its ring (csrc/dia_spmv.cu takes 2 to MAX_TILE_STAGES:
#: S - 1 diagonals in flight while one is summed), from the sweep that
#: ``chip_smoke.py --dia-only`` prints; the route judges each dtype's
#: tiling at its own height
TILE_GEOMETRY = {torch.float32: (64, 3), torch.bfloat16: (128, 3)}
MAX_TILE_STAGES = 8
#: the tiled kernel runs where its grid has at least this many CTAs (one per
#: SM of an H100): below, one pass from L2 by a kernel without shared
#: memory is quicker
MIN_TILE_CTAS = 132
#: dynamic shared memory one CTA may take on an H100 (227 KB)
MAX_TILE_SMEM = 232448


@dataclasses.dataclass(frozen=True)
class SymDiaTiling:
    """How ``sym_dia_spmv_tiled`` covers an operator: a CTA owns
    ``TILE_COLS`` columns of ``planes`` planes spaced ``pitch`` rows apart
    (a multiple of ``TILE_COLS``; ``TILE_COLS`` itself for contiguous
    rows), and stages ``halo`` planes beyond them on each side: an offset k
    below n moves (k // pitch) planes and (k % pitch) columns."""

    pitch: int
    halo: int
    planes: int = TILE_PLANES

    def smem_bytes(self, stages: int, itemsize: int = 4, ndiag: int = 0) -> int:
        """x over the tile and both halos (float32), ``stages`` diagonal
        stages of ``itemsize``-byte values over the tile and the halo before
        it (one summed while the others fill), and each of ``ndiag``
        offsets with its shift (int32)."""
        return TILE_COLS * (4 * (self.planes + 2 * self.halo)
                            + stages * itemsize * (self.planes + self.halo)) + 8 * ndiag

    def ctas(self, n: int) -> int:
        planes = -(-n // self.pitch)
        return (self.pitch // TILE_COLS) * -(-planes // self.planes)

    def pays(self, n: int) -> bool:
        """Whether the tiled kernel should take this operator at n rows:
        a halo of at most the tile's planes (each diagonal value then
        crosses L2 -> SM at most twice, as in one thread a row, and x at
        most three times instead of 2·ndiag) and a grid that fills the
        card (``chip_smoke.py`` on an H100: symdia-big 0.075 ms against
        0.125 one thread a row; poisson3d_48, a 54-CTA grid with 72 halo
        planes, 0.0070-0.0086 against 0.0029-0.0030)."""
        return self.halo <= self.planes and self.ctas(n) >= MIN_TILE_CTAS


@functools.lru_cache(maxsize=256)
def sym_dia_tiling(offsets: tuple, n: int) -> Optional[SymDiaTiling]:
    """The tiled kernel's geometry for these stored offsets (>= 0) at n
    rows, or None where its halo and its offsets do not fit in shared
    memory at a launch of ``TILE_GEOMETRY`` (float32 stages bound both
    types').  Only offsets below n move data (one of n or more adds d·0 and
    + 0 to every row).  Their gcd is the pitch where it is a multiple of
    ``TILE_COLS``, else ``TILE_COLS`` (contiguous rows); the halo is the
    largest shift, (k // pitch) planes plus (k % pitch) columns, rounded up
    to planes.  Pure Python on the offsets and n: the same on every device.
    The wrapper takes the tiled kernel where the geometry exists and
    :meth:`SymDiaTiling.pays` at the height the dtype launches
    (:func:`sym_dia_route`)."""
    near = [int(k) for k in offsets if 0 < k < n]
    g = math.gcd(*near) if near else 0
    pitch = g if g and g % TILE_COLS == 0 else TILE_COLS
    shift = max(((k // pitch) * TILE_COLS + k % pitch for k in near), default=0)
    tiling = SymDiaTiling(pitch, -(-shift // TILE_COLS))
    fits = all(dataclasses.replace(tiling, planes=planes).smem_bytes(stages, 4, len(offsets))
               <= MAX_TILE_SMEM for planes, stages in TILE_GEOMETRY.values())
    return tiling if fits else None


def launch_tiling(tiling: SymDiaTiling, dtype: torch.dtype) -> tuple:
    """The route's tiling as the tiled kernel launches it on diagonals of
    ``dtype``: (the tiling at that dtype's tile height, its ring depth)."""
    planes, stages = TILE_GEOMETRY[dtype]
    return dataclasses.replace(tiling, planes=planes), stages


def sym_dia_route(offsets: tuple, n: int, dtype: torch.dtype = torch.float32) -> str:
    """The kernel that computes y = SymDIA x for these stored offsets at n
    rows on diagonals of ``dtype`` (the launch counter's name, without the
    form's suffix): ``sym_dia_spmv_tiled`` where :func:`sym_dia_tiling`
    finds a geometry that pays at the tile height ``dtype`` launches
    (:func:`launch_tiling`: bf16's 128-plane tiles give half float32's
    CTAs), else ``sym_dia_spmv_rows`` wherever its parameter holds the
    offsets (at most ``MAX_PARAM_DIAGS``), else ``sym_dia_spmv``.  Pure
    Python on the offsets, n and the dtype: the same on every device."""
    n = int(n)
    tiling = sym_dia_tiling(tuple(int(o) for o in offsets), n)
    if tiling is not None and launch_tiling(tiling, dtype)[0].pays(n):
        return "sym_dia_spmv_tiled"
    return "sym_dia_spmv_rows" if len(offsets) <= MAX_PARAM_DIAGS else "sym_dia_spmv"


def dia_route(offsets: tuple) -> str:
    """The kernel that computes y = DIA x for these offsets: the launch
    counter's name, ``dia_spmv_rows`` wherever its parameter holds them (at
    most ``MAX_PARAM_DIAGS``), else ``dia_spmv``.  Only the count decides:
    on an H100 the by-value kernel was the faster one on every shape
    measured up to 32 diagonals, ragged n, rectangular operators and
    misaligned operands included (``chip_smoke.py`` times both), and one
    thread a row beyond, where its four times the warps hide latency
    better.  Pure Python: the same on every device."""
    return "dia_spmv_rows" if len(offsets) <= MAX_PARAM_DIAGS else "dia_spmv"


@functools.lru_cache(maxsize=256)
def host_offsets(offsets: tuple):
    """The offsets as an int32 ctypes array in host memory, made once per
    tuple: ``cg_dia_spmv_rows`` copies it into the launch's parameters."""
    return (ctypes.c_int32 * len(offsets))(*offsets)


def _check(name, diags, offsets, offsets_dev, x, ncols, max_diags=MAX_CUDA_DIAGS):
    if diags.dim() != 2:
        raise ValueError(f"{name}: diags must be (ndiag, n), got {tuple(diags.shape)}")
    ndiag = diags.shape[0]
    if diags.dtype not in OPERATOR_DTYPES:
        raise TypeError(f"{name}: diagonals must be float32 or bfloat16, got "
                        f"{diags.dtype}; use the plain path for other dtypes")
    if len(offsets) != ndiag:
        raise ValueError(f"{name}: {len(offsets)} offsets for {ndiag} diagonals")
    if offsets_dev.dtype != torch.int32 or tuple(offsets_dev.shape) != (ndiag,):
        raise ValueError(f"{name}: offsets_dev must be ({ndiag},) int32")
    if x.dim() != 1 or x.dtype != torch.float32 or (ncols is not None and x.shape[0] != ncols):
        raise ValueError(f"{name}: x must be 1-D float32"
                         f"{'' if ncols is None else f' of {ncols} entries'}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not on_cuda(name, diags, offsets_dev, x):
        return False
    if max_diags is not None and ndiag > max_diags:
        raise ValueError(f"{name}: the CUDA kernel takes at most {max_diags} "
                         f"diagonals, got {ndiag}")
    check_cuda_operands(name, (diags, offsets_dev, x))
    return True


def dia_spmv_diags(diags: torch.Tensor, offsets, offsets_dev: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y (n,) float32 = Σ_d diags[d] ⊙ x[i + offsets[d]].

    ``diags`` (ndiag, n) float32 or bfloat16, ``offsets`` the tuple of
    ints and ``offsets_dev`` the same as an int32 tensor beside ``diags``;
    ``x`` float32 of any length ncols (rectangular operators).  On a CUDA
    device the kernel :func:`dia_route` names runs, in the diagonals' form.
    """
    if not _check("dia_spmv", diags, offsets, offsets_dev, x, None):
        return _dia_plain(diags, offsets, x)
    offsets = tuple(offsets)
    return dia_cuda(diags, offsets, offsets_dev, x, dia_route(offsets))


def dia_cuda(diags, offsets: tuple, offsets_dev, x, route: str):
    """Launch one of the two general kernels on checked CUDA operands:
    ``dia_spmv_rows`` (the offsets from the host tuple) or ``dia_spmv``
    (from ``offsets_dev``), in the form of the diagonals' dtype."""
    from ._build import load_library

    ndiag, n = diags.shape
    y = x.new_empty(n)
    name = form(route, diags.dtype)
    fn = getattr(load_library(), f"cg_{name}")
    if route == "dia_spmv_rows":
        if ndiag > MAX_PARAM_DIAGS:
            raise ValueError(f"{route}: at most {MAX_PARAM_DIAGS} offsets, got {ndiag}")
        err = fn(ptr(diags), host_offsets(offsets), ptr(x), ptr(y), n, x.shape[0], ndiag,
                 stream(x.device))
    elif route == "dia_spmv":
        err = fn(ptr(diags), ptr(offsets_dev), ptr(x), ptr(y), n, x.shape[0], ndiag,
                 stream(x.device))
    else:
        raise ValueError(f"dia_spmv: no kernel {route!r}")
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return y


def _dia_plain(diags, offsets, x):
    if x.is_cuda:
        PLAIN_ON_CUDA[form("dia_spmv", diags.dtype)] += 1
    return dia_apply(diags.to(torch.float32), offsets, x)


def sym_dia_spmv_diags(diags: torch.Tensor, offsets, offsets_dev: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """y (n,) float32 = symmetric-DIA(diags, offsets ≥ 0) @ x; arguments as
    in :func:`dia_spmv_diags` (float32 or bfloat16 diagonals), x of n
    entries.  On a CUDA device the kernel :func:`sym_dia_route` names runs
    (``sym_dia_spmv`` takes at most ``MAX_CUDA_DIAGS`` diagonals), in the
    diagonals' form."""
    name = "sym_dia_spmv"
    if any(o < 0 for o in offsets):
        raise ValueError(f"{name}: symmetric storage holds offsets >= 0, got {offsets}")
    offsets = tuple(int(o) for o in offsets)
    if not _check(name, diags, offsets, offsets_dev, x, diags.shape[-1], max_diags=None):
        return _sym_dia_plain(diags, offsets, x)
    route = sym_dia_route(offsets, diags.shape[-1], diags.dtype)
    if route == name and len(offsets) > MAX_CUDA_DIAGS:
        raise ValueError(f"{name}: the CUDA kernel takes at most {MAX_CUDA_DIAGS} "
                         f"diagonals, got {len(offsets)}")
    return sym_dia_cuda(diags, offsets, offsets_dev, x, route)


def sym_dia_cuda(diags, offsets: tuple, offsets_dev, x, route: str,
                 tiling: Optional[SymDiaTiling] = None, stages: Optional[int] = None):
    """Launch one of the three symmetric kernels on checked CUDA operands,
    in the form of the diagonals' dtype: ``sym_dia_spmv_tiled`` (on
    ``tiling`` with ``stages`` diagonal stages, by default
    :func:`launch_tiling` of :func:`sym_dia_tiling`'s), ``sym_dia_spmv_rows``
    (the offsets from the host tuple) or ``sym_dia_spmv`` (from
    ``offsets_dev``)."""
    from ._build import load_library

    ndiag, n = diags.shape
    y = x.new_empty(n)
    name = form(route, diags.dtype)
    fn = getattr(load_library(), f"cg_{name}")
    if route == "sym_dia_spmv_tiled":
        if tiling is None:
            tiling = sym_dia_tiling(tuple(offsets), n)
            if tiling is None:
                raise ValueError(f"{route}: no tiling of offsets {offsets} at n = {n}")
            tiling, default = launch_tiling(tiling, diags.dtype)
            stages = default if stages is None else stages
        elif stages is None:
            stages = TILE_GEOMETRY[diags.dtype][1]
        err = fn(ptr(diags), ptr(offsets_dev), ptr(x), ptr(y), n, ndiag, tiling.pitch,
                 tiling.halo, tiling.planes, stages, stream(x.device))
    elif route == "sym_dia_spmv_rows":
        if ndiag > MAX_PARAM_DIAGS:
            raise ValueError(f"{route}: at most {MAX_PARAM_DIAGS} offsets, got {ndiag}")
        err = fn(ptr(diags), host_offsets(tuple(offsets)), ptr(x), ptr(y), n, ndiag,
                 stream(x.device))
    elif route == "sym_dia_spmv":
        err = fn(ptr(diags), ptr(offsets_dev), ptr(x), ptr(y), n, ndiag, stream(x.device))
    else:
        raise ValueError(f"sym_dia_spmv: no kernel {route!r}")
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return y


def _sym_dia_plain(diags, offsets, x):
    if x.is_cuda:
        PLAIN_ON_CUDA[form("sym_dia_spmv", diags.dtype)] += 1
    return sym_dia_apply(diags.to(torch.float32), offsets, x)
