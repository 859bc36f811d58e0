"""The 7-point stencil: hand-written CUDA kernels for Hopper
(``csrc/stencil.cu``) beside their plain-torch version.

:func:`stencil7` replaces ``stencil7_pallas``
(``conjugategradient_tpu/ops/pallas/stencil.py:136``): y = c·u +
w·((x− + x+) + (y− + y+) + (z− + z+)) on a (nx, ny, nz) volume with zero
Dirichlet boundaries, in u's dtype (float32, float64 or bfloat16, as the
TPU kernel takes the input's dtype).  A bfloat16 volume rounds every
product and sum to bf16 as the plain version's torch ops do, so the two are
bit-equal.  Two kernels compute it, one template in the element type each,
and :func:`stencil_route` picks one by shape, dtype and alignment before
the launch: the staged kernel (16 bytes of a row a thread, planes staged
through shared memory by asynchronous copies; counted as
``stencil7_staged``) where u's rows are whole 16-byte pieces on a 16-byte
aligned base, u is float32 or bf16 and large enough, else the register
march (counted as ``stencil7``).  A bf16 volume's counters end in
``_bf16``.  The wrapper runs the plain version
(``ops/stencil.stencil7_apply``) when u lies on the CPU and launches a
kernel when it lies on a CUDA device; anything else raises (``_common``).
"""

from __future__ import annotations

import torch

from ..stencil import stencil7_apply
from ._common import (LAUNCHES, PLAIN_ON_CUDA, check_cuda_operands, form, on_cuda, ptr,
                      raise_on_error, stream)
from .fused_cg import _sm_count

_NAME = "stencil7"
_STAGED = "stencil7_staged"
#: the C entry points of each dtype the kernels take: register march, staged
_ENTRY = {torch.float32: "cg_stencil7_f32", torch.float64: "cg_stencil7_f64",
          torch.bfloat16: "cg_stencil7_bf16"}
_STAGED_ENTRY = {dt: name.replace("cg_stencil7_", "cg_stencil7_staged_")
                 for dt, name in _ENTRY.items()}
#: the register march's CTA tile of the (y, z) plane (csrc/common.cuh),
#: shared with kernel 12 (``fused_stencil``)
TILE_Y, TILE_Z = 8, 32
#: most x planes one CTA of the register march takes
MAX_XCHUNK = 32
#: threads of a staged CTA
STAGED_THREADS = 256
#: fewest points for which the staged kernel is taken, by dtype (None:
#: never).  Measured on an H100 (PERF.md, chip_smoke.py --stencil-only):
#: the staged kernel wins at 64^3 and above in float32 and bf16, the
#: register march at 32^3 and below (launch-bound, one CTA's set-up less);
#: in float64 the register march wins at 256^3 (by 12%), 128^3, 32^3 and
#: 16^3, and loses by 4% at 64^3 only
STAGED_MIN_POINTS = {torch.float32: 64 ** 3, torch.bfloat16: 64 ** 3, torch.float64: None}
#: x planes a staged CTA takes: about nx / 32, within [2, 8]; and its ring
#: depth: 6 stages where it takes 8 planes, else 4 (the fastest on an H100
#: at 64^3, 128^3 and 256^3: chip_smoke.py --stencil-only's sweep)
STAGED_CHUNKS, STAGED_XCHUNK = 32, (2, 8)


def xchunk(grid_shape, device) -> int:
    """x planes per CTA of the register march (kernels 11 and 12): up to
    ``MAX_XCHUNK``, fewer where the grid would otherwise give the card fewer
    than 8 CTAs per SM (each CTA re-reads two end planes, 2/xchunk of its
    bytes, from L2)."""
    nx, ny, nz = grid_shape
    tiles = -(-ny // TILE_Y) * -(-nz // TILE_Z)
    chunks = -(-8 * _sm_count(torch.device(device).index or 0) // tiles)
    return max(1, min(MAX_XCHUNK, -(-nx // chunks)))


def lanes_per_row(nz: int, dtype: torch.dtype) -> int:
    """Lanes of a staged tile row: the power of two, at most 32, that
    covers the row's nz points at 16 bytes a lane."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    lanes = 1
    while lanes < 32 and lanes * v < nz:
        lanes *= 2
    return lanes


def staged_xchunk(nx: int) -> int:
    """x planes a CTA of the staged kernel takes: ``nx / STAGED_CHUNKS``
    rounded up, within ``STAGED_XCHUNK``."""
    lo, hi = STAGED_XCHUNK
    return max(lo, min(hi, -(-nx // STAGED_CHUNKS)))


def staged_stages(xchunk: int) -> int:
    """The staged kernel's ring depth for CTAs of ``xchunk`` planes: a
    deeper ring pays only where a CTA marches far enough to fill it."""
    return 6 if xchunk >= 8 else 4


def staged_geometry(grid_shape, dtype: torch.dtype) -> dict:
    """The staged kernel's tile and grid on this volume, as
    ``csrc/stencil.cu`` (``StagedTile``) computes them: lanes a row, points
    a lane (16 bytes), the tile's rows and points a row, tiles in y and z,
    x planes a CTA, CTAs, a stage's pitch (points: the tile's row and a
    16-byte halo each side) and bytes ((rows + 2) x pitch), and the ring's
    stages."""
    nx, ny, nz = (int(n) for n in grid_shape)
    esize = torch.empty((), dtype=dtype).element_size()
    v = 16 // esize
    lpr = lanes_per_row(nz, dtype)
    tz, ty = lpr * v, STAGED_THREADS // lpr
    tiles_z, tiles_y = -(-nz // tz), -(-ny // ty)
    xc = staged_xchunk(nx)
    pitch = tz + 2 * v
    return {"lanes_per_row": lpr, "points_per_lane": v, "tile_rows": ty, "tile_points": tz,
            "tiles_y": tiles_y, "tiles_z": tiles_z, "xchunk": xc,
            "ctas": tiles_y * tiles_z * -(-nx // xc), "pitch": pitch,
            "stage_bytes": (ty + 2) * pitch * esize, "stages": staged_stages(xc)}


def stencil_route(u: torch.Tensor) -> str:
    """The kernel that applies the stencil to ``u``, by its launch
    counter's name (without ``_bf16``): ``stencil7_staged`` where each row
    of u is a whole number of 16-byte pieces (nz·itemsize % 16 == 0), u's
    base is 16-byte aligned (an offset view, such as a row of a batch,
    may not be) and u has at least ``STAGED_MIN_POINTS`` points of its
    dtype; else ``stencil7``, the register march, which takes any volume.
    Pure Python on shape, dtype and ``data_ptr() % 16``: the same on every
    device."""
    least = STAGED_MIN_POINTS.get(u.dtype)
    if least is None or u.numel() < least or (u.shape[2] * u.element_size()) % 16 or \
            u.data_ptr() % 16:
        return _NAME
    return _STAGED


def check_volume(name: str, u: torch.Tensor) -> None:
    if u.dim() != 3 or min(u.shape) < 1:
        raise ValueError(f"{name}: u must be a (nx, ny, nz) volume, got {tuple(u.shape)}")


def stencil7(u: torch.Tensor, center: float, off: float) -> torch.Tensor:
    """y (nx, ny, nz) = 7-point stencil of the volume ``u``; ``center`` and
    ``off`` are host floats (the operator's values, rounded to u's dtype
    by ``StencilOperator``; the kernels take them as float32 for float32
    and bfloat16 volumes, as torch keeps a scalar factor)."""
    check_volume(_NAME, u)
    if not on_cuda(_NAME, u):
        return _stencil7_plain(u, center, off)
    if u.dtype not in _ENTRY:
        raise TypeError(f"{_NAME}: the CUDA kernel takes float32 or float64 (or bfloat16), "
                        f"got {u.dtype}")
    check_cuda_operands(_NAME, (u,))
    from ._build import load_library

    nx, ny, nz = u.shape
    y = torch.empty_like(u)
    route = stencil_route(u)
    lib = load_library()
    if route == _STAGED:
        xc = staged_xchunk(nx)
        err = getattr(lib, _STAGED_ENTRY[u.dtype])(
            ptr(u), ptr(y), nx, ny, nz, center, off, lanes_per_row(nz, u.dtype), xc,
            staged_stages(xc), stream(u.device))
    else:
        err = getattr(lib, _ENTRY[u.dtype])(
            ptr(u), ptr(y), nx, ny, nz, center, off, xchunk(u.shape, u.device),
            stream(u.device))
    name = form(route, u.dtype)
    LAUNCHES[name] += 1
    raise_on_error(name, err)
    return y


def _stencil7_plain(u, center, off):
    if u.is_cuda:
        PLAIN_ON_CUDA[form(_NAME, u.dtype)] += 1
    return stencil7_apply(u, center, off)
