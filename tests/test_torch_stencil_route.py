"""Kernel 11's route and the staged kernel's geometry, on the CPU.

``ops/cuda/stencil.stencil_route`` picks the kernel for a volume by its
shape, dtype and base alignment before any launch, and
``staged_geometry`` states the staged kernel's tile as ``csrc/stencil.cu``
computes it: both are plain Python, the same on every device, so they are
tested here.  ``test_staged_tile_model_gives_the_plain_stencil`` replays
the staged kernel's index arithmetic (each thread's copies into a stage,
its reads of it, its lane neighbours' points and the points carried along
x) in numpy on ragged volumes, with every stage element that no copy wrote
a NaN, and holds the result to the plain version (float64, the same sums
in the same order: equal).  The kernels themselves run on the card only
(``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import stencil as ks
from conjugategradient_tpu_torch.ops.stencil import stencil7_apply

DTYPES = [torch.float32, torch.float64, torch.bfloat16]
IDS = ["f32", "f64", "bf16"]


@pytest.mark.parametrize("dtype,nz,lanes", [
    (torch.float32, 256, 32), (torch.float32, 128, 32), (torch.float32, 64, 16),
    (torch.float32, 16, 4), (torch.float32, 4, 1), (torch.float32, 1000, 32),
    (torch.bfloat16, 256, 32), (torch.bfloat16, 16, 2), (torch.bfloat16, 8, 1),
    (torch.float64, 48, 32), (torch.float64, 8, 4), (torch.float64, 130, 32)])
def test_lanes_per_row(dtype, nz, lanes):
    assert ks.lanes_per_row(nz, dtype) == lanes


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, dict(lanes_per_row=32, points_per_lane=4, tile_rows=8, tile_points=128,
                         tiles_y=32, tiles_z=2, xchunk=8, ctas=2048, pitch=136,
                         stage_bytes=5440, stages=6)),
    (torch.float64, dict(lanes_per_row=32, points_per_lane=2, tile_rows=8, tile_points=64,
                         tiles_y=32, tiles_z=4, xchunk=8, ctas=4096, pitch=68,
                         stage_bytes=5440, stages=6)),
    (torch.bfloat16, dict(lanes_per_row=32, points_per_lane=8, tile_rows=8, tile_points=256,
                          tiles_y=32, tiles_z=1, xchunk=8, ctas=1024, pitch=272,
                          stage_bytes=5440, stages=6))], ids=IDS)
def test_staged_geometry_at_256_cubed(dtype, want):
    """A warp covers 512 bytes of a row in every type (a bf16 row of 256
    points is one tile wide, float32 and float64 rows two and four tiles);
    a stage is the tile's 8 rows and the two beside them, each with a
    16-byte halo either side; 8 planes a CTA."""
    assert ks.staged_geometry((256, 256, 256), dtype) == want


@pytest.mark.parametrize("nx,xchunk,stages", [(1, 2, 4), (16, 2, 4), (64, 2, 4), (65, 3, 4),
                                              (128, 4, 4), (255, 8, 6), (256, 8, 6),
                                              (1000, 8, 6)])
def test_staged_xchunk_and_ring_depth(nx, xchunk, stages):
    """About nx / 32 planes a CTA, from 2 to 8; 6 stages at 8 planes."""
    assert ks.staged_xchunk(nx) == xchunk and ks.staged_stages(xchunk) == stages


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_stencil_route_by_rows_and_alignment(dtype):
    """The staged kernel where nz·itemsize is a multiple of 16 on a 16-byte
    aligned base; the register march for other rows, for offset views (a
    row of a batch) whose base is not aligned, and below the size
    threshold."""
    esize = torch.empty((), dtype=dtype).element_size()
    v = 16 // esize
    least = ks.STAGED_MIN_POINTS[dtype]
    taken = least is not None
    nx = -(-(least or 1) // (9 * 8 * v))
    for nz in (v, 8 * v, 8 * v + 1, 7):
        buf = torch.zeros(nx * 9 * nz + 8, dtype=dtype)
        assert buf.data_ptr() % 16 == 0
        u = buf[:nx * 9 * nz].view(nx, 9, nz)
        want = taken and nz % v == 0 and u.numel() >= least
        assert ks.stencil_route(u) == ("stencil7_staged" if want else "stencil7"), nz
        for k in range(1, 8):
            w = buf[k:k + nx * 9 * nz].view(nx, 9, nz)
            staged = want and (k * esize) % 16 == 0
            assert ks.stencil_route(w) == ("stencil7_staged" if staged else "stencil7"), (nz, k)
    small = torch.zeros(1, 1, v, dtype=dtype)
    assert ks.stencil_route(small) == ("stencil7_staged" if taken and least <= v else "stencil7")


def test_float64_takes_the_register_march():
    """In float64 the register march is the faster kernel at 256^3 and at
    all but one smaller size measured (PERF.md), so the route never takes
    the staged kernel; in float32 it does from 64^3 on."""
    assert ks.stencil_route(torch.zeros(64, 64, 64, dtype=torch.float64)) == "stencil7"
    assert ks.stencil_route(torch.zeros(64, 64, 64)) == "stencil7_staged"


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_cpu_volume_runs_the_plain_version_and_counts_nothing(dtype):
    u = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 5, 16))).to(dtype)
    before = dict(_common.LAUNCHES), dict(_common.PLAIN_ON_CUDA)
    y = ks.stencil7(u, 6.0, -1.0)
    assert torch.equal(y, stencil7_apply(u, 6.0, -1.0))
    assert (dict(_common.LAUNCHES), dict(_common.PLAIN_ON_CUDA)) == before


def _staged_model(u, dtype, xchunk):
    """y from the staged kernel's index arithmetic (``csrc/stencil.cu``
    ``stencil7_staged_kernel``) in float64; stage elements no copy wrote
    are NaN."""
    nx, ny, nz = u.shape
    g = ks.staged_geometry(u.shape, dtype)
    lpr, v, ty, tz = g["lanes_per_row"], g["points_per_lane"], g["tile_rows"], g["tile_points"]
    tiles_z, pitch = g["tiles_z"], g["pitch"]
    uf, plane = u.reshape(-1), ny * nz
    y = np.full(u.shape, np.nan)
    chunks = -(-nx // xchunk)
    for cta in range(g["tiles_y"] * tiles_z * chunks):
        tile, x0 = divmod(cta, chunks)
        x0 *= xchunk
        x1 = min(x0 + xchunk, nx)
        threads = []
        for th in range(ks.STAGED_THREADS):
            r, lane = divmod(th, lpr)
            j, k = (tile // tiles_z) * ty + r, (tile % tiles_z) * tz + lane * v
            threads.append((r, lane, j, k, j < ny and k < nz, (r + 1) * pitch + v + lane * v))
        stages = {}
        for x in range(x0, min(x1, nx - 1) + 1):  # each thread's copies of a plane
            st = np.full((ty + 2) * pitch, np.nan)
            for r, lane, j, k, live, at in threads:
                if not live:
                    continue
                src = x * plane + j * nz + k
                st[at:at + v] = uf[src:src + v]
                if r == 0 and j > 0:
                    st[at - pitch:at - pitch + v] = uf[src - nz:src - nz + v]
                if r == ty - 1 and j + 1 < ny:
                    st[at + pitch:at + pitch + v] = uf[src + nz:src + nz + v]
                if lane == 0 and k > 0:
                    st[at - v:at] = uf[src - v:src]
                if lane == lpr - 1 and k + v < nz:
                    st[at + v:at + 2 * v] = uf[src + v:src + 2 * v]
            stages[x] = st
        carry = {}
        for x in range(x0, x1):
            st, zero = stages[x], np.zeros(v)
            rows = []
            for th, (r, lane, j, k, live, at) in enumerate(threads):
                if x == x0:
                    o = (x - 1) * plane + j * nz + k
                    um = uf[o:o + v] if live and x > 0 else zero
                    uc = st[at:at + v] if live else zero
                else:
                    um, uc = carry[th]
                up = stages[x + 1][at:at + v] if live and x + 1 < nx else zero
                ym = st[at - pitch:at - pitch + v] if live and j > 0 else zero
                yp = st[at + pitch:at + pitch + v] if live and j + 1 < ny else zero
                carry[th] = (uc, up)
                rows.append((um, uc, up, ym, yp))
            for th, (r, lane, j, k, live, at) in enumerate(threads):
                if not live:
                    continue
                um, uc, up, ym, yp = rows[th]
                zl = rows[th - 1][1][-1] if lane > 0 else None  # shuffles within the row
                zr = rows[th + 1][1][0] if lane < lpr - 1 else None
                if lane == 0:
                    zl = st[at - 1] if k > 0 else 0.0
                if lane == lpr - 1 or k + v >= nz:
                    zr = st[at + v] if k + v < nz else 0.0
                zm = np.concatenate([[zl], uc[:-1]])
                zp = np.concatenate([uc[1:], [zr]])
                y[x, j, k:k + v] = 6.0 * uc + -1.0 * (((um + up) + (ym + yp)) + (zm + zp))
    return y


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("shape", [(1, 1, 16), (2, 9, 16), (5, 2, 64), (3, 17, 272),
                                   (4, 3, 520)])
def test_staged_tile_model_gives_the_plain_stencil(dtype, shape):
    """The staged kernel's tiles, each thread's copies (its own 16 bytes,
    the rows and halo beside the tile), its lane neighbours and the points
    carried along x, with 1, 2 and 3 planes a CTA, reproduce the plain
    stencil: every point read comes from a copy or is a boundary 0."""
    u = np.random.default_rng(math.prod(shape)).standard_normal(shape)
    want = stencil7_apply(torch.from_numpy(u), 6.0, -1.0).numpy()
    for xchunk in (1, 2, 3):
        np.testing.assert_array_equal(_staged_model(u, dtype, xchunk), want)
