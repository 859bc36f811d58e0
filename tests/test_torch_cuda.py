"""The port's hand-written CUDA kernels against their plain-torch versions,
on the card.  Every test here is marked ``cuda`` and skips without a GPU.

This file imports torch and the port only (no jax), so it also runs where
the JAX package is not installed; from the repository root on a machine
with an NVIDIA GPU:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the other files.)
Tolerances: p_new, x' and r' bit for bit or to 1e-6 relative (two rounded
ops per element, the same on both sides); q and y to 1e-5 of their largest
entry and the dots to 1e-5 relative (f32 sums in another order).
"""

import dataclasses
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb
from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
from conjugategradient_tpu_torch.problems import block_tridiag_tiles
from conjugategradient_tpu_torch.types import BlockedEllMatrix, SymBellMatrix

RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block_csr(rng, nrb, bm, bn, per_row, ncols=None):
    """Random block-sparse host CSR: SPD with bm x bm tiles when ``ncols``
    is None, else a general (nrb*bm, ncols) pattern of bm x bn tiles."""
    n = nrb * bm
    A = np.zeros((n, n if ncols is None else ncols), np.float32)
    for i in range(nrb):
        if ncols is None:
            D = rng.standard_normal((bm, bm)).astype(np.float32)
            A[i * bm:(i + 1) * bm, i * bm:(i + 1) * bm] = D + D.T + 20 * np.eye(bm, dtype=np.float32)
            hi = np.arange(i + 1, nrb)
            for c in rng.choice(hi, size=min(per_row, len(hi)), replace=False):
                B = rng.standard_normal((bm, bm)).astype(np.float32)
                A[i * bm:(i + 1) * bm, c * bm:(c + 1) * bm] = B
                A[c * bm:(c + 1) * bm, i * bm:(i + 1) * bm] = B.T
        else:
            for c in rng.choice(-(-ncols // bn), size=per_row, replace=False):
                hi = min((c + 1) * bn, ncols)
                A[i * bm:(i + 1) * bm, c * bn:hi] = rng.standard_normal((bm, hi - c * bn))
    rows, cols = np.nonzero(A)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return A[rows, cols], cols, indptr, A.shape


def _close(got, want, rtol=RTOL):
    torch.testing.assert_close(got, want, rtol=0, atol=rtol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,ncols", [(32, 32, None), (8, 128, 1000), (128, 128, None),
                                         (8, 64, 300)])
def test_bell_spmv_kernel_matches_plain(dev, bm, bn, ncols):
    rng = np.random.default_rng(bm + bn)
    nrb = 5 if bm == 128 else 13
    a = BlockedEllMatrix.from_csr_host(*_block_csr(rng, nrb, bm, bn, 3, ncols), bm=bm, bn=bn,
                                       device=dev)
    x2d = torch.randn(a.padded_shape[1] // bn, bn, device=dev)
    before = fc.LAUNCHES["bell_spmv"]
    yk = kb.bell_spmv_tiles(a.blocks, a.block_cols, x2d)
    assert fc.LAUNCHES["bell_spmv"] == before + 1
    yp = kb._bell_plain(a.blocks, a.block_cols, x2d)
    torch.cuda.synchronize()
    _close(yk, yp)
    # bfloat16 tiles: the bf16 form, bit-equal to the float32 launch on the
    # widened tiles and within RTOL of its plain version
    lo = a.blocks.bfloat16()
    before = fc.LAUNCHES["bell_spmv_bf16"]
    yb = kb.bell_spmv_tiles(lo, a.block_cols, x2d)
    assert fc.LAUNCHES["bell_spmv_bf16"] == before + 1
    yw = kb.bell_spmv_tiles(lo.float(), a.block_cols, x2d)
    torch.cuda.synchronize()
    assert torch.equal(yb, yw)
    _close(yb, kb._bell_plain(lo, a.block_cols, x2d))


@pytest.mark.cuda
@pytest.mark.parametrize("row_group", [None, 1, 3])
@pytest.mark.parametrize("bn", [32, 128])
def test_full_dir_kernel_matches_plain(dev, bn, row_group):
    rng = np.random.default_rng(bn)
    a = BlockedEllMatrix.from_csr_host(*_block_csr(rng, 13, bn, bn, 3), bm=bn, bn=bn, device=dev)
    r, p = torch.randn(a.nrb, bn, device=dev), torch.randn(a.nrb, bn, device=dev)
    d = torch.rand(a.nrb, bn, device=dev) + 0.5
    for beta_v in (0.0, 0.37):
        beta = torch.full((1, 1), beta_v, device=dev)
        for dd in (None, d):
            before = fc.LAUNCHES["fused_dir_spmv_dot"]
            k = fc.fused_dir_spmv_dot(a.blocks, a.block_cols, r, p, beta, dd, row_group=row_group)
            assert fc.LAUNCHES["fused_dir_spmv_dot"] == before + 1
            pl = fc._full_dir_plain(a.blocks, a.block_cols, r, p, beta, dd, None, None)
            torch.cuda.synchronize()
            assert torch.equal(k[0], pl[0])
            _close(k[1], pl[1])
            np.testing.assert_allclose(float(k[2]), float(pl[2]), rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mirror", ["scatter", "banded"])
def test_sym_dir_and_update_kernels_match_plain(dev, mirror):
    rng = np.random.default_rng(1)
    bn, nrb = 32, 13
    if mirror == "banded":
        n = nrb * bn
        blocks, bcols, nnz = block_tridiag_tiles(n, bn, bn, seed=2)
        a = SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), (n, n), (n, n), nnz,
                                   check=False, device=dev)
        assert a.banded
    else:
        a = SymBellMatrix.from_bell(BlockedEllMatrix.from_csr_host(
            *_block_csr(rng, nrb, bn, bn, 3), bm=bn, bn=bn, device=dev))
    r, p = torch.randn(nrb, bn, device=dev), torch.randn(nrb, bn, device=dev)
    beta = torch.full((1, 1), 0.37, device=dev)
    k = fc.sym_fused_dir_spmv_dot(a.diag_blocks, a.off_blocks, a.off_cols, r, p, beta,
                                  mirror=mirror, row_group=4, mirror_src=a.mirror_src)
    pl = fc._sym_dir_plain(a.diag_blocks, a.off_blocks, a.off_cols, r, p, beta, None,
                           a.mirror_src, None, None)
    torch.cuda.synchronize()
    assert torch.equal(k[0], pl[0])
    _close(k[1], pl[1])
    np.testing.assert_allclose(float(k[2]), float(pl[2]), rtol=RTOL)
    x, d = torch.randn_like(r), torch.rand_like(r) + 0.5
    alpha = torch.full((1, 1), 0.5, device=dev)
    for kern, plain in (
        (fc.fused_update_dot(x, p, r, k[1], alpha),
         fc._update_plain("fused_update_dot", x, p, r, k[1], None, alpha, None, None)),
        (fc.fused_update_dot_pcg(x, p, r, k[1], d, alpha),
         fc._update_plain("fused_update_dot_pcg", x, p, r, k[1], d, alpha, None, None)),
    ):
        for g, w in zip(kern[:2], plain[:2]):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        for g, w in zip(kern[2:], plain[2:]):
            np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


def _dia_cases():
    """(label, diags (ndiag, n) f32, offsets, ncols): banded SPD, a
    stencil-scale half band, a ragged rectangular one, negative offsets
    only, and 511 diagonals (dense_256's count)."""
    from conjugategradient_tpu_torch.problems import banded_spd_coo
    from conjugategradient_tpu_torch.types import DIAMatrix

    rng = np.random.default_rng(11)
    out = []
    for n, bw in ((300, 5), (3000, 9)):
        rows, cols, vals, shape = banded_spd_coo(n, bandwidth=bw, seed=n)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
        order = np.lexsort((cols, rows))
        d = DIAMatrix.from_csr_host(vals[order].astype(np.float32), cols[order], indptr,
                                    shape, device="cpu")
        out.append((f"banded{n}", d.diags.numpy(), d.offsets, n))
    n, k = 4096, 1100
    full = np.stack([4.0 + rng.random(n), 0.1 * rng.standard_normal(n)]).astype(np.float32)
    full[1, n - k:] = 0.0
    out.append(("stencil-scale", full, (0, k), n))
    out.append(("rect 1001x1300", rng.standard_normal((4, 1001)).astype(np.float32),
                (-7, 0, 5, 299), 1300))
    out.append(("negative only", rng.standard_normal((3, 777)).astype(np.float32),
                (-300, -3, -1), 777))
    offs = tuple(range(-255, 256))
    out.append(("511 diagonals", rng.standard_normal((511, 256)).astype(np.float32), offs, 256))
    return out


@pytest.mark.cuda
def test_dia_kernels_bit_equal_to_plain(dev):
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    for label, diags, offsets, ncols in _dia_cases():
        d = torch.from_numpy(diags).to(dev)
        od = torch.tensor(offsets, dtype=torch.int32, device=dev)
        x = torch.randn(ncols, device=dev)
        route = kd.dia_route(offsets)
        assert route == ("dia_spmv" if len(offsets) > kd.MAX_PARAM_DIAGS else "dia_spmv_rows")
        before = fc.LAUNCHES[route]
        yk = kd.dia_spmv_diags(d, offsets, od, x)
        assert fc.LAUNCHES[route] == before + 1, label
        yp = kd._dia_plain(d, offsets, x)
        torch.cuda.synchronize()
        assert torch.equal(yk, yp), label
        if min(offsets) >= 0 and ncols == d.shape[1]:
            ys = kd.sym_dia_spmv_diags(d, offsets, od, x)
            assert torch.equal(ys, kd._sym_dia_plain(d, offsets, x)), label
        # bfloat16 diagonals: the route's bf16 form, bit-equal to the float32
        # launch on the widened diagonals and to the plain version
        lo = d.bfloat16()
        before = fc.LAUNCHES[f"{route}_bf16"]
        yb = kd.dia_spmv_diags(lo, offsets, od, x)
        assert fc.LAUNCHES[f"{route}_bf16"] == before + 1, label
        torch.cuda.synchronize()
        assert torch.equal(yb, kd.dia_spmv_diags(lo.float(), offsets, od, x)), label
        assert torch.equal(yb, kd._dia_plain(lo, offsets, x)), label
        if min(offsets) >= 0 and ncols == d.shape[1]:
            # kernel 10's bf16 form, on the route bf16 diagonals of this
            # shape take
            sroute = kd.sym_dia_route(tuple(offsets), d.shape[1], lo.dtype)
            before = fc.LAUNCHES[f"{sroute}_bf16"]
            ysb = kd.sym_dia_spmv_diags(lo, offsets, od, x)
            assert fc.LAUNCHES[f"{sroute}_bf16"] == before + 1, label
            torch.cuda.synchronize()
            assert torch.equal(ysb, kd.sym_dia_spmv_diags(lo.float(), offsets, od, x)), label
            assert torch.equal(ysb, kd._sym_dia_plain(lo, offsets, x)), label


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 1001, 110_592])
def test_dia_rows_kernel_bit_equal_to_plain_and_to_dia_spmv(dev, n):
    """Both kernels 7 on the same operands, bit for bit against the plain
    version: offsets beyond n on both sides, ncols equal to n, above and
    below it, a NaN in x, x (a view at offset 1) or the diagonals (a view
    at offset 1) not 16-byte aligned; a repeat gives the same bits.  The
    by-value kernel's bf16 form likewise, and bit-equal to the float32
    launch on the widened diagonals."""
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    g = torch.Generator().manual_seed(n)
    offsets = (-n - 3, -5, -1, 0, 1, 4, 48, n + 2)
    od = torch.tensor(offsets, dtype=torch.int32, device=dev)
    flat = torch.randn(len(offsets) * n + 1, generator=g).to(dev)
    flat16 = flat.bfloat16()
    bits = lambda t: t.view(torch.int32)  # noqa: E731  (NaN rows compare too)
    for shift in (0, 1):
        d = flat[shift:shift + len(offsets) * n].view(len(offsets), n)
        for ncols in (n, n + 37, max(1, n - 2)):
            xb = torch.randn(ncols + 1, generator=g).to(dev)
            xb[1 + ncols // 2] = float("nan")
            for xs in (0, 1):
                x = xb[xs:xs + ncols]
                before = fc.LAUNCHES["dia_spmv_rows"]
                y = kd.dia_cuda(d, offsets, od, x, "dia_spmv_rows")
                y2 = kd.dia_cuda(d, offsets, od, x, "dia_spmv_rows")
                yo = kd.dia_cuda(d, offsets, od, x, "dia_spmv")
                yp = kd._dia_plain(d, offsets, x)
                torch.cuda.synchronize()
                what = f"diags+{shift} ncols={ncols} x+{xs}"
                assert fc.LAUNCHES["dia_spmv_rows"] == before + 2, what
                assert torch.equal(bits(y), bits(yp)), what
                assert torch.equal(bits(y), bits(y2)) and torch.equal(bits(y), bits(yo)), what
                # the NaN at column c reaches rows c - off only, never a clamped one
                c = 1 + ncols // 2 - xs
                rows = {c - o for o in offsets if 0 <= c < ncols and 0 <= c - o < n}
                assert set(torch.isnan(y).nonzero().flatten().tolist()) == rows, what
                # the bf16 form (4 rows a thread) on bf16 diagonals at the same
                # offset into their buffer: the plain version's bits and the
                # float32 launch's on the widened diagonals
                lo = flat16[shift:shift + len(offsets) * n].view(len(offsets), n)
                before = fc.LAUNCHES["dia_spmv_rows_bf16"]
                yb = kd.dia_cuda(lo, offsets, od, x, "dia_spmv_rows")
                yb2 = kd.dia_cuda(lo, offsets, od, x, "dia_spmv_rows")
                yw = kd.dia_cuda(lo.float(), offsets, od, x, "dia_spmv_rows")
                ybp = kd._dia_plain(lo, offsets, x)
                torch.cuda.synchronize()
                assert fc.LAUNCHES["dia_spmv_rows_bf16"] == before + 2, what
                assert torch.equal(bits(yb), bits(ybp)) and torch.equal(bits(yb), bits(yw)), what
                assert torch.equal(bits(yb), bits(yb2)), what
    with pytest.raises(ValueError, match="at most"):
        kd.dia_cuda(torch.zeros(33, n, device=dev), tuple(range(33)),
                    torch.arange(33, dtype=torch.int32, device=dev), torch.zeros(n, device=dev),
                    "dia_spmv_rows")


@pytest.mark.cuda
def test_entry_points_default_to_the_card(dev):
    """``load_matrix`` and ``CSRMatrix.from_arrays`` called with no
    ``device`` put the operator on the card."""
    from conjugategradient_tpu_torch.io import load_matrix, read_csr_host
    from conjugategradient_tpu_torch.types import CSRMatrix

    path = pathlib.Path(__file__).resolve().parents[1] / "problems" / "poisson2d_34.mtx"
    data, indices, indptr, shape = read_csr_host(path)
    for op in (load_matrix(path), load_matrix(path, layout="csr", dtype=np.float64),
               CSRMatrix.from_arrays(data, indices, indptr, shape)):
        assert op.device.type == "cuda"


STENCIL_SHAPES = [(5, 6, 7), (3, 9, 130), (2, 2, 2), (1, 1, 1), (64, 33, 40)]


def _k11_launches(suffix=""):
    """Launches of kernel 11 on either route (the staged kernel or the
    register march; ``suffix`` "_bf16" for its bf16 forms)."""
    return fc.LAUNCHES["stencil7" + suffix] + fc.LAUNCHES["stencil7_staged" + suffix]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil7_kernel_bit_equal_to_plain(dev, dtype):
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    for shape in STENCIL_SHAPES:
        u = torch.randn(shape, dtype=dtype, device=dev)
        route = ks.stencil_route(u)  # the staged kernel or the register march
        before = fc.LAUNCHES[route]
        yk = ks.stencil7(u, 6.0, -1.0)
        assert fc.LAUNCHES[route] == before + 1
        yp = ks._stencil7_plain(u, 6.0, -1.0)
        torch.cuda.synchronize()
        assert torch.equal(yk, yp), shape
    u = torch.ones(6, 7, 8, dtype=dtype, device=dev)
    u[3, 0, 5] = float("nan")
    yk, yp = ks.stencil7(u, 4.25, -0.5), ks._stencil7_plain(u, 4.25, -0.5)
    assert torch.equal(torch.isnan(yk), torch.isnan(yp)) and int(torch.isnan(yk).sum()) == 6
    assert torch.equal(yk.nan_to_num(), yp.nan_to_num())
    with pytest.raises(TypeError, match="float32 or float64"):
        ks.stencil7(u.half(), 6.0, -1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ks.stencil7(u.transpose(0, 2), 6.0, -1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 6, 7), (16, 24, 100), (64, 64, 64)])
def test_fused_stencil_dir_kernel_bit_equal_and_deterministic(dev, shape):
    from conjugategradient_tpu_torch.ops.cuda import fused_stencil as kfs

    r, p = torch.randn(shape, device=dev), torch.randn(shape, device=dev)
    beta = torch.full((1, 1), 0.37, device=dev)
    before = fc.LAUNCHES["fused_stencil_dir_dot"]
    k1 = kfs.fused_stencil_dir_dot(r, p, beta, 6.0, -1.0)
    k2 = kfs.fused_stencil_dir_dot(r, p, beta, 6.0, -1.0)
    assert fc.LAUNCHES["fused_stencil_dir_dot"] == before + 2
    pl = kfs._fused_stencil_dir_plain(r, p, beta, 6.0, -1.0, None, None)
    torch.cuda.synchronize()
    assert torch.equal(k1[0], pl[0]) and torch.equal(k1[1], pl[1])
    np.testing.assert_allclose(float(k1[2]), float(pl[2]), rtol=RTOL)
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    # the scalar step, and a no-op once the solve is not live
    w = fc.FusedWork.new(dev, maxiter=4)
    w.scal[fc.S_RHO] = 2.5
    out = (torch.empty_like(r), torch.empty_like(r))
    _, _, pap = kfs.fused_stencil_dir_dot(r, p, w.beta, 6.0, -1.0, out=out, work=w)
    np.testing.assert_allclose(float(w.scal[fc.S_ALPHA]), 2.5 / float(pap), rtol=1e-6)
    w.ctl[fc.C_LIVE] = 0
    kept = [o.clone() for o in out] + [w.scal.clone()]
    kfs.fused_stencil_dir_dot(2 * r, p, w.beta, 6.0, -1.0, out=out, work=w)
    torch.cuda.synchronize()
    for a, b in zip(kept, [*out, w.scal]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 210, 4097, 262_144])
def test_update_kernel_scalar_tail(dev, n):
    x, p, r, q = (torch.randn(n, device=dev) for _ in range(4))
    d = torch.rand(n, device=dev) + 0.5
    alpha = torch.full((1, 1), 0.61, device=dev)
    for dd, name in ((None, "fused_update_dot"), (d, "fused_update_dot_pcg")):
        before = fc.LAUNCHES[name]
        k = (fc.fused_update_dot(x, p, r, q, alpha) if dd is None
             else fc.fused_update_dot_pcg(x, p, r, q, dd, alpha))
        assert fc.LAUNCHES[name] == before + 1
        pl = fc._update_plain(name, x, p, r, q, dd, alpha, None, None)
        torch.cuda.synchronize()
        assert torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1])
        for g, w in zip(k[2:], pl[2:]):
            np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


@pytest.mark.cuda
def test_stencil_solves_take_the_kernels(dev):
    from conjugategradient_tpu_torch import cg_solve, multigrid_preconditioner
    from conjugategradient_tpu_torch.types import StencilOperator

    op = StencilOperator.poisson((20, 18, 33), device=dev)
    b = torch.arange(1, op.shape[0] + 1, dtype=torch.float32, device=dev) / op.shape[0]
    tol = 1e-5 * float(b.norm())
    fc.reset_counts()
    x, info = cg_solve(op, b, tol=tol)
    assert bool(info.converged) and fc.LAUNCHES["fused_stencil_dir_dot"] >= int(info.iterations)
    assert fc.LAUNCHES["fused_update_dot"] >= int(info.iterations)
    _, again = cg_solve(op, b, tol=tol)
    assert torch.equal(info.rho_history.view(torch.int32), again.rho_history.view(torch.int32))
    xm, im = cg_solve(op, b, tol=tol, M=multigrid_preconditioner(op))
    assert bool(im.converged) and int(im.iterations) * 5 <= int(info.iterations)
    assert _k11_launches() > 0
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    with pytest.raises(ValueError, match="StencilOperator"):
        cg_solve(op, b, M=multigrid_preconditioner(op), fused="always")


# ---- kernels 14-16: the fused MINRES iteration ---------------------------------

def _minres_operands(a, dev, seed, with_d, first=False):
    """Six random (nrb, bn) vectors, the (1, 8) scalar row (``first``: the
    first step's, with no pending update) and d (or None)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    g = torch.Generator().manual_seed(seed)
    vecs = [torch.randn(a.nrb, a.bn, generator=g).to(dev) for _ in range(6)]
    su = torch.zeros(1, 8)
    su[0, fm.SU_INV_BETA], su[0, fm.SU_SHIFT] = 0.31, 0.07
    if not first:
        su[0, fm.SU_OLDEPS], su[0, fm.SU_DELTA] = 0.11, 0.23
        su[0, fm.SU_IGAMMA], su[0, fm.SU_PHI] = 0.57, 0.83
    d = (torch.rand(a.nrb, a.bn, generator=g) + 0.5).to(dev) if with_d else None
    return vecs, su.to(dev), d


def _check_minres_dir(k, pl):
    """v, w, x' bit for bit; q and the dots to RTOL."""
    torch.cuda.synchronize()
    for i in (0, 2, 3):
        assert torch.equal(k[i], pl[i]), ("v", "q", "w", "x")[i]
    _close(k[1], pl[1])
    for i in (4, 5):
        np.testing.assert_allclose(float(k[i]), float(pl[i]), rtol=RTOL,
                                   atol=RTOL * float(pl[1].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("bn,row_group", [(32, None), (32, 3), (128, 1)])
def test_minres_full_dir_kernel_matches_plain(dev, bn, row_group, with_d):
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.spmv import bell_apply

    rng = np.random.default_rng(bn)
    a = BlockedEllMatrix.from_csr_host(*_block_csr(rng, 13, bn, bn, 3), bm=bn, bn=bn, device=dev)
    for first in (False, True):
        vecs, su, d = _minres_operands(a, dev, 3, with_d, first)
        before = fc.LAUNCHES["minres_dir_spmv_dot"]
        k = fm.minres_dir_spmv_dot(a.blocks, a.block_cols, *vecs, su, d, row_group=row_group)
        k2 = fm.minres_dir_spmv_dot(a.blocks, a.block_cols, *vecs, su, d, row_group=row_group)
        assert fc.LAUNCHES["minres_dir_spmv_dot"] == before + 2
        pl = fm._dir_plain("minres_dir_spmv_dot",
                           lambda v: bell_apply(a.blocks, a.block_cols, v), vecs, su, d,
                           None, None)
        _check_minres_dir(k, pl)
        assert all(torch.equal(x, y) for x, y in zip(k, k2))
        if first:
            assert torch.equal(k[3], vecs[5]) and not k[2].any()  # x kept, w = 0
    # bf16 tiles: kernel 14's bf16 form, bit-equal to the float32 launch on
    # the widened tiles, and to the plain version where that one is
    lo = a.blocks.bfloat16()
    before = fc.LAUNCHES["minres_dir_spmv_dot_bf16"]
    kb16 = fm.minres_dir_spmv_dot(lo, a.block_cols, *vecs, su, d, row_group=row_group)
    assert fc.LAUNCHES["minres_dir_spmv_dot_bf16"] == before + 1
    k32 = fm.minres_dir_spmv_dot(lo.float(), a.block_cols, *vecs, su, d, row_group=row_group)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(kb16, k32))
    _check_minres_dir(kb16, fm._dir_plain(
        "minres_dir_spmv_dot_bf16", lambda v: bell_apply(lo.float(), a.block_cols, v), vecs,
        su, d, None, None))
    with pytest.raises(ValueError, match="alias"):
        fm.minres_dir_spmv_dot(a.blocks, a.block_cols, *vecs, su, d,
                               out=(vecs[0], *(torch.empty_like(vecs[0]) for _ in range(3))))


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("mirror", ["scatter", "banded"])
def test_minres_sym_dir_kernel_matches_plain_in_place(dev, mirror, with_d):
    """Kernel 15 against its plain version, launched in place as the solver
    launches it (v over v_prev, w over w-2, x over x)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.spmv import sym_bell_apply

    rng = np.random.default_rng(1)
    bn, nrb = 32, 13
    if mirror == "banded":
        n = nrb * bn
        blocks, bcols, nnz = block_tridiag_tiles(n, bn, bn, seed=2)
        a = SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), (n, n), (n, n), nnz,
                                   check=False, device=dev)
    else:
        a = SymBellMatrix.from_bell(BlockedEllMatrix.from_csr_host(
            *_block_csr(rng, nrb, bn, bn, 3), bm=bn, bn=bn, device=dev))
    op = (a.diag_blocks, a.off_blocks, a.off_cols)
    vecs, su, d = _minres_operands(a, dev, 5, with_d)
    pl = fm._dir_plain(
        "sym_minres_dir_spmv_dot",
        lambda v: sym_bell_apply(*op, a.mirror_src, v), vecs, su, d, None, None)
    for rg in (4, 8):
        k = fm.sym_minres_dir_spmv_dot(*op, *vecs, su, d, mirror=mirror, row_group=rg,
                                       mirror_src=a.mirror_src)
        _check_minres_dir(k, pl)
    r2, r1, vprev, wm1, wm2, x = (v.clone() for v in vecs)
    q = torch.empty_like(r2)
    before = fc.LAUNCHES["sym_minres_dir_spmv_dot"]
    k = fm.sym_minres_dir_spmv_dot(*op, r2, r1, vprev, wm1, wm2, x, su, d, mirror=mirror,
                                   row_group=4, mirror_src=a.mirror_src,
                                   out=(vprev, q, wm2, x))
    assert fc.LAUNCHES["sym_minres_dir_spmv_dot"] == before + 1
    _check_minres_dir(k, pl)
    assert torch.equal(r2, vecs[0]) and torch.equal(r1, vecs[1]) and torch.equal(wm1, vecs[3])


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("mirror", ["scatter", "banded"])
def test_minres_sym_dir_bf16_kernel_bit_equal(dev, mirror, with_d):
    """Kernel 15's bf16 form in both landings: bit-equal to the float32
    launch on the widened tiles, held to the plain version, and the packed
    form on ``SymBellMatrix.packed()`` of the bf16 tiles bit-equal to its
    plain version in v, q, w and x'; a NaN in the tiles reaches the dots."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.spmv import sym_bell_apply

    rng = np.random.default_rng(3)
    bn, nrb = 32, 13
    if mirror == "banded":
        n = nrb * bn
        blocks, bcols, nnz = block_tridiag_tiles(n, bn, bn, seed=4)
        a = SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), (n, n), (n, n), nnz,
                                   check=False, device=dev)
    else:
        a = SymBellMatrix.from_bell(BlockedEllMatrix.from_csr_host(
            *_block_csr(rng, nrb, bn, bn, 3), bm=bn, bn=bn, device=dev))
    lo = a.astype(torch.bfloat16)
    hi = lo.astype(torch.float32)
    vecs, su, d = _minres_operands(a, dev, 6, with_d)

    def launch(op):
        return fm.sym_minres_dir_spmv_dot(op.diag_blocks, op.off_blocks, op.off_cols, *vecs,
                                          su, d, mirror=mirror, row_group=4,
                                          mirror_src=op.mirror_src)

    before = fc.LAUNCHES["sym_minres_dir_spmv_dot_bf16"]
    kb16 = launch(lo)
    assert fc.LAUNCHES["sym_minres_dir_spmv_dot_bf16"] == before + 1
    k32 = launch(hi)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(kb16, k32))
    _check_minres_dir(kb16, fm._dir_plain(
        "sym_minres_dir_spmv_dot_bf16",
        lambda v: sym_bell_apply(hi.diag_blocks, hi.off_blocks, hi.off_cols, hi.mirror_src, v),
        vecs, su, d, None, None))
    pk = lo.packed()
    before = fc.LAUNCHES["sym_minres_dir_spmv_dot_packed_bf16"]
    kp = fm.minres_dir_spmv_dot_packed(pk, *vecs, su, d)
    assert fc.LAUNCHES["sym_minres_dir_spmv_dot_packed_bf16"] == before + 1
    pp = fm._dir_plain("sym_minres_dir_spmv_dot_packed_bf16", kb.packed_product(pk), vecs,
                       su, d, None, None)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(kp[:4], pp[:4]))
    for i in (4, 5):
        np.testing.assert_allclose(float(kp[i]), float(pp[i]), rtol=RTOL,
                                   atol=RTOL * float(pp[1].abs().max()))
    # a NaN tile value, widened, reaches q and both dots
    bad = lo.diag_blocks.clone()
    bad[0, 0, 0] = float("nan")
    kn = fm.sym_minres_dir_spmv_dot(bad, lo.off_blocks, lo.off_cols, *vecs, su, d,
                                    mirror=mirror, row_group=4, mirror_src=lo.mirror_src)
    torch.cuda.synchronize()
    assert torch.isnan(kn[1][0, 0]) and torch.isnan(kn[4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("shape", [(13, 32), (2048, 128)])
def test_minres_update_kernel_and_scalar_steps(dev, shape, with_d):
    """Kernel 16: r2' bit for bit (also written over r1), beta^2 to RTOL; the
    scalar steps of both kernels' last CTAs against the plain versions'
    torch ops on the same dots, to 2 ulp; a no-op once not live."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    q, r1, r2 = (torch.randn(shape, device=dev) for _ in range(3))
    d = torch.rand(shape, device=dev) + 0.5 if with_d else None

    def work():
        w = fm.MinresWork.new(dev, maxiter=9, tol=1e-3, shift=0.07)
        w.scal[fm.M_OLDB], w.scal[fm.M_DBAR], w.scal[fm.M_EPSLN] = 1.7, 0.4, 0.2
        w.scal[fm.M_CS], w.scal[fm.M_SN], w.scal[fm.M_ALFA] = -0.8, 0.6, 2.2
        w.scal[fm.M_C1], w.scal[fm.M_IA] = 0.4, 0.9
        w.start(torch.tensor(2.3, device=dev))
        return w

    wk, wp = work(), work()
    before = fc.LAUNCHES["minres_update_dot"]
    yk, bk = fm.minres_update_dot(q, r1, r2, wk.c1, wk.ia, d, work=wk)
    assert fc.LAUNCHES["minres_update_dot"] == before + 1
    yp, bp = fm._update_plain(q, r1, r2, wp.c1, wp.ia, d, None, None)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp)
    np.testing.assert_allclose(float(bk), float(bp), rtol=RTOL)
    fm.finish_update(wp, bk[0, 0])  # the plain scalar step on the kernel's own dot
    ulp = (wk.scal[:fm.M_VQ].view(torch.int32) - wp.scal[:fm.M_VQ].view(torch.int32)).abs().max()
    assert int(ulp) <= 2, (wk.scal, wp.scal)
    assert bk.data_ptr() == wk.dots[2].data_ptr()  # a solve's dots live in its work
    assert torch.equal(wk.ctl, wp.ctl) and int(wk.ctl[fc.C_K]) == 1
    for w in (wk, wp):  # hist[k] is the new estimate
        assert float(w.hist[1]) == float(w.scal[fm.M_PHIBAR]) and torch.isnan(w.hist[2])
    # in place over r1, as the solver launches it
    r1c = r1.clone()
    y2, _ = fm.minres_update_dot(q, r1c, r2, wp.c1, wp.ia, d, out=r1c)
    assert torch.equal(y2, yp) and y2.data_ptr() == r1c.data_ptr()
    # kernel 1's scalar step: c1, alpha, alpha / beta
    fm.finish_dir(wp, torch.tensor(1.3, device=dev), torch.tensor(-0.4, device=dev))
    beta, oldb = float(wp.scal[fm.M_BETA]), float(wp.scal[fm.M_OLDB])
    np.testing.assert_allclose(float(wp.scal[fm.M_C1]), beta / oldb, rtol=1e-6)
    # not live: nothing changes
    wk.ctl[fc.C_LIVE] = 0
    kept = (yk.clone(), wk.scal.clone(), wk.ctl.clone())
    fm.minres_update_dot(2 * q, r1, r2, wk.c1, wk.ia, d, out=yk, work=wk)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(kept, (yk, wk.scal, wk.ctl)))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["full", "sym-banded", "sym-general"])
def test_fused_minres_solve_takes_the_kernels(dev, storage):
    """The fused solve on the card against the plain-version loop on the
    CPU: history to 2e-3 over 24 steps (f32 sums in another order), bitwise
    repeatable, x flushed at caps 1, 2 and 7, and dispatched to by
    ``minres_solve``."""
    from conjugategradient_tpu_torch import fused_minres_solve, jacobi_preconditioner, minres_solve

    rng = np.random.default_rng(7)
    bn, nrb = 32, 13
    n = nrb * bn
    if storage == "sym-general":
        a = SymBellMatrix.from_bell(BlockedEllMatrix.from_csr_host(
            *_block_csr(rng, nrb, bn, bn, 3), bm=bn, bn=bn, device=dev))
    else:
        blocks, bcols, nnz = block_tridiag_tiles(n, bn, bn, seed=2)
        a = BlockedEllMatrix(torch.from_numpy(blocks).to(dev), torch.from_numpy(bcols).to(dev),
                             (n, n), nnz)
        if storage == "sym-banded":
            a = SymBellMatrix.from_bell(a)
            assert a.banded
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    name = "minres_dir_spmv_dot" if storage == "full" else "sym_minres_dir_spmv_dot"
    ac = a.to("cpu")
    for shift, M in ((0.0, None), (1.0, None), (0.0, jacobi_preconditioner(a))):
        inv = None if M is None else M.inv_diag
        fc.reset_counts()
        _, ik = minres_solve(a, b, tol=0.0, maxiter=24, shift=shift, M=M)
        assert fc.LAUNCHES[name] == fc.LAUNCHES["minres_update_dot"] == 24
        _, ik2 = fused_minres_solve(a, b, tol=0.0, maxiter=24, shift=shift, inv_diag=inv)
        assert torch.equal(ik.rnorm_history.view(torch.int32), ik2.rnorm_history.view(torch.int32))
        _, ip = fused_minres_solve(ac, b.cpu(), tol=0.0, maxiter=24, shift=shift,
                                   inv_diag=None if inv is None else inv.cpu())
        hk, hp = ik.rnorm_history.double().cpu().numpy(), ip.rnorm_history.double().numpy()
        np.testing.assert_allclose(hk, hp, rtol=2e-3, atol=1e-6 * hp[0])
        assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    for cap in (1, 2, 7):
        xk, ik = fused_minres_solve(a, b, tol=0.0, maxiter=cap)
        xp, _ = minres_solve(ac, b.cpu(), tol=0.0, maxiter=cap, fused="never")
        assert int(ik.iterations) == cap
        torch.testing.assert_close(xk.cpu(), xp, rtol=1e-4, atol=1e-6)
    x, info = minres_solve(a, torch.zeros_like(b), tol=1e-30)
    assert int(info.iterations) == 0 and not x.any()


# ---- kernels 18-20: the fused BiCGStab iteration ---------------------------------------

def _nonsym_tridiag(n, bn, dev, seed=0):
    """The nonsymmetric block-tridiagonal operator of the JAX bench lane
    bicgstab-bell (bench.py:1385-1403): up/lo tiles 0.08 N(0, 1), the
    diagonal (2 + sum|up| + sum|lo|) I."""
    nrb = n // bn
    rng = np.random.default_rng(seed)
    up = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    lo = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    diag = np.eye(bn, dtype=np.float32) * (2.0 + np.abs(up).sum() + np.abs(lo).sum())
    blocks = np.zeros((nrb, 3, bn, bn), np.float32)
    cols = np.zeros((nrb, 3), np.int32)
    for i in range(nrb):
        blocks[i, 0], cols[i, 0] = diag, i
        k = 1
        for c, t in ((i - 1, lo), (i + 1, up)):
            if 0 <= c < nrb:
                blocks[i, k], cols[i, k] = t, c
                k += 1
    return BlockedEllMatrix(torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev),
                            (n, n), nrb * 3 * bn * bn)


def _bicg_work(dev):
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    w = fb.BicgstabWork.new(dev, maxiter=5, tol=1e-3)
    w.scal[fb.B_RHO_NEXT] = 1.7
    w.start(torch.tensor(2.3, device=dev))
    return w


def _tail_ulps(wk, wp):
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    return int((wk.scal[:fb.B_RV].view(torch.int32)
                - wp.scal[:fb.B_RV].view(torch.int32)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("bn,row_group", [(32, None), (64, 3), (128, 1)])
def test_bicgstab_tile_kernels_match_plain(dev, bn, row_group, with_d):
    """Kernels 18 and 19 on a ragged nrb = 13: p', p̂, s, ŝ, x_h bit for bit,
    v' and t to RTOL of their largest entry, the dots to RTOL, two launches
    bit-identical, and the last CTAs' scalar steps within 2 ulp of torch's
    on the kernels' own dots."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    a = _nonsym_tridiag(13 * bn, bn, dev, seed=bn)
    g = torch.Generator().manual_seed(bn)
    r, p, v, rhat, x = (torch.randn(a.nrb, bn, generator=g).to(dev) for _ in range(5))
    d = (torch.rand(a.nrb, bn, generator=g) + 0.5).to(dev) if with_d else None
    beta, omega = torch.full((1, 1), 0.4, device=dev), torch.full((1, 1), 0.25, device=dev)
    wk, wp = _bicg_work(dev), _bicg_work(dev)
    k1 = fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, d,
                                  row_group=row_group, work=wk)
    k1b = fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, d,
                                   row_group=row_group)
    p1 = fb._tile_dir_plain(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, d, None, None)
    torch.cuda.synchronize()
    assert torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1])
    _close(k1[2], p1[2])
    np.testing.assert_allclose(float(k1[3]), float(p1[3]), rtol=RTOL,
                               atol=RTOL * float(rhat.norm() * p1[2].norm()))
    assert all(torch.equal(s, t) for s, t in zip(k1, k1b))
    fb.finish_dir(wp, k1[3][0, 0])
    assert _tail_ulps(wk, wp) <= 2
    alpha = torch.full((1, 1), 0.6, device=dev)
    k2 = fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, r, k1[2], x, k1[1], alpha, d,
                                row_group=row_group, work=wk)
    k2b = fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, r, k1[2], x, k1[1], alpha, d,
                                 row_group=row_group)
    p2 = fb._tile_s_plain(a.blocks, a.block_cols, r, k1[2], x, k1[1], alpha, d, None, None)
    torch.cuda.synchronize()
    for i in range(3):
        assert torch.equal(k2[i], p2[i]), ("s", "shat", "xh")[i]
    _close(k2[3], p2[3])
    for i in range(4, 7):
        np.testing.assert_allclose(float(k2[i]), float(p2[i]), rtol=RTOL,
                                   atol=RTOL * float(p2[3].norm() * p2[0].norm()))
    assert all(torch.equal(s, t) for s, t in zip(k2, k2b))
    fb.finish_s(wp, k2[4][0, 0], k2[5][0, 0], k2[6][0, 0])
    assert _tail_ulps(wk, wp) <= 2 and torch.equal(wk.ctl, wp.ctl)
    assert fc.PLAIN_ON_CUDA["bicgstab_dir_spmv_dot"] >= 1  # the comparisons above
    with pytest.raises(ValueError, match="gather"):
        fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, r, p, v, rhat, beta, omega,
                                 out=(torch.empty_like(r), torch.empty_like(r), v))
    with pytest.raises(ValueError, match="gather"):
        fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, r, k1[2], x, k1[1], alpha,
                               out=(r, torch.empty_like(r), torch.empty_like(r),
                                    torch.empty_like(r)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 210, 4097, 262_144])
def test_bicgstab_update_kernel_matches_plain(dev, n):
    """Kernel 20 at lengths with and without a scalar tail: x', r' bit for
    bit (also in place over x_h and s), the dots to RTOL, the step's scalars
    within 2 ulp and its control words equal; two more launches on a fresh
    work repeat every output and scalar bit for bit and leave the ticket at
    0; ω = 0 returns x_h and s."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    g = torch.Generator().manual_seed(n)
    xh, sh, s, t, rhat = (torch.randn(n, generator=g).to(dev) for _ in range(5))
    w = torch.full((1, 1), 0.45, device=dev)
    wk, wp = _bicg_work(dev), _bicg_work(dev)
    k = fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, work=wk)
    p = fb._update_plain(xh, sh, s, t, rhat, w, None, None)
    xc, sc = xh.clone(), s.clone()
    k2 = fb.bicgstab_update_dot(xc, sh, sc, t, rhat, w, out=(xc, sc))
    reps = []
    for _ in range(2):
        wr = _bicg_work(dev)
        out = fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, work=wr)
        reps.append([v.clone() for v in (*out, wr.scal, wr.ctl, wr.hist, wr.counter)])
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k2[0], p[0]) and torch.equal(k2[1], p[1])
    assert k2[0].data_ptr() == xc.data_ptr() and k2[1].data_ptr() == sc.data_ptr()
    first = [v.clone() for v in (*k, wk.scal, wk.ctl, wk.hist, wk.counter)]
    for r in reps:
        assert all(_same_bits(a, b) for a, b in zip(first, r)) and int(r[-1]) == 0
    for i in (2, 3):
        np.testing.assert_allclose(float(k[i]), float(p[i]), rtol=RTOL,
                                   atol=RTOL * float(p[1].norm() * (p[1] if i == 2 else rhat).norm()))
    fb.finish_update(wp, k[2][0, 0], k[3][0, 0])
    assert _tail_ulps(wk, wp) <= 2 and torch.equal(wk.ctl, wp.ctl) and int(wk.ctl[0]) == 1
    z = fb.bicgstab_update_dot(xh, sh, s, t, rhat, torch.zeros(1, 1, device=dev))
    assert torch.equal(z[0], xh) and torch.equal(z[1], s)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 262_144])
def test_bicgstab_update_kernel_writes_nothing_when_not_live(dev, n):
    """Kernel 20 loads its operands and the step's scalars before it reads
    ctl[C_LIVE]: on a solve that is not live, written in place as the loop
    launches it (x' over x_h, r' over s), nothing changes (x_h, s, the
    partials, scal, ctl, hist) and the ticket stays at 0."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    g = torch.Generator().manual_seed(n)
    xh, sh, s, t, rhat = (torch.randn(n, generator=g).to(dev) for _ in range(5))
    w = torch.full((1, 1), 0.45, device=dev)
    work = _bicg_work(dev)
    work.ctl[fb.C_LIVE] = 0
    work.partials.fill_(7.0)
    bufs = (xh, s, work.partials, work.counter, work.scal, work.ctl, work.hist)
    kept = [b.clone() for b in bufs]
    fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, out=(xh, s), work=work)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(kept, bufs))
    assert int(work.counter) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
def test_fused_bicgstab_solve_takes_the_kernels(dev, with_d):
    """``bicgstab_solve(fused="always")`` on the card: three launches a step
    and no plain version, bitwise repeatable, its history against the
    portable loop on the card to 5e-3 over 10 steps, and against the plain
    versions on the CPU."""
    from conjugategradient_tpu_torch import (bicgstab_solve, fused_bicgstab_solve,
                                             jacobi_preconditioner)

    bn = 32
    a = _nonsym_tridiag(13 * bn, bn, dev, seed=3)
    # a weaker diagonal than the bench lane's, so that BiCGStab needs steps
    a.blocks[:, 0] *= 0.1
    n = a.n
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    M = jacobi_preconditioner(a) if with_d else None
    fc.reset_counts()
    xk, ik = bicgstab_solve(a, b, tol=0.0, maxiter=10, M=M, fused="always")
    assert all(fc.LAUNCHES[k] == 10 for k in ("bicgstab_dir_spmv_dot", "bicgstab_s_spmv_dot",
                                              "bicgstab_update_dot"))
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    xk2, ik2 = bicgstab_solve(a, b, tol=0.0, maxiter=10, M=M, fused="always")
    assert torch.equal(xk, xk2) and torch.equal(ik.rnorm_history.view(torch.int32),
                                                 ik2.rnorm_history.view(torch.int32))
    _, ip = bicgstab_solve(a, b, tol=0.0, maxiter=10, M=M)
    _, ic = fused_bicgstab_solve(a.to("cpu"), b.cpu(), tol=0.0, maxiter=10,
                                 inv_diag=None if M is None else M.inv_diag.cpu())
    hk = ik.rnorm_history.double().cpu().numpy()
    np.testing.assert_allclose(hk, ip.rnorm_history.double().cpu().numpy(), rtol=5e-3)
    np.testing.assert_allclose(hk, ic.rnorm_history.double().numpy(), rtol=5e-3)
    x, info = bicgstab_solve(a, torch.zeros_like(b), tol=1e-30, fused="always")
    assert int(info.iterations) == 0 and not x.any()



# ---- kernels 18 and 19 on the packed nonzeros of sparse tiles -------------------

def _convdiff(nx, bn, dev):
    """The 5-point upwind convection-diffusion operator (peclet 10) on an
    nx x nx grid as float32 blocked-ELL with bn x bn tiles: sparse tiles."""
    from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo

    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=10.0)
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=shape[0]))])
    return BlockedEllMatrix.from_csr_host(vals[order].astype(np.float32), cols[order], indptr,
                                          shape, bm=bn, bn=bn, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,bn", [(64, 128), (37, 32)], ids=["convdiff64", "ragged37-bn32"])
def test_bicgstab_packed_kernels_bit_equal_to_plain(dev, nx, bn):
    """Kernels 18 and 19 on the packed view, ± Jacobi d: p', p̂, v', s, ŝ,
    x_h and t bit-equal to the plain versions (one rounding per product
    and per sum, in the same order), the dots to RTOL, the last CTAs'
    scalar steps within 2 ulp of torch's on the kernels' own dots, repeats
    bit-identical; outputs over gathered inputs refused."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    a = _convdiff(nx, bn, dev)
    assert bell_packed_route(a)
    pk = a.packed()
    g = torch.Generator().manual_seed(nx)
    r, p, v, rhat, x = (torch.randn(a.nrb, bn, generator=g).to(dev) for _ in range(5))
    d = torch.ones(a.nrb * bn, device=dev)
    d[:a.n] = 1.0 / a.diagonal()
    beta, omega = torch.full((1, 1), 0.4, device=dev), torch.full((1, 1), 0.25, device=dev)
    alpha = torch.full((1, 1), 0.6, device=dev)
    for dd in (None, d.view(a.nrb, bn)):
        fc.reset_counts()
        wk, wp = _bicg_work(dev), _bicg_work(dev)
        k1 = fb.bicgstab_dir_spmv_dot_packed(pk, r, p, v, rhat, beta, omega, dd, work=wk)
        k1b = fb.bicgstab_dir_spmv_dot_packed(pk, r, p, v, rhat, beta, omega, dd)
        p1 = fb._packed_dir_plain(pk, r, p, v, rhat, beta, omega, dd, None, None)
        torch.cuda.synchronize()
        for i in range(3):
            assert torch.equal(k1[i], p1[i]), ("p'", "phat", "v'")[i]
        assert all(torch.equal(s, t) for s, t in zip(k1, k1b))
        np.testing.assert_allclose(float(k1[3]), float(p1[3]), rtol=RTOL,
                                   atol=RTOL * float(rhat.norm() * p1[2].norm()))
        fb.finish_dir(wp, k1[3][0, 0])
        assert _tail_ulps(wk, wp) <= 2
        k2 = fb.bicgstab_s_spmv_dot_packed(pk, r, k1[2], x, k1[1], alpha, dd, work=wk)
        k2b = fb.bicgstab_s_spmv_dot_packed(pk, r, k1[2], x, k1[1], alpha, dd)
        p2 = fb._packed_s_plain(pk, r, k1[2], x, k1[1], alpha, dd, None, None)
        torch.cuda.synchronize()
        for i in range(4):
            assert torch.equal(k2[i], p2[i]), ("s", "shat", "xh", "t")[i]
        assert all(torch.equal(s, t) for s, t in zip(k2, k2b))
        for i in range(4, 7):
            np.testing.assert_allclose(float(k2[i]), float(p2[i]), rtol=RTOL,
                                       atol=RTOL * float(p2[3].norm() * p2[0].norm()))
        fb.finish_s(wp, k2[4][0, 0], k2[5][0, 0], k2[6][0, 0])
        assert _tail_ulps(wk, wp) <= 2 and torch.equal(wk.ctl, wp.ctl)
        assert fc.LAUNCHES["bicgstab_dir_spmv_dot_packed"] == 2
        assert fc.LAUNCHES["bicgstab_s_spmv_dot_packed"] == 2
        assert fc.LAUNCHES["bicgstab_dir_spmv_dot"] == fc.LAUNCHES["bicgstab_s_spmv_dot"] == 0
    with pytest.raises(ValueError, match="gather"):
        fb.bicgstab_dir_spmv_dot_packed(pk, r, p, v, rhat, beta, omega,
                                        out=(torch.empty_like(r), torch.empty_like(r), p))
    with pytest.raises(ValueError, match="gather"):
        fb.bicgstab_s_spmv_dot_packed(pk, r, k1[2], x, k1[1], alpha,
                                      out=(torch.empty_like(r), torch.empty_like(r),
                                           torch.empty_like(r), k1[2]))


@pytest.mark.cuda
def test_fused_bicgstab_solve_takes_the_packed_kernels(dev):
    """``bicgstab_solve(fused="always")`` on convection-diffusion nx = 64
    (sparse 128 x 128 tiles): the packed kernels 18 and 19 and kernel 20
    once a step each, no dense kernel and no plain version on CUDA, the view
    built once, bitwise repeatable; its history against the portable loop
    on the card to 5e-3 over 10 steps."""
    from conjugategradient_tpu_torch import bicgstab_solve, jacobi_preconditioner

    a = _convdiff(64, 128, dev)
    b = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
    for M in (None, jacobi_preconditioner(a)):
        a.packed()
        fc.reset_counts()
        xk, ik = bicgstab_solve(a, b, tol=0.0, maxiter=12, M=M, fused="always")
        assert int(ik.iterations) == 12
        assert all(fc.LAUNCHES[k] == 12 for k in (
            "bicgstab_dir_spmv_dot_packed", "bicgstab_s_spmv_dot_packed", "bicgstab_update_dot"))
        assert fc.LAUNCHES["bicgstab_dir_spmv_dot"] == fc.LAUNCHES["bicgstab_s_spmv_dot"] == 0
        assert fc.LAUNCHES["bell_pack"] == 0  # built once, before the counts were reset
        assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
        xk2, ik2 = bicgstab_solve(a, b, tol=0.0, maxiter=12, M=M, fused="always")
        assert torch.equal(xk, xk2) and torch.equal(ik.rnorm_history.view(torch.int32),
                                                     ik2.rnorm_history.view(torch.int32))
        _, ip = bicgstab_solve(a, b, tol=0.0, maxiter=12, M=M)
        np.testing.assert_allclose(ik.rnorm_history[:11].double().cpu().numpy(),
                                   ip.rnorm_history[:11].double().cpu().numpy(), rtol=5e-3)

# ---- the bf16 forms of kernels 18 and 19 ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("step", ["first", "later"])
@pytest.mark.parametrize("form", ["dense", "packed"])
def test_bicgstab_bf16_kernels_bit_equal(dev, form, step):
    """Kernels 18 and 19 on bf16 tiles (dense: the bicgstab-bell operator
    at nrb = 13, bn = 128; packed: convection-diffusion nx = 64's bf16
    view), ± Jacobi d, on a first step (beta 0, omega 1) and a later one:
    one launch of the ``_bf16`` form each, every output bit-equal to the
    float32 launch on the widened operator, and held to the plain version
    as the float32 forms are (p', p̂, s, ŝ, x_h bit for bit; v' and t bit
    for bit packed, to RTOL dense; the dots to RTOL)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    a = (_nonsym_tridiag(13 * 128, 128, dev) if form == "dense"
         else _convdiff(64, 128, dev)).astype(torch.bfloat16)
    wide = a.astype(torch.float32)
    bn = a.bn
    g = torch.Generator().manual_seed(18)
    r, p, v, rhat, x = (torch.randn(a.nrb, bn, generator=g).to(dev) for _ in range(5))
    d = (torch.rand(a.nrb, bn, generator=g) + 0.5).to(dev)
    beta, omega = (torch.full((1, 1), s, device=dev)
                   for s in ((0.0, 1.0) if step == "first" else (0.4, 0.25)))
    alpha = torch.full((1, 1), 0.6, device=dev)
    if form == "dense":
        dir_k = lambda op, *args: fb.bicgstab_dir_spmv_dot(op.blocks, op.block_cols, *args)  # noqa: E731
        s_k = lambda op, *args: fb.bicgstab_s_spmv_dot(op.blocks, op.block_cols, *args)  # noqa: E731
        dir_p = lambda *args: fb._tile_dir_plain(a.blocks, a.block_cols, *args, None, None)  # noqa: E731
        s_p = lambda *args: fb._tile_s_plain(a.blocks, a.block_cols, *args, None, None)  # noqa: E731
        names = ("bicgstab_dir_spmv_dot_bf16", "bicgstab_s_spmv_dot_bf16")
    else:
        pk = a.packed()
        assert pk.vals.dtype == torch.bfloat16
        dir_k = lambda op, *args: fb.bicgstab_dir_spmv_dot_packed(op.packed(), *args)  # noqa: E731
        s_k = lambda op, *args: fb.bicgstab_s_spmv_dot_packed(op.packed(), *args)  # noqa: E731
        dir_p = lambda *args: fb._packed_dir_plain(pk, *args, None, None)  # noqa: E731
        s_p = lambda *args: fb._packed_s_plain(pk, *args, None, None)  # noqa: E731
        names = ("bicgstab_dir_spmv_dot_packed_bf16", "bicgstab_s_spmv_dot_packed_bf16")
    for dd in (None, d):
        before = [fc.LAUNCHES[n] for n in names]
        k1 = dir_k(a, r, p, v, rhat, beta, omega, dd)
        w1 = dir_k(wide, r, p, v, rhat, beta, omega, dd)
        p1 = dir_p(r, p, v, rhat, beta, omega, dd)
        k2 = s_k(a, r, k1[2], x, k1[1], alpha, dd)
        w2 = s_k(wide, r, k1[2], x, k1[1], alpha, dd)
        p2 = s_p(r, k1[2], x, k1[1], alpha, dd)
        torch.cuda.synchronize()
        assert [fc.LAUNCHES[n] for n in names] == [b + 1 for b in before]
        assert all(torch.equal(s_, t) for s_, t in zip(k1, w1))
        assert all(torch.equal(s_, t) for s_, t in zip(k2, w2))
        assert torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1])
        for i in range(3):
            assert torch.equal(k2[i], p2[i]), ("s", "shat", "xh")[i]
        if form == "packed":
            assert torch.equal(k1[2], p1[2]) and torch.equal(k2[3], p2[3])
        else:
            _close(k1[2], p1[2])
            _close(k2[3], p2[3])
        np.testing.assert_allclose(float(k1[3]), float(p1[3]), rtol=RTOL,
                                   atol=RTOL * float(rhat.norm() * p1[2].norm()))
        for i in range(4, 7):
            np.testing.assert_allclose(float(k2[i]), float(p2[i]), rtol=RTOL,
                                       atol=RTOL * float(p2[3].norm() * p2[0].norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "packed"])
def test_fused_bicgstab_bf16_solve_takes_the_bf16_kernels(dev, form):
    """``bicgstab_solve(fused="always")`` on bf16 tiles (float32 b): the
    bf16 forms of kernels 18 and 19 (dense or packed by the route) with
    kernel 20 once a step each, no plain version on CUDA, bitwise
    repeatable and bit-equal to the solve on the widened tiles; a NaN tile
    value sets the sticky breakdown flag after one step."""
    import dataclasses

    from conjugategradient_tpu_torch import bicgstab_solve
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    a = (_nonsym_tridiag(64 * 128, 128, dev) if form == "dense"
         else _convdiff(64, 128, dev)).astype(torch.bfloat16)
    assert bell_packed_route(a) == (form == "packed")
    suffix = "_packed_bf16" if form == "packed" else "_bf16"
    b = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
    fc.reset_counts()
    x, info = bicgstab_solve(a, b, tol=0.0, maxiter=8, fused="always")
    k = int(info.iterations)
    assert 1 <= k <= 8
    assert fc.LAUNCHES["bicgstab_dir_spmv_dot" + suffix] >= k
    assert fc.LAUNCHES["bicgstab_s_spmv_dot" + suffix] >= k
    assert fc.LAUNCHES["bicgstab_update_dot"] >= k
    assert fc.LAUNCHES["bicgstab_dir_spmv_dot"] == fc.LAUNCHES["bicgstab_s_spmv_dot"] == 0
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    x2, _ = bicgstab_solve(a, b, tol=0.0, maxiter=8, fused="always")
    x3, _ = bicgstab_solve(a.astype(torch.float32), b, tol=0.0, maxiter=8, fused="always")
    assert torch.equal(x, x2) and torch.equal(x, x3)
    bad = a.blocks.clone()
    bad[0, 0, 0, 0] = float("nan")
    _, ninfo = bicgstab_solve(dataclasses.replace(a, blocks=bad), b, tol=0.0, maxiter=8,
                              fused="always")
    assert bool(ninfo.breakdown) and not bool(ninfo.converged) and int(ninfo.iterations) == 1


# ---- the bf16 form of kernel 11 -----------------------------------------------------

@pytest.mark.cuda
def test_stencil7_bf16_kernel_bit_equal_to_plain(dev):
    """Kernel 11 on bf16 volumes: one launch of ``stencil7_bf16``, bit-equal
    to the plain version (every product and sum rounded to bf16 on both
    sides), with coefficients exact in bf16 and not; on integer-valued
    input, where no op rounds, also to the float32 launch on the widened
    volume; a NaN reaches only its point and its six neighbours."""
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    bf16 = torch.bfloat16
    for shape in STENCIL_SHAPES:
        u = torch.randn(shape, device=dev).to(bf16)
        route = ks.stencil_route(u) + "_bf16"  # the staged kernel or the register march
        for c, w in ((6.0, -1.0), (4.25, -0.5), (0.1, -1 / 3)):
            before = fc.LAUNCHES[route]
            yk = ks.stencil7(u, c, w)
            assert fc.LAUNCHES[route] == before + 1 and yk.dtype == bf16
            yp = ks._stencil7_plain(u, c, w)
            torch.cuda.synchronize()
            assert torch.equal(yk, yp), (shape, c, w)
        ui = torch.randint(-16, 17, shape, device=dev).to(bf16)
        y32 = ks.stencil7(ui.float(), 6.0, -1.0)
        assert torch.equal(ks.stencil7(ui, 6.0, -1.0), y32.to(bf16))
    u = torch.ones(6, 7, 8, dtype=bf16, device=dev)
    u[3, 0, 5] = float("nan")
    yk, yp = ks.stencil7(u, 4.25, -0.5), ks._stencil7_plain(u, 4.25, -0.5)
    assert torch.equal(torch.isnan(yk), torch.isnan(yp)) and int(torch.isnan(yk).sum()) == 6
    assert torch.equal(yk.nan_to_num(), yp.nan_to_num())


# ---- the row-sharded loop: kernels 6 and 17, partials-only modes ----------------

def _shard_operands(dev, nrb, bn, n_shards, shard, seed):
    """One shard's tiles (GLOBAL column blocks over n_shards * nrb block
    rows) and the gathered operand, as the sharded loop hands them over."""
    rng = np.random.default_rng(seed)
    ncb = n_shards * nrb
    blocks = torch.as_tensor(rng.standard_normal((nrb, 3, bn, bn)), dtype=torch.float32,
                             device=dev)
    cols = torch.as_tensor(rng.integers(0, ncb, (nrb, 3)), dtype=torch.int32, device=dev)
    full = torch.as_tensor(rng.standard_normal((ncb, bn)), dtype=torch.float32, device=dev)
    return blocks, cols, full, shard * nrb * bn


@pytest.mark.cuda
@pytest.mark.parametrize("bn,row_group", [(32, None), (64, 3), (128, 1)])
def test_bell_spmv_dot_kernel_matches_plain(dev, bn, row_group):
    """Kernel 6: q to 1e-5 of max|q| and pap to 1e-5 relative of the plain
    version (f32 sums in another order), two launches bit-identical, a
    ragged nrb = 13 at a shard offset that is not 0; its bf16 form too."""
    blocks, cols, full, off = _shard_operands(dev, 13, bn, 3, 1, bn)
    before = fc.LAUNCHES["bell_spmv_dot"]
    qk, pk = fc.bell_spmv_dot(blocks, cols, full, off, row_group=row_group)
    qk2, pk2 = fc.bell_spmv_dot(blocks, cols, full, off, row_group=row_group)
    assert fc.LAUNCHES["bell_spmv_dot"] == before + 2
    qp, pp = fc._spmv_dot_plain(blocks, cols, full, off, None, None)
    torch.cuda.synchronize()
    _close(qk, qp)
    np.testing.assert_allclose(float(pk), float(pp), rtol=RTOL)
    assert torch.equal(qk, qk2) and torch.equal(pk, pk2)
    # bf16 tiles: kernel 6's bf16 form, bit-equal to the float32 launch on
    # the widened tiles, and held to its plain version as the float32 form
    lo = blocks.bfloat16()
    before = fc.LAUNCHES["bell_spmv_dot_bf16"]
    qb, pb = fc.bell_spmv_dot(lo, cols, full, off, row_group=row_group)
    assert fc.LAUNCHES["bell_spmv_dot_bf16"] == before + 1
    q32, p32 = fc.bell_spmv_dot(lo.float(), cols, full, off, row_group=row_group)
    qpb, ppb = fc._spmv_dot_plain(lo, cols, full, off, None, None)
    torch.cuda.synchronize()
    assert torch.equal(qb, q32) and torch.equal(pb, p32)
    _close(qb, qpb)
    np.testing.assert_allclose(float(pb), float(ppb), rtol=RTOL)
    with pytest.raises(ValueError, match="alias"):
        fc.bell_spmv_dot(blocks, cols, full, off, out=(full[:13], pk))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [32, 64, 128])
@pytest.mark.parametrize("case", ["pending", "first", "jacobi"])
def test_minres_shard_kernel_matches_plain(dev, bn, case):
    """Kernel 17: w and x' bit-equal to the plain version (also written
    over w-2 and x), q to 1e-5 of max|q|, the dots v·q and v·r1 each to
    1e-5 of ||v|| ||q|| and ||v|| ||r1|| (a dot can cancel below its
    terms), two launches bit-identical; with a shift, with su = 0 (a first
    step: w = 0, x unchanged) and with a v scaled as Jacobi scales it, by
    factors drawn from a generator seeded with bn."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    nrb = 13
    blocks, cols, full, off = _shard_operands(dev, nrb, bn, 2, 1, bn + 1)
    rng = np.random.default_rng(bn)
    r1, vprev, wm1, wm2, x = (torch.as_tensor(rng.standard_normal((nrb, bn)),
                                              dtype=torch.float32, device=dev)
                              for _ in range(5))
    if case == "jacobi":
        gen = torch.Generator(device=dev)
        gen.manual_seed(bn)
        scale = torch.rand(full.shape, generator=gen, dtype=full.dtype, device=dev)
        full = full * (scale + 0.5) * 0.31
    su = torch.zeros(1, 8, device=dev)
    su[0, fm.SU_SHIFT] = 0.07
    if case != "first":
        su[0, fm.SU_OLDEPS:fm.SU_PHI + 1] = torch.tensor([0.11, 0.23, 0.57, 0.83])
    args = (blocks, cols, full, r1, vprev, wm1, wm2, x, su, off)
    k = fm.minres_shard_spmv_dot(*args)
    k2 = fm.minres_shard_spmv_dot(*args)
    p = fm._shard_plain(blocks, cols, full, (r1, vprev, wm1, wm2, x), su, off, None, None)
    torch.cuda.synchronize()
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    assert all(torch.equal(a, b) for a, b in zip(k, k2))
    _close(k[0], p[0])
    v_norm = float(full[off // bn:off // bn + nrb].norm())
    np.testing.assert_allclose(float(k[3]), float(p[3]), rtol=0,
                               atol=RTOL * v_norm * float(p[0].norm()))
    np.testing.assert_allclose(float(k[4]), float(p[4]), rtol=0,
                               atol=RTOL * v_norm * float(r1.norm()))
    if case == "first":
        assert not k[1].any() and torch.equal(k[2], x)
    w_in, x_in = wm2.clone(), x.clone()
    dots = torch.empty(2, device=dev)
    q = torch.empty_like(r1)
    k3 = fm.minres_shard_spmv_dot(blocks, cols, full, r1, vprev, wm1, w_in, x_in, su, off,
                                  out=(q, w_in, x_in, dots))
    torch.cuda.synchronize()
    assert torch.equal(k3[1], p[1]) and torch.equal(k3[2], p[2])
    for bad, what in (((q, r1, x_in, dots), "w_new"), ((q, w_in, r1, dots), "x_new"),
                      ((full[:nrb], w_in, x_in, dots), "q")):
        with pytest.raises(ValueError, match=f"{what} must not alias"):
            fm.minres_shard_spmv_dot(blocks, cols, full, r1, vprev, wm1, w_in, x_in, su, off,
                                     out=bad)
    # bf16 tiles: kernel 17's bf16 form, bit-equal to the float32 launch on
    # the widened tiles, and w, x' to the plain version
    lo = blocks.bfloat16()
    before = fc.LAUNCHES["minres_shard_spmv_dot_bf16"]
    kb16 = fm.minres_shard_spmv_dot(lo, *args[1:])
    assert fc.LAUNCHES["minres_shard_spmv_dot_bf16"] == before + 1
    k32 = fm.minres_shard_spmv_dot(lo.float(), *args[1:])
    pb = fm._shard_plain(lo, cols, full, (r1, vprev, wm1, wm2, x), su, off, None, None)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kb16, k32))
    assert torch.equal(kb16[1], pb[1]) and torch.equal(kb16[2], pb[2])
    _close(kb16[0], pb[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13 * 32, 2048 * 128])
def test_partials_only_updates_match_full_tail(dev, n):
    """Kernels 2, 3 and 16 in partials-only mode: x', r' and r2' bit-equal
    to their full-tail launches, the same partial sums, and the solve's
    scalars and control words untouched; a no-op on a solve that is
    done."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    g = torch.Generator(device="cpu").manual_seed(n)
    x, p, r, q, d = (torch.randn(n, generator=g).to(dev) for _ in range(5))
    d = d.abs() + 0.5
    alpha = torch.full((1, 1), 0.61, device=dev)
    for name, kern in (("fused_update_dot", lambda **kw: fc.fused_update_dot(x, p, r, q, alpha, **kw)),
                       ("fused_update_dot_pcg",
                        lambda **kw: fc.fused_update_dot_pcg(x, p, r, q, d, alpha, **kw))):
        full = kern(work=fc.FusedWork.new(dev, maxiter=4))
        work = fc.FusedWork.new(dev, maxiter=4)
        scal, ctl = work.scal.clone(), work.ctl.clone()
        part = kern(work=work, partials_only=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(full, part)), name
        assert torch.equal(work.scal, scal) and torch.equal(work.ctl, ctl), name
        work.ctl[fc.C_LIVE] = 0
        xo, ro = torch.zeros_like(x), torch.zeros_like(r)
        kern(work=work, partials_only=True, out=(xo, ro))
        torch.cuda.synchronize()
        assert not xo.any() and not ro.any(), name
    c1, ia = torch.full((1, 1), 0.4, device=dev), torch.full((1, 1), 0.9, device=dev)
    for dd in (None, d):
        wf = fm.MinresWork.new(dev, maxiter=4)
        wf.start(torch.tensor(2.3, device=dev))
        wp = fm.MinresWork.new(dev, maxiter=4)
        wp.start(torch.tensor(2.3, device=dev))
        scal, ctl = wp.scal.clone(), wp.ctl.clone()
        yf, bf = fm.minres_update_dot(q, r, p, c1, ia, dd, work=wf)
        yp, bp = fm.minres_update_dot(q, r, p, c1, ia, dd, work=wp, partials_only=True)
        torch.cuda.synchronize()
        assert torch.equal(yf, yp) and torch.equal(bf, bp)
        assert torch.equal(wp.scal, scal) and torch.equal(wp.ctl, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["standard", "minres"])
def test_sharded_fused_solve_takes_the_kernels_bitwise(dev, method):
    """The fused sharded loop on the card, four shards in one process: P
    launches of each kernel a step (plus one per shard for r0) and no plain
    version, twice bit for bit, and its history against the plain versions
    on the CPU (5e-3 over 12 steps, above the float32 floor).  The
    diagonal tiles are cut to 2.5 times the coupling tile's spectral radius
    (condition number ~9), so the history stays above that floor."""
    from conjugategradient_tpu_torch.parallel import make_row_mesh, sharded_cg_solve

    n_shards, bn, nrb = 4, 128, 2
    n = n_shards * nrb * bn
    blocks, cols, _ = block_tridiag_tiles(n, bn, bn, seed=5)
    rho_off = float(np.abs(np.linalg.eigvalsh(blocks[1, 1].astype(np.float64))).max())
    blocks[:, 0] = np.eye(bn, dtype=np.float32) * np.float32(2.5 * rho_off)
    blocks = torch.from_numpy(blocks).reshape(n_shards, nrb, 3, bn, bn).to(dev)
    cols = torch.from_numpy(cols).reshape(n_shards, nrb, 3).to(dev)
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    kernel = "bell_spmv_dot" if method == "standard" else "minres_shard_spmv_dot"
    fc.reset_counts()
    x1, i1 = sharded_cg_solve(blocks, cols, b, mesh=make_row_mesh(n_shards, dev), tol=-1.0,
                              maxiter=12, method=method)
    assert int(i1.iterations) == 12
    assert fc.LAUNCHES[kernel] == n_shards * 13
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    x2, i2 = sharded_cg_solve(blocks, cols, b, mesh=make_row_mesh(n_shards, dev), tol=-1.0,
                              maxiter=12, method=method)
    assert torch.equal(x1, x2)
    assert torch.equal(i1.rho_history.view(torch.int32), i2.rho_history.view(torch.int32))
    xc, ic = sharded_cg_solve(blocks.cpu(), cols.cpu(), b.cpu(),
                              mesh=make_row_mesh(n_shards, "cpu"), tol=-1.0, maxiter=12,
                              method=method, use_fused="always")
    hk, hc = i1.rho_history.cpu().numpy(), ic.rho_history.numpy()
    keep = hc > 1e-10 * hc[0]
    assert keep.sum() >= 3
    np.testing.assert_allclose(hk[keep], hc[keep], rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["standard", "minres"])
def test_sharded_fused_bf16_solve_takes_the_bf16_kernels(dev, method):
    """The fused sharded loop on bf16 shards, four shards in one process:
    P launches a step of the shard kernel's bf16 form (kernel 6 or 17, plus
    one per shard for r0), no plain version, and the whole solve bit-equal
    to the one on the widened shards; a NaN tile value stops it at once
    with a NaN residual."""
    from conjugategradient_tpu_torch.parallel import make_row_mesh, sharded_cg_solve

    n_shards, bn, nrb = 4, 128, 2
    n = n_shards * nrb * bn
    blocks, cols, _ = block_tridiag_tiles(n, bn, bn, seed=5)
    rho_off = float(np.abs(np.linalg.eigvalsh(blocks[1, 1].astype(np.float64))).max())
    blocks[:, 0] = np.eye(bn, dtype=np.float32) * np.float32(2.5 * rho_off)
    lo = torch.from_numpy(blocks).reshape(n_shards, nrb, 3, bn, bn).to(dev).bfloat16()
    cols = torch.from_numpy(cols).reshape(n_shards, nrb, 3).to(dev)
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    kernel = ("bell_spmv_dot" if method == "standard" else "minres_shard_spmv_dot") + "_bf16"
    mesh = make_row_mesh(n_shards, dev)
    fc.reset_counts()
    x1, i1 = sharded_cg_solve(lo, cols, b, mesh=mesh, tol=-1.0, maxiter=12, method=method)
    assert int(i1.iterations) == 12
    assert fc.LAUNCHES[kernel] == n_shards * 13
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    x2, i2 = sharded_cg_solve(lo.float(), cols, b, mesh=mesh, tol=-1.0, maxiter=12,
                              method=method)
    assert torch.equal(x1, x2)
    assert torch.equal(i1.rho_history.view(torch.int32), i2.rho_history.view(torch.int32))
    bad = lo.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    _, i3 = sharded_cg_solve(bad, cols, b, mesh=mesh, tol=-1.0, maxiter=12, method=method)
    assert not bool(i3.converged) and int(i3.iterations) <= 1


# ---- kernels 4 and 5 on the packed nonzeros of sparse tiles ---------------------

def _sparse_csr(rng, n, ncols, per_row, spd):
    """Random sparse host CSR with ~per_row scattered nonzeros a row: the
    pattern that leaves blocked-ELL tiles mostly empty.  ``spd``: square,
    symmetric, diagonally dominant."""
    A = np.zeros((n, ncols), np.float32)
    for i in range(n):
        js = rng.choice(ncols, size=per_row, replace=False)
        A[i, js] = rng.standard_normal(per_row)
    if spd:
        A = A + A.T
        A[np.arange(n), np.arange(n)] = np.abs(A).sum(axis=1) + 1
    rows, cols = np.nonzero(A)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return A[rows, cols], cols, indptr, A.shape


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn", [(8, 8), (32, 32), (8, 128), (128, 128), (32, 8)])
def test_bell_spmv_packed_kernel_bit_equal_to_plain(dev, bm, bn):
    """Kernel 5 on the packed view: bit-equal to its plain version (one
    rounding per product and per sum, in the same order), bit-identical on
    a repeat, within RTOL of the dense tiles' plain product; any tile
    shape, a ragged last block-row and a rectangular operand."""
    from conjugategradient_tpu_torch.ops.spmv import bell_apply, bell_packed_route

    rng = np.random.default_rng(bm * 1000 + bn)
    n = (5 if bm == 128 else 13) * bm - 3
    a = BlockedEllMatrix.from_csr_host(*_sparse_csr(rng, n, n + 37, 4, spd=False),
                                       bm=bm, bn=bn, device=dev)
    assert bell_packed_route(a)
    fc.reset_counts()
    pk = a.packed()
    x = torch.randn(pk.ncols, device=dev)
    y = kb.bell_spmv_packed(pk, x)
    y2 = kb.bell_spmv_packed(pk, x)
    assert fc.LAUNCHES["bell_spmv_packed"] == 2 and fc.LAUNCHES["bell_pack"] == 1
    yp = kb.packed_apply(pk, x)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(y, yp)
    _close(y, bell_apply(a.blocks, a.block_cols, x.view(-1, bn)).reshape(-1))
    # the operator's matvec takes the packed kernel (bn = 8 included: the
    # dense kernel takes bn in CUDA_BN only)
    _close(a.matvec(x[:a.shape[1]]), yp[:n])
    assert fc.LAUNCHES["bell_spmv_packed"] == 3 and fc.LAUNCHES["bell_spmv"] == 0
    assert fc.LAUNCHES["bell_pack"] == 1 and fc.PLAIN_ON_CUDA["bell_spmv_packed"] == 1
    with pytest.raises(ValueError, match="x must be"):
        kb.bell_spmv_packed(pk, x[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [8, 32, 128])
def test_full_dir_packed_kernel_bit_equal_to_plain(dev, bn):
    """Kernel 4 on the packed view, ± Jacobi d, β = 0 and β ≠ 0: p_new and q
    bit-equal to the plain version, pap within RTOL, repeats bit-identical."""
    rng = np.random.default_rng(bn)
    nrb = 5 if bn == 128 else 13
    n = nrb * bn - 3
    a = BlockedEllMatrix.from_csr_host(*_sparse_csr(rng, n, n, 3, spd=True), bm=bn, bn=bn,
                                       device=dev)
    pk = a.packed()
    r, p = torch.randn(nrb, bn, device=dev), torch.randn(nrb, bn, device=dev)
    d = torch.rand(nrb, bn, device=dev) + 0.5
    for beta_v in (0.0, 0.37):
        beta = torch.full((1, 1), beta_v, device=dev)
        for dd in (None, d):
            before = fc.LAUNCHES["fused_dir_spmv_dot_packed"]
            k = fc.fused_dir_spmv_dot_packed(pk, r, p, beta, dd)
            k2 = fc.fused_dir_spmv_dot_packed(pk, r, p, beta, dd)
            assert fc.LAUNCHES["fused_dir_spmv_dot_packed"] == before + 2
            pl = fc._packed_dir_plain(pk, r, p, beta, dd, None, None)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(k, k2))
            assert torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1])
            np.testing.assert_allclose(float(k[2]), float(pl[2]), rtol=RTOL)
    with pytest.raises(ValueError, match="alias"):
        fc.fused_dir_spmv_dot_packed(pk, r, p, beta, out=(p, torch.empty_like(p)))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [8, 32])
def test_fused_solve_routes_by_tile_fill(dev, bn):
    """A sparse-tile float32 operator: the fused CG and PCG read the packed
    view (built once for the whole solve, again after an in-place change of
    the tiles), bitwise repeatable, against the plain versions on the CPU;
    a dense-tile operator keeps the dense kernels."""
    from conjugategradient_tpu_torch import fused_bell_cg_solve, fused_bell_pcg_solve

    rng = np.random.default_rng(3)
    n = 13 * bn - 3
    a = BlockedEllMatrix.from_csr_host(*_sparse_csr(rng, n, n, 3, spd=True), bm=bn, bn=bn,
                                       device=dev)
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    inv = 1.0 / a.diagonal()
    for solve, extra in ((fused_bell_cg_solve, ()), (fused_bell_pcg_solve, (inv,))):
        fc.reset_counts()
        _, ik = solve(a, b, *extra, tol=0.0, maxiter=20)
        assert fc.LAUNCHES["fused_dir_spmv_dot_packed"] == 20
        assert fc.LAUNCHES["fused_dir_spmv_dot"] == 0 and fc.LAUNCHES["bell_pack"] <= 1
        _, ik2 = solve(a, b, *extra, tol=0.0, maxiter=20)
        assert torch.equal(ik.rho_history.view(torch.int32), ik2.rho_history.view(torch.int32))
        _, ip = solve(a.to("cpu"), b.cpu(), *(e.cpu() for e in extra), tol=0.0, maxiter=20)
        hk, hp = ik.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        keep = hp > 1e-10 * hp[0]
        np.testing.assert_allclose(hk[keep], hp[keep], rtol=2e-3)
        assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    before = fc.LAUNCHES["bell_pack"]
    a.blocks.mul_(2.0)
    fused_bell_cg_solve(a, b, tol=0.0, maxiter=2)
    assert fc.LAUNCHES["bell_pack"] == before + 1
    if bn in (32, 64, 128, 256):
        blocks, bcols, nnz = block_tridiag_tiles(13 * bn, bn, bn, seed=2)
        t = BlockedEllMatrix(torch.from_numpy(blocks).to(dev), torch.from_numpy(bcols).to(dev),
                             (13 * bn, 13 * bn), nnz)
        fc.reset_counts()
        x, _ = fused_bell_cg_solve(t, b.new_ones(13 * bn), tol=0.0, maxiter=5)
        t.matvec(x)
        assert fc.LAUNCHES["fused_dir_spmv_dot"] == 5 and fc.LAUNCHES["bell_spmv"] == 1
        assert fc.LAUNCHES["fused_dir_spmv_dot_packed"] == fc.LAUNCHES["bell_pack"] == 0


# ---- kernels 14 and 15 on the packed nonzeros of sparse tiles -------------------

def _poisson_ops(nx, bn, dev):
    """The 5-point 2-D Poisson operator on an nx x nx grid as float32
    blocked-ELL with bn x bn tiles, in full and symmetric storage: sparse
    tiles."""
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    rows, cols, vals, shape = poisson2d_coo(nx)
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=shape[0]))])
    full = BlockedEllMatrix.from_csr_host(vals[order].astype(np.float32), cols[order], indptr,
                                          shape, bm=bn, bn=bn, device=dev)
    return full, SymBellMatrix.from_bell(full)


def _same_bits(a, b):
    """Equal, NaN where the other is NaN (a NaN's payload aside)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["full", "sym"])
@pytest.mark.parametrize("nx,bn", [(64, 128), (37, 32)], ids=["poisson64", "ragged37-bn32"])
def test_minres_packed_kernel_bit_equal_to_plain(dev, nx, bn, storage):
    """Kernel 14 (full storage's view) and kernel 15 (symmetric storage's
    D + U + Uᵀ) on the packed kernel, ± Jacobi d, shift 0 and not 0, a first
    step and a pending one, NaN scalars: v, q, w and x' bit-equal to the
    plain version, the dots to RTOL, the last CTA's scalar step 0 ulps from
    torch's on the kernel's own dots, repeats bit-identical, in place as
    the solver launches it; a no-op once not live."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    full, sym = _poisson_ops(nx, bn, dev)
    a = full if storage == "full" else sym
    assert bell_packed_route(a)
    name = "minres_dir_spmv_dot_packed" if storage == "full" else "sym_minres_dir_spmv_dot_packed"
    pk = a.packed()
    assert pk.symmetric == (storage == "sym")
    nrb = pk.rows // bn
    d = torch.ones(pk.rows, device=dev)
    d[:a.n] = 1.0 / a.diagonal()
    cases = [(dd, shift, first) for dd in (None, d.view(nrb, bn)) for shift in (0.0, 0.07)
             for first in (False, True)]
    for dd, shift, first in cases + [(None, float("nan"), False)]:
        vecs, su, _ = _minres_operands(a, dev, nx, False, first)
        su[0, fm.SU_SHIFT] = shift
        if math.isnan(shift):  # NaN 1/beta and phi: every output NaN where the plain's is
            su[0, fm.SU_INV_BETA] = su[0, fm.SU_PHI] = float("nan")
        fc.reset_counts()
        wk, wp = fm.MinresWork.new(dev, maxiter=4), fm.MinresWork.new(dev, maxiter=4)
        for w in (wk, wp):
            w.scal[fm.M_OLDB] = 1.7
            w.start(torch.tensor(2.3, device=dev))
        k = fm.minres_dir_spmv_dot_packed(pk, *vecs, su, dd, work=wk)
        k2 = fm.minres_dir_spmv_dot_packed(pk, *vecs, su, dd)
        pl = fm._dir_plain(name, kb.packed_product(pk), vecs, su, dd, None, None)
        torch.cuda.synchronize()
        assert fc.LAUNCHES[name] == 2 and sum(fc.LAUNCHES.values()) == 2
        for i in range(4):
            assert _same_bits(k[i], pl[i]), ("v", "q", "w", "x")[i]
            assert _same_bits(k[i], k2[i])
        if math.isnan(shift):
            assert torch.isnan(k[0]).all() and math.isnan(float(k[4]))
            continue
        for i in (4, 5):
            np.testing.assert_allclose(float(k[i]), float(pl[i]), rtol=RTOL,
                                       atol=RTOL * float(pl[0].norm() * vecs[1].norm()))
        assert torch.equal(k[4], k2[4]) and torch.equal(k[5], k2[5])
        if first:
            assert torch.equal(k[3], vecs[5]) and not k[2].any()  # x kept, w = 0
        fm.finish_dir(wp, k[4][0, 0], k[5][0, 0])
        assert torch.equal(wk.scal[:fm.M_VQ].view(torch.int32), wp.scal[:fm.M_VQ].view(torch.int32))
    # in place, as the solver launches it: v over v_prev, w over w-2, x over x
    r2, r1, vprev, wm1, wm2, x = (v.clone() for v in vecs)
    kin = fm.minres_dir_spmv_dot_packed(pk, r2, r1, vprev, wm1, wm2, x, su, dd,
                                        out=(vprev, torch.empty_like(r2), wm2, x))
    torch.cuda.synchronize()
    assert all(_same_bits(u, v) for u, v in zip(kin[:4], pl[:4]))
    assert torch.equal(r2, vecs[0]) and torch.equal(r1, vecs[1]) and torch.equal(wm1, vecs[3])
    # not live: nothing is written
    vecs, su, _ = _minres_operands(a, dev, 1, False)
    wk.ctl[fc.C_LIVE] = 0
    out = tuple(torch.full_like(vecs[0], 7.0) for _ in range(4))
    kept = wk.scal.clone()
    fm.minres_dir_spmv_dot_packed(pk, *vecs, su, out=out, work=wk)
    torch.cuda.synchronize()
    assert all(bool((o == 7.0).all()) for o in out)
    assert torch.equal(wk.scal.view(torch.int32), kept.view(torch.int32))  # NaN slots too
    with pytest.raises(ValueError, match="alias"):
        fm.minres_dir_spmv_dot_packed(pk, *vecs, su,
                                      out=(vecs[0], *(torch.empty_like(vecs[0]) for _ in range(3))))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["full", "sym"])
def test_fused_minres_solve_takes_the_packed_kernel(dev, storage):
    """``minres_solve`` on a sparse-tile operator (2-D Poisson nx = 64 at
    128 x 128) in either storage: the packed kernel and kernel 16 once a
    step, no tile kernel and no plain version on CUDA, the view built once,
    bitwise repeatable; its history against the same solve's plain versions
    on the CPU to 2e-3 over 24 steps, plain, shifted and with Jacobi."""
    from conjugategradient_tpu_torch import fused_minres_solve, jacobi_preconditioner, minres_solve

    full, sym = _poisson_ops(64, 128, dev)
    a = full if storage == "full" else sym
    name = "minres_dir_spmv_dot_packed" if storage == "full" else "sym_minres_dir_spmv_dot_packed"
    b = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
    ac = a.to("cpu")
    for shift, M in ((0.0, None), (0.5, None), (0.0, jacobi_preconditioner(a))):
        inv = None if M is None else M.inv_diag
        a.packed()
        fc.reset_counts()
        xk, ik = minres_solve(a, b, tol=0.0, maxiter=24, shift=shift, M=M)
        assert fc.LAUNCHES[name] == fc.LAUNCHES["minres_update_dot"] == 24
        assert fc.LAUNCHES["minres_dir_spmv_dot"] == fc.LAUNCHES["sym_minres_dir_spmv_dot"] == 0
        assert fc.LAUNCHES["bell_pack"] == 0  # built once, before the counts were reset
        xk2, ik2 = fused_minres_solve(a, b, tol=0.0, maxiter=24, shift=shift, inv_diag=inv)
        assert torch.equal(xk, xk2)
        assert torch.equal(ik.rnorm_history.view(torch.int32), ik2.rnorm_history.view(torch.int32))
        assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
        _, ip = fused_minres_solve(ac, b.cpu(), tol=0.0, maxiter=24, shift=shift,
                                   inv_diag=None if inv is None else inv.cpu())
        hk, hp = ik.rnorm_history.double().cpu().numpy(), ip.rnorm_history.double().numpy()
        np.testing.assert_allclose(hk, hp, rtol=2e-3, atol=1e-6 * hp[0])


# ---- kernel 1 on the packed nonzeros of sparse symmetric tiles ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("nx,bn", [(64, 128), (37, 32)], ids=["poisson64", "ragged37-bn32"])
def test_sym_dir_packed_kernel_bit_equal_to_plain(dev, nx, bn):
    """The packed kernel 4 on symmetric storage's view of D + U + Uᵀ
    (kernel 1's function), ± Jacobi d, β = 0 and β ≠ 0: p_new and q
    bit-equal to the plain version, pap within RTOL, repeats bit-identical,
    counted as ``sym_fused_dir_spmv_dot_packed``; q within RTOL of the tiles'
    general landing."""
    _, sym = _poisson_ops(nx, bn, dev)
    pk = sym.packed()
    assert pk.symmetric
    nrb = sym.nrb
    r, p = torch.randn(nrb, bn, device=dev), torch.randn(nrb, bn, device=dev)
    d = torch.rand(nrb, bn, device=dev) + 0.5
    for beta_v in (0.0, 0.37):
        beta = torch.full((1, 1), beta_v, device=dev)
        for dd in (None, d):
            fc.reset_counts()
            k = fc.fused_dir_spmv_dot_packed(pk, r, p, beta, dd)
            k2 = fc.fused_dir_spmv_dot_packed(pk, r, p, beta, dd)
            assert fc.LAUNCHES["sym_fused_dir_spmv_dot_packed"] == 2
            assert fc.LAUNCHES["fused_dir_spmv_dot_packed"] == 0
            pl = fc._packed_dir_plain(pk, r, p, beta, dd, None, None)
            tiles = fc._sym_dir_plain(sym.diag_blocks, sym.off_blocks, sym.off_cols, r, p, beta,
                                      dd, sym.mirror_src, None, None)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(k, k2))
            assert torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1])
            np.testing.assert_allclose(float(k[2]), float(pl[2]), rtol=RTOL)
            q_t = tiles[1].cpu().numpy()
            np.testing.assert_allclose(k[1].cpu().numpy(), q_t, rtol=0,
                                       atol=RTOL * np.abs(q_t).max())


@pytest.mark.cuda
def test_fused_cg_symbell_takes_the_packed_kernel(dev):
    """Fused CG and Jacobi PCG on a sparse-tile symmetric operator (2-D
    Poisson nx = 64 at 128 x 128): packed kernel 1 once a step, no launch
    of the general landing, the view built once, an x0 residual and the
    SpMV through packed kernel 5; bitwise repeatable; the history against
    the same solve's plain versions on the CPU to 2e-3."""
    from conjugategradient_tpu_torch import fused_bell_cg_solve, fused_bell_pcg_solve

    _, a = _poisson_ops(64, 128, dev)
    b = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
    x0 = torch.full_like(b, 0.01)
    inv = 1.0 / a.diagonal()
    a.packed()
    for solve, extra in ((fused_bell_cg_solve, ()), (fused_bell_pcg_solve, (inv,))):
        fc.reset_counts()
        xk, ik = solve(a, b, *extra, x0, tol=0.0, maxiter=20)
        a.matvec(xk)
        assert fc.LAUNCHES["sym_fused_dir_spmv_dot_packed"] == 20
        assert fc.LAUNCHES["sym_fused_dir_spmv_dot"] == fc.LAUNCHES["bell_pack"] == 0
        assert fc.LAUNCHES["bell_spmv_packed"] == 2  # r0 = b - A x0, then the matvec
        assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
        _, ik2 = solve(a, b, *extra, x0, tol=0.0, maxiter=20)
        assert torch.equal(ik.rho_history.view(torch.int32), ik2.rho_history.view(torch.int32))
        _, ip = solve(a.to("cpu"), b.cpu(), *(e.cpu() for e in extra), x0.cpu(), tol=0.0,
                      maxiter=20)
        hk, hp = ik.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        keep = hp > 1e-10 * hp[0]
        np.testing.assert_allclose(hk[keep], hp[keep], rtol=2e-3)


# ---- kernel 10, tiled -------------------------------------------------------------

SYM_DIA_CASES = [
    ("pitch 1024, n % 4 = 1", tuple(k * 1024 for k in range(21)), 1024 * 400 + 5),
    ("pitch 256", tuple(k * 256 for k in range(6)), 256 * 1100),
    ("contiguous rows", (0, 1, 40), 32 * 64 * 140),
    ("poisson3d-like, small", (0, 1, 12, 144), 1728 * 9 + 3),
    ("0,3,300", (0, 3, 300), 1001),
    ("offsets past n", (0, 5, 2000), 1000),
    ("one diagonal", (0,), 777),
    ("no tiling fits", (0, 1, 20000), 40000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,offsets,n", SYM_DIA_CASES, ids=[c[0] for c in SYM_DIA_CASES])
def test_sym_dia_tiled_kernel_bit_equal_to_plain(dev, label, offsets, n):
    """The symmetric DIA product, routed by shape (the tiled kernel where
    its geometry exists and pays, else the by-value kernel up to 32 stored
    offsets, else sym_dia_spmv): bit-equal to the plain version (x with a
    NaN; and x = 0 on negative diagonals, where every term is -0), repeats
    bit-identical, the launch counted under the route's name; each kernel
    forced on the same operands (the tiled one wherever its geometry exists,
    at each tile height and at ring depths 2, 3, 4 and 8; the by-value one
    up to 32 offsets) gives the same bits, in float32 and on bf16
    diagonals, where a bf16 launch gives the float32 launch's bits on the
    widened diagonals."""
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    rng = np.random.default_rng(n)
    diags = rng.standard_normal((len(offsets), n)).astype(np.float32)
    d = torch.from_numpy(diags).to(dev)
    od = torch.tensor(offsets, dtype=torch.int32, device=dev)
    x = torch.randn(n, device=dev)
    x[n // 2] = float("nan")
    tiling = kd.sym_dia_tiling(offsets, n)
    tiled = tiling is not None and tiling.pays(n)
    assert tiled == (label in ("pitch 1024, n % 4 = 1", "pitch 256", "contiguous rows"))
    name = kd.sym_dia_route(offsets, n)
    assert name == ("sym_dia_spmv_tiled" if tiled else "sym_dia_spmv_rows")
    fc.reset_counts()
    yk = kd.sym_dia_spmv_diags(d, offsets, od, x)
    yk2 = kd.sym_dia_spmv_diags(d, offsets, od, x)
    assert fc.LAUNCHES[name] == 2
    yp = kd._sym_dia_plain(d, offsets, x)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(yk), bits(yk2))
    assert torch.equal(bits(yk), bits(yp)), label
    # bf16 diagonals take the route judged at bf16's 128-plane tiles: the
    # three shapes that tile in float32 (140-224 CTAs) give bf16 half the
    # grid, under MIN_TILE_CTAS, and go by value (the forced launches below
    # hold the tiled bf16 form)
    lo = d.bfloat16()
    name16 = kd.sym_dia_route(offsets, n, lo.dtype)
    assert name16 == "sym_dia_spmv_rows", label
    yb = kd.sym_dia_spmv_diags(lo, offsets, od, x)
    assert fc.LAUNCHES[name16 + "_bf16"] == 1
    torch.cuda.synchronize()
    assert torch.equal(bits(yb), bits(kd._sym_dia_plain(lo, offsets, x))), label
    forced = [("sym_dia_spmv", None, None), ("sym_dia_spmv_rows", None, None)]
    if tiling is not None:
        forced += [("sym_dia_spmv_tiled", dataclasses.replace(tiling, planes=m), s)
                   for m in kd.TILE_PLANE_CHOICES for s in (2, 3, 4, kd.MAX_TILE_STAGES)]
    for lo in (d, d.bfloat16()):
        ypl = kd._sym_dia_plain(lo, offsets, x)
        for route, t, stages in forced:
            yf = kd.sym_dia_cuda(lo, offsets, od, x, route, t, stages)
            yw = kd.sym_dia_cuda(lo.float(), offsets, od, x, route, t, stages)
            torch.cuda.synchronize()
            what = (label, lo.dtype, route, t, stages)
            assert torch.equal(bits(yf), bits(ypl)) and torch.equal(bits(yf), bits(yw)), what
    z = torch.zeros(n, device=dev)
    dneg = -d.abs()
    assert torch.equal(kd.sym_dia_spmv_diags(dneg, offsets, od, z).view(torch.int32),
                       kd._sym_dia_plain(dneg, offsets, z).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 1001, 110_592, 110_591])
def test_sym_dia_rows_kernel_bit_equal_to_plain(dev, n):
    """Kernel 10's by-value kernel in float32 and bf16, bit for bit against
    the plain version and against one thread a row: offsets that are and are
    not multiples of the 16-byte unit (4 floats, 8 bf16) and one at or past
    n, a NaN in x (reaching rows c - k and c + k only), the diagonals or x a
    view at offset 1 (not 16-byte aligned), a ragged n, x = 0 on negative
    diagonals (-0 terms); a repeat gives the same bits, and a bf16 launch
    the float32 launch's bits on the widened diagonals."""
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    g = torch.Generator().manual_seed(n + 5)
    offsets = (0, 1, 4, 5, 8, 48, 300, n, n + 2)
    od = torch.tensor(offsets, dtype=torch.int32, device=dev)
    flat = torch.randn(len(offsets) * n + 1, generator=g).to(dev)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    xb = torch.randn(n + 1, generator=g).to(dev)
    c = n // 2
    for shift in (0, 1):
        for lo in (flat, flat.bfloat16()):
            d = lo[shift:shift + len(offsets) * n].view(len(offsets), n)
            for xs in (0, 1):
                x = xb[xs:xs + n].clone() if xs == 0 else xb[xs:xs + n]
                x[c] = float("nan")
                before = fc.LAUNCHES[_form("sym_dia_spmv_rows", d.dtype)]
                y = kd.sym_dia_cuda(d, offsets, od, x, "sym_dia_spmv_rows")
                y2 = kd.sym_dia_cuda(d, offsets, od, x, "sym_dia_spmv_rows")
                launched = fc.LAUNCHES[_form("sym_dia_spmv_rows", d.dtype)] - before
                yo = kd.sym_dia_cuda(d, offsets, od, x, "sym_dia_spmv")
                yw = kd.sym_dia_cuda(d.float(), offsets, od, x, "sym_dia_spmv_rows")
                yp = kd._sym_dia_plain(d, offsets, x)
                torch.cuda.synchronize()
                what = f"{d.dtype} diags+{shift} x+{xs}"
                assert launched == 2, what
                assert torch.equal(bits(y), bits(yp)) and torch.equal(bits(y), bits(y2)), what
                assert torch.equal(bits(y), bits(yo)) and torch.equal(bits(y), bits(yw)), what
                rows = {r for k in offsets if k < n for r in (c - k, c + k) if 0 <= r < n}
                assert set(torch.isnan(y).nonzero().flatten().tolist()) == rows, what
                xb[c + xs] = 0.5
            z = torch.zeros(n, device=dev)
            dneg = -d.abs()
            assert torch.equal(bits(kd.sym_dia_cuda(dneg, offsets, od, z, "sym_dia_spmv_rows")),
                               bits(kd._sym_dia_plain(dneg, offsets, z)))
    with pytest.raises(ValueError, match="at most"):
        kd.sym_dia_cuda(torch.zeros(33, n, device=dev), tuple(range(33)),
                        torch.arange(33, dtype=torch.int32, device=dev),
                        torch.zeros(n, device=dev), "sym_dia_spmv_rows")


def _form(name, dtype):
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


# ---- kernels 2, 3 and 16: the update kernels' chain and what it must keep ------------------

def _update_operands(dev, n, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x, p, r, q, d = (torch.randn(n, generator=g).to(dev) for _ in range(5))
    return x, p, r, q, d.abs() + 0.5, torch.full((1, 1), 0.61, device=dev)


def _update_works(dev, maxiter=9, tol=1e-3):
    """A fused CG and a fused MINRES work part-way (every scalar the
    kernels' steps read is not 0)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    w = fc.FusedWork.new(dev, maxiter=maxiter, tol=tol)
    w.scal[fc.S_RNORM], w.scal[fc.S_RHO] = 2.5, 1.5
    m = fm.MinresWork.new(dev, maxiter=maxiter, tol=tol, shift=0.07)
    m.scal[fm.M_OLDB], m.scal[fm.M_DBAR], m.scal[fm.M_EPSLN] = 1.7, 0.4, 0.2
    m.scal[fm.M_CS], m.scal[fm.M_SN], m.scal[fm.M_ALFA] = -0.8, 0.6, 2.2
    m.scal[fm.M_C1], m.scal[fm.M_IA] = 0.4, 0.9
    m.start(torch.tensor(2.3, device=dev))
    return w, m


def _same_bits_all(before, after):
    return all(_same_bits(a, b) for a, b in zip(before, after))


@pytest.mark.cuda
@pytest.mark.parametrize("partials_only", [False, True], ids=["scalar-step", "partials-only"])
@pytest.mark.parametrize("n", [2048 * 128, 256 * 128])
def test_update_kernels_write_nothing_when_not_live(dev, n, partials_only):
    """Kernels 2, 3 and 16 load their first operands before they read
    ctl[C_LIVE]: on a solve that is not live, written in place as the
    loops launch them, nothing changes (x, r, r1, the partials, the
    counter, scal, ctl, hist)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    x, p, r, q, d, alpha = _update_operands(dev, n, 3)
    for dd in (None, d):
        w, m = _update_works(dev)
        for work in (w, m):
            work.ctl[fc.C_LIVE] = 0
            work.partials.fill_(7.0)
        xs, rs = x.clone(), r.clone()
        bufs = (xs, rs, w.partials, w.counter, w.scal, w.ctl, w.hist)
        kept = [t.clone() for t in bufs]
        if dd is None:
            fc.fused_update_dot(xs, p, rs, q, alpha, out=(xs, rs), work=w,
                                partials_only=partials_only)
        else:
            fc.fused_update_dot_pcg(xs, p, rs, q, dd, alpha, out=(xs, rs), work=w,
                                    partials_only=partials_only)
        r1 = r.clone()
        mbufs = (r1, m.partials, m.counter, m.scal, m.ctl, m.hist)
        mkept = [t.clone() for t in mbufs]
        fm.minres_update_dot(q, r1, p, m.c1, m.ia, dd, out=r1, work=m,
                             partials_only=partials_only)
        torch.cuda.synchronize()
        assert _same_bits_all(kept, bufs), "kernel 2/3 wrote on a solve that is not live"
        assert _same_bits_all(mkept, mbufs), "kernel 16 wrote on a solve that is not live"


@pytest.mark.cuda
@pytest.mark.parametrize("partials_only", [False, True], ids=["scalar-step", "partials-only"])
def test_update_kernels_repeat_bit_identical(dev, partials_only):
    """Three launches back to back give the same outputs: the last CTA
    resets the ticket every time."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    x, p, r, q, d, alpha = _update_operands(dev, 2048 * 128, 5)
    w, m = _update_works(dev, maxiter=1 << 10, tol=-1.0)
    runs = []
    for _ in range(3):
        k2 = fc.fused_update_dot(x, p, r, q, alpha, work=w, partials_only=partials_only)
        k3 = fc.fused_update_dot_pcg(x, p, r, q, d, alpha, work=w, partials_only=partials_only)
        k16 = [fm.minres_update_dot(q, r, p, m.c1, m.ia, dd, work=m, partials_only=partials_only)
               for dd in (None, d)]
        runs.append([t.clone() for t in (*k2, *k3, *k16[0], *k16[1])])
    torch.cuda.synchronize()
    assert int(w.counter) == 0 and int(m.counter) == 0
    assert int(w.ctl[fc.C_LIVE]) == 1 and int(m.ctl[fc.C_LIVE]) == 1
    assert _same_bits_all(runs[0], runs[1]) and _same_bits_all(runs[0], runs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("partials_only", [False, True], ids=["scalar-step", "partials-only"])
@pytest.mark.parametrize("n", [210, 4097, 256 * 128, 512 * 128, 2048 * 128])
def test_update_kernels_in_place_match_plain(dev, n, partials_only):
    """Kernels 2, 3 (any length: n % 4 != 0 too) and 16 (n % 4 == 0)
    written in place, as the loops launch them, at n = 262,144, the
    sharded lengths n/8 and n/4 and ragged lengths: x', r' and r2'
    bit-equal to the plain versions, the dots within RTOL."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    x, p, r, q, d, alpha = _update_operands(dev, n, n)
    for dd, name in ((None, "fused_update_dot"), (d, "fused_update_dot_pcg")):
        w, _ = _update_works(dev)
        xs, rs = x.clone(), r.clone()
        if dd is None:
            k = fc.fused_update_dot(xs, p, rs, q, alpha, out=(xs, rs), work=w,
                                    partials_only=partials_only)
        else:
            k = fc.fused_update_dot_pcg(xs, p, rs, q, dd, alpha, out=(xs, rs), work=w,
                                        partials_only=partials_only)
        pl = fc._update_plain(name, x, p, r, q, dd, alpha, None, None)
        torch.cuda.synchronize()
        assert k[0].data_ptr() == xs.data_ptr() and k[1].data_ptr() == rs.data_ptr()
        assert torch.equal(xs, pl[0]) and torch.equal(rs, pl[1]), name
        for g, want in zip(k[2:], pl[2:]):
            np.testing.assert_allclose(float(g), float(want), rtol=RTOL)
    if n % 4:
        return
    for dd in (None, d):
        _, m = _update_works(dev)
        r1 = r.clone()
        y, bsq = fm.minres_update_dot(q, r1, p, m.c1, m.ia, dd, out=r1, work=m,
                                      partials_only=partials_only)
        yp, bp = fm._update_plain(q, r, p, m.c1, m.ia, dd, None, None)
        torch.cuda.synchronize()
        assert y.data_ptr() == r1.data_ptr() and torch.equal(y, yp)
        np.testing.assert_allclose(float(bsq), float(bp), rtol=RTOL)


# ---- GMRES and block-Jacobi on the card (the kernels they reach) --------------------------

def _convdiff_csr(nx, dtype=np.float32):
    from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo

    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=10.0)
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order].astype(dtype)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=shape[0]))])
    return v, c, indptr, shape


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dia", "bell-packed"])
def test_gmres_launches_its_spmv_kernel(dev, layout):
    """GMRES(16) on convection-diffusion (nx = 48): DIA takes kernel 7's
    dia_spmv_rows (5 diagonals), sparse-tile blocked-ELL packed kernel 5;
    one launch per inner step and per cycle end, plus one for r0 and one
    per cycle start; the history within 1e-3 of the CPU's over 12 steps,
    info.rnorm within 1e-3 of ||b - Ax|| in float64."""
    from conjugategradient_tpu_torch import DIAMatrix, gmres_solve
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    v, c, p, shape = _convdiff_csr(48)

    def build(device):
        if layout == "dia":
            return DIAMatrix.from_csr_host(v, c, p, shape, device=device)
        return BlockedEllMatrix.from_csr_host(v, c, p, shape, bm=128, bn=128, device=device)

    a, a_cpu = build(dev), build("cpu")
    name = "dia_spmv_rows" if layout == "dia" else "bell_spmv_packed"
    if layout != "dia":
        assert bell_packed_route(a)
    b = torch.arange(1, shape[0] + 1, dtype=torch.float32) / shape[0]
    before, plain_before = fc.LAUNCHES[name], dict(fc.PLAIN_ON_CUDA)
    x, info = gmres_solve(a, b.to(dev), tol=0.0, maxiter=64, restart=16)
    torch.cuda.synchronize()
    assert int(info.iterations) == 64 and int(info.cycles) == 4
    assert fc.LAUNCHES[name] - before >= 64 + 4 + 1
    assert dict(fc.PLAIN_ON_CUDA) == plain_before  # no plain version on the card
    _, ref = gmres_solve(a_cpu, b, tol=0.0, maxiter=64, restart=16)
    np.testing.assert_allclose(info.rnorm_history.cpu().numpy()[:12],
                               ref.rnorm_history.numpy()[:12], rtol=1e-3)
    r = b.double() - a_cpu.to_dense().double() @ x.cpu().double()
    np.testing.assert_allclose(float(info.rnorm), float(r.norm()), rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [3, 8, 16])
def test_block_jacobi_apply_launches_kernel_7(dev, block_size):
    """b <= 16: the apply is a DIA product of 2b - 1 <= 31 diagonals, one
    dia_spmv_rows launch a call, equal to the CPU apply to 1e-6 of max|y|."""
    from conjugategradient_tpu_torch import CSRMatrix
    from conjugategradient_tpu_torch.solver.precond import block_jacobi_preconditioner

    v, c, p, shape = _convdiff_csr(40)
    M = block_jacobi_preconditioner(CSRMatrix.from_arrays(v, c, p, shape, device=dev), block_size)
    Mc = block_jacobi_preconditioner(CSRMatrix.from_arrays(v, c, p, shape, device="cpu"),
                                     block_size)
    r = torch.from_numpy(np.random.default_rng(block_size).standard_normal(shape[0])).float()
    before = fc.LAUNCHES["dia_spmv_rows"]
    y = M(r.to(dev))
    torch.cuda.synchronize()
    assert fc.LAUNCHES["dia_spmv_rows"] == before + 1
    yc = Mc(r)
    np.testing.assert_allclose(y.cpu().numpy(), yc.numpy(), rtol=0,
                               atol=1e-6 * float(yc.abs().max()))


# ---- multi-RHS: the plain *_spmv_multi forms and the lockstep loops -------

def _poisson_csr(nx, dev, dtype=np.float32):
    from conjugategradient_tpu_torch import CSRMatrix
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    rows, cols, vals, shape = poisson2d_coo(nx)
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order].astype(dtype)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=shape[0]))])
    return CSRMatrix.from_arrays(v, c, indptr, shape, device=dev)


MULTI_FORMS = ("bell-dense", "bell-packed", "symbell", "dia", "symdia", "sell")


@pytest.mark.cuda
@pytest.mark.parametrize("form", MULTI_FORMS)
def test_multi_forms_match_the_single_rhs_kernels(dev, form):
    """Each column of a multi-RHS SpMV (plain torch on the card) against the
    single-RHS route on that column: kernel 5 (dense tiles or packed), 7 or
    10, and for SELL its plain form; to 1e-5 of max|Y| (f32 sums in another
    order)."""
    from conjugategradient_tpu_torch import DIAMatrix, SellMatrix, SymDIAMatrix
    from conjugategradient_tpu_torch.ops import spmv

    csr = _poisson_csr(45, dev)
    if form == "bell-dense":
        blocks, cols, nnz = block_tridiag_tiles(128 * 24, 128, 128, seed=1)
        a = BlockedEllMatrix(torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev),
                             (128 * 24, 128 * 24), nnz)
        multi, single, kernel = spmv.bell_spmv_multi, spmv.bell_spmv, "bell_spmv"
    elif form == "bell-packed":
        a = BlockedEllMatrix.from_csr(csr, bm=128, bn=128)
        multi, single, kernel = spmv.bell_spmv_multi, spmv.bell_spmv, "bell_spmv_packed"
    elif form == "symbell":
        a = SymBellMatrix.from_csr(csr, bm=32, bn=32)
        full = BlockedEllMatrix.from_csr(csr, bm=32, bn=32)
        multi, kernel = spmv.sym_bell_spmv_multi, "bell_spmv_packed"
        single = lambda _, x: spmv.bell_spmv(full, x)  # noqa: E731
    elif form == "dia":
        a = DIAMatrix.from_csr(csr)
        multi, single, kernel = spmv.dia_spmv_multi, spmv.dia_spmv, "dia_spmv_rows"
    elif form == "symdia":
        a = SymDIAMatrix.from_csr(csr)
        multi, single, kernel = spmv.sym_dia_spmv_multi, spmv.sym_dia_spmv, "sym_dia_spmv_rows"
    else:
        a = SellMatrix.from_csr(csr)
        multi, single, kernel = spmv.sell_spmv_multi, spmv.sell_spmv, None
    n = a.shape[0]
    X = torch.randn(n, 8, generator=torch.Generator().manual_seed(3)).to(dev)
    before = dict(fc.LAUNCHES)
    Y = multi(a, X)
    assert fc.LAUNCHES == before  # the multi forms launch no kernel
    for j in range(8):
        y = single(a, X[:, j].contiguous())
        _close(Y[:, j], y)
    if kernel is not None:
        assert fc.LAUNCHES[kernel] == before[kernel] + 8


@pytest.mark.cuda
def test_sym_bell_multi_repeats_bit_identical(dev):
    """The mirror lands through the fixed-order gather, not a scatter with
    atomics: two calls on the card give the same bits."""
    from conjugategradient_tpu_torch.ops.spmv import sym_bell_spmv_multi

    blocks, cols, nnz = block_tridiag_tiles(128 * 40, 128, 128, seed=2)
    a = SymBellMatrix._pack_np(blocks, cols.astype(np.int64), (5120, 5120), (5120, 5120), nnz,
                               check=False, device=dev)
    X = torch.randn(5120, 16, generator=torch.Generator().manual_seed(4)).to(dev)
    assert torch.equal(sym_bell_spmv_multi(a, X), sym_bell_spmv_multi(a, X))


@pytest.mark.cuda
def test_lockstep_loop_stops_within_lookahead(dev):
    """The lockstep loop on the card: block-Jacobi (b = 8) applied column by
    column launches kernel 7 R times a step, and at most LOOKAHEAD - 1
    steps follow the one that ends the last lane."""
    from conjugategradient_tpu_torch import DIAMatrix, cg_solve_batched
    from conjugategradient_tpu_torch.solver.precond import block_jacobi_preconditioner
    from conjugategradient_tpu_torch.solver.restart import LOOKAHEAD

    csr = _poisson_csr(60, dev)
    a = DIAMatrix.from_csr(csr)
    M = block_jacobi_preconditioner(csr, block_size=8)
    n, R = a.shape[0], 4
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    B = torch.stack([torch.roll(b, j) for j in range(R)])
    tol = 1e-5 * float(torch.linalg.norm(b))
    before = fc.LAUNCHES["dia_spmv_rows"]
    X, info = cg_solve_batched(a, B, tol=tol, M=M)
    torch.cuda.synchronize()
    steps = (fc.LAUNCHES["dia_spmv_rows"] - before) // R - 1  # one apply at init
    k = int(info.iterations.max())
    assert bool(info.converged.all())
    assert 0 <= steps - k <= LOOKAHEAD - 1, (steps, k)


@pytest.mark.cuda
def test_nrhs_on_a_stencil_launches_stencil7(dev, capsys):
    """--nrhs on a stencil: input runs each lane's solo portable loop, whose
    matvec is kernel 11."""
    from conjugategradient_tpu_torch import tester

    before = _k11_launches()
    assert tester.main(["stencil:24", "--nrhs", "3", "--dtype", "float32", "--tol", "1e-2",
                        "--summary", "--device", "cuda"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    import json

    lanes = json.loads(lines[1])
    assert lanes["nrhs"] == 3 and lanes["converged"] == [True] * 3
    assert _k11_launches() - before >= 2 * sum(lanes["iterations"])


def _host_reads(fn):
    """fn() under torch's sync debug mode: (host reads it made, result)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen), out


def _ca_operator(layout, dev):
    """poisson2d(40) as float32 DIA, dense-route blocked-ELL (32 x 32
    tiles of the 2-D Poisson band are dense enough) or packed blocked-ELL,
    with the kernel its SpMV launches."""
    from conjugategradient_tpu_torch import BlockedEllMatrix, DIAMatrix
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    csr = _poisson_csr(40, dev)
    if layout == "dia":
        return DIAMatrix.from_csr(csr), "dia_spmv_rows"
    a = BlockedEllMatrix.from_csr(csr, bm=128, bn=128)
    return a, ("bell_spmv_packed" if bell_packed_route(a) else "bell_spmv")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dia", "bell"])
@pytest.mark.parametrize("method", ["pipelined", "pipelined-jacobi", "sstep2", "sstep4"])
def test_ca_loops_launch_their_spmv_kernel(dev, layout, method):
    """Pipelined (with and without Jacobi) and s-step CG on float32 DIA and
    blocked-ELL launch kernel 7 or kernel 5 once per iteration (plus the
    initial residual and s-step's final one), run no plain version on the
    card, and follow the CPU's float32 trajectory over the first steps."""
    from conjugategradient_tpu_torch import jacobi_preconditioner
    from conjugategradient_tpu_torch.solver import pipelined_cg_solve, sstep_cg_solve

    a, kernel = _ca_operator(layout, dev)
    n = a.shape[0]
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n

    def solve(op, bb, maxiter, tol=0.0):
        if method.startswith("sstep"):
            return sstep_cg_solve(op, bb, s=int(method[-1]), tol=tol, maxiter=maxiter)
        M = jacobi_preconditioner(op) if method.endswith("jacobi") else None
        return pipelined_cg_solve(op, bb, tol=tol, maxiter=maxiter, M=M)

    fc.reset_counts()
    _, info = solve(a, b, 24)
    torch.cuda.synchronize()
    assert int(info.iterations) == 24
    # r0, plus w0 = A u0 under GV, plus one a step (A r; GV's A m; s a
    # block of s steps): the cap launches no step past it
    assert fc.LAUNCHES[kernel] == 24 + (2 if method.endswith("jacobi") else 1)
    assert not any(fc.PLAIN_ON_CUDA.values()), dict(fc.PLAIN_ON_CUDA)
    a_cpu = a.to("cpu")
    _, ic = solve(a_cpu, b.cpu(), 24)
    hk, hc = info.rho_history.double().cpu(), ic.rho_history.double()
    keep = ~torch.isnan(hc) & (hc > 1e-8 * hc[0])
    torch.testing.assert_close(hk[keep], hc[keep], rtol=5e-2, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("smooth", [True, False], ids=["smoothed", "unsmoothed"])
def test_amg_apply_launches_kernel_7_and_repeats_bit_identical(dev, smoother, smooth):
    """An SA-AMG apply on a float32 CSR system: its DIA levels launch
    kernel 7, no plain version runs on the card, the restriction's sorted
    segment sums keep two applies bit-identical, and the apply matches the
    CPU's to float32 rounding."""
    from conjugategradient_tpu_torch.solver import smoothed_aggregation_preconditioner

    csr = _poisson_csr(64, dev)
    M = smoothed_aggregation_preconditioner(csr, smoother=smoother, smooth_prolongator=smooth)
    assert M.n_levels >= 2
    r = torch.randn(csr.shape[0], generator=torch.Generator().manual_seed(3)).to(dev)
    fc.reset_counts()
    z1 = M(r)
    z2 = M(r)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["dia_spmv_rows"] + fc.LAUNCHES["dia_spmv"] > 0
    assert not any(fc.PLAIN_ON_CUDA.values()), dict(fc.PLAIN_ON_CUDA)
    assert torch.equal(z1, z2)
    Mc = smoothed_aggregation_preconditioner(_poisson_csr(64, "cpu"), smoother=smoother,
                                             smooth_prolongator=smooth)
    _close(z1.cpu(), Mc(r.cpu()), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["auto", "bell"])
@pytest.mark.parametrize("power", [1, 2])
def test_fsai_apply_launches_its_kernel(dev, layout, power):
    """An FSAI apply: two SpMVs, each a kernel launch in the factors'
    layout (DIA: kernel 7; blocked-ELL: kernel 5), no plain version."""
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.solver import fsai_preconditioner

    csr = _poisson_csr(48, dev)
    M = fsai_preconditioner(csr, power=power, layout=layout)
    if layout == "auto":
        kernel = "dia_spmv_rows"
    else:
        kernel = "bell_spmv_packed" if bell_packed_route(M.G) else "bell_spmv"
    r = torch.randn(csr.shape[0], generator=torch.Generator().manual_seed(5)).to(dev)
    fc.reset_counts()
    z = M(r)
    torch.cuda.synchronize()
    assert fc.LAUNCHES[kernel] == 2
    assert not any(fc.PLAIN_ON_CUDA.values()), dict(fc.PLAIN_ON_CUDA)
    zh = torch.from_numpy(M.G_host.T @ (M.G_host @ r.double().cpu().numpy()))
    _close(z.double().cpu(), zh, rtol=1e-5)


@pytest.mark.cuda
def test_ca_host_reads(dev):
    """Host reads on the card: the pipelined loop reads only its done flag,
    once per CHECK_EVERY steps; s-step reads twice a block (the two eigh
    result checks) and its flag once per CHECK_EVERY blocks."""
    from conjugategradient_tpu_torch.solver import pipelined_cg_solve, sstep_cg_solve
    from conjugategradient_tpu_torch.solver.restart import CHECK_EVERY

    a, _ = _ca_operator("dia", dev)
    n = a.shape[0]
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    pipelined_cg_solve(a, b, tol=-1.0, maxiter=8)
    steps = 128
    reads, (_, info) = _host_reads(lambda: pipelined_cg_solve(a, b, tol=-1.0, maxiter=steps))
    assert int(info.iterations) == steps
    assert reads <= steps // CHECK_EVERY + 2, reads
    s = 4
    sstep_cg_solve(a, b, s=s, tol=-1.0, maxiter=8)
    reads, (_, info) = _host_reads(lambda: sstep_cg_solve(a, b, s=s, tol=-1.0, maxiter=steps))
    blocks = steps // s
    assert int(info.iterations) == steps
    assert 2 * blocks <= reads <= 2 * blocks + blocks // CHECK_EVERY + 2, reads


@pytest.mark.cuda
def test_tester_runs_the_new_flags_on_the_card(dev, capsys):
    """--method pipelined|sstep and --precond amg|fsai through the tester
    on the card, each converged with the reference line's rel_error."""
    import json

    from conjugategradient_tpu_torch import tester

    mtx = str(pathlib.Path(__file__).resolve().parents[1] / "problems" / "poisson2d_34.mtx")
    for extra in (["--method", "pipelined"], ["--method", "sstep", "--sstep-s", "2"],
                  ["--precond", "amg"], ["--precond", "fsai", "--fsai-power", "2"],
                  ["--precond", "amg", "--method", "gmres"]):
        assert tester.main([mtx, "--tol", "1e-6", "--summary", "--device", "cuda",
                            *extra]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert json.loads(lines[1])["converged"] == [True], extra
        assert float(lines[0].split()[3]) < 1e-16, extra


@pytest.mark.cuda
def test_sstep_nan_exit_on_the_card(dev):
    """A NaN in b: the first block's Gram is NaN; its block solves give NaN
    (not an eigh error) and the loop exits unconverged after one block, as
    on the CPU."""
    from conjugategradient_tpu_torch.solver import sstep_cg_solve

    a, _ = _ca_operator("dia", dev)
    b = torch.ones(a.shape[0], device=dev)
    b[7] = float("nan")
    _, info = sstep_cg_solve(a, b, s=2, tol=1e-3)
    assert int(info.iterations) == 2 and not bool(info.converged)
    assert bool(torch.isnan(info.rnorm_sq))


# ---- deflated CG, LOBPCG and the scipy drop-in -----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dia", "bell"])
def test_deflated_cg_launches_its_spmv_kernel(dev, layout):
    """The harvest and the deflated solve on float32 DIA and blocked-ELL
    launch kernel 7 or 5 once a step (and per basis column), run no plain
    version on the card, and take the CPU's float32 count within 2; the
    true residual sits at float32's floor there (4e-5 of ||b|| measured,
    above the 1e-5 tolerance on the recurrence), within 2x of the CPU's."""
    from conjugategradient_tpu_torch import deflated_cg_solve, harvest_deflation_basis
    from conjugategradient_tpu_torch.solver import basis_quality

    a, kernel = _ca_operator(layout, dev)
    a_cpu, _ = _ca_operator(layout, "cpu")
    n = a.shape[0]
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    tol = 1e-5 * float(torch.linalg.vector_norm(b))
    fc.reset_counts()
    basis, x_m = harvest_deflation_basis(a, b, k=8, m=60, return_x=True)
    torch.cuda.synchronize()
    assert fc.LAUNCHES[kernel] == 60 + 8  # the m steps and AW
    x, info = deflated_cg_solve(a, b, basis, x0=x_m, tol=tol)
    its = int(info.iterations)
    assert bool(info.converged)
    assert fc.LAUNCHES[kernel] >= 60 + 8 + its
    assert not any(fc.PLAIN_ON_CUDA.values()), dict(fc.PLAIN_ON_CUDA)
    q = basis_quality(a, basis)
    bc = b.cpu()
    bh, xh = harvest_deflation_basis(a_cpu, bc, k=8, m=60, return_x=True)
    xc, ih = deflated_cg_solve(a_cpu, bc, bh, x0=xh, tol=tol)
    assert abs(its - int(ih.iterations)) <= 2
    _close(q.double().cpu(), basis_quality(a_cpu, bh).double(), rtol=1e-2)
    a64 = a_cpu.astype(torch.float64)

    def true_rel(xx):
        r = bc.double() - a64.matvec(xx.double().cpu())
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bc.double()))

    assert true_rel(x) < 1e-3 and true_rel(x) <= 2 * true_rel(xc)


@pytest.mark.cuda
def test_deflated_cg_float64_on_the_card_matches_cpu(dev):
    """float64 CSR (no kernel): the card's deflated solve takes the CPU's
    count, its history within 1e-10 above 1e-8 rho_0."""
    from conjugategradient_tpu_torch import deflated_cg_solve
    from conjugategradient_tpu_torch.solver import deflation_basis_from_vectors

    a = _poisson_csr(24, dev, np.float64)
    a_cpu = _poisson_csr(24, "cpu", np.float64)
    _, V = np.linalg.eigh(a_cpu.to_dense().numpy())
    W = torch.from_numpy(V[:, :8])
    b = torch.arange(1, a.shape[0] + 1, dtype=torch.float64)
    basis = deflation_basis_from_vectors(a, W.to(dev))
    _, ic = deflated_cg_solve(a, b.to(dev), basis, tol=1e-10)
    _, ih = deflated_cg_solve(a_cpu, b, deflation_basis_from_vectors(a_cpu, W), tol=1e-10)
    k = int(ih.iterations)
    assert int(ic.iterations) == k and bool(ic.converged)
    hc, hh = ic.rho_history[: k + 1].cpu().numpy(), ih.rho_history[: k + 1].numpy()
    keep = hh > 1e-8 * hh[0]
    np.testing.assert_allclose(hc[keep], hh[keep], rtol=1e-10)


@pytest.mark.cuda
def test_lobpcg_on_the_card_matches_cpu(dev):
    """float64 poisson2d(20) CSR and float32 DIA with Jacobi: the card's
    pairs are the CPU's (1e-10 / 1e-4), the counts within 3; the DIA block
    matvec is the plain dia_spmv_multi, the Jacobi apply elementwise."""
    from conjugategradient_tpu_torch import DIAMatrix, jacobi_preconditioner, lobpcg_eigs

    a, a_cpu = _poisson_csr(20, dev, np.float64), _poisson_csr(20, "cpu", np.float64)
    rc = lobpcg_eigs(a, k=4, tol=1e-8, maxiter=400)
    rh = lobpcg_eigs(a_cpu, k=4, tol=1e-8, maxiter=400)
    assert rc.vectors.device.type == dev.type and np.all(rc.converged)
    assert abs(rc.iters - rh.iters) <= 3
    np.testing.assert_allclose(rc.values, rh.values, rtol=1e-10)
    d = DIAMatrix.from_csr(_poisson_csr(20, dev))
    d_cpu = DIAMatrix.from_csr(_poisson_csr(20, "cpu"))
    rc = lobpcg_eigs(d, k=4, M=jacobi_preconditioner(d), tol=1e-4, maxiter=200)
    rh = lobpcg_eigs(d_cpu, k=4, M=jacobi_preconditioner(d_cpu), tol=1e-4, maxiter=200)
    np.testing.assert_allclose(rc.values, rh.values, rtol=1e-4)
    assert abs(rc.iters - rh.iters) <= 3


@pytest.mark.cuda
def test_nan_paths_raise_nothing_on_the_card(dev):
    """eigh and the Cholesky factorization raise on a NaN matrix on the
    card; the port hands them none: LOBPCG with a NaN in X0 or in B runs to
    its cap with NaN pairs, an A-degenerate basis gives a NaN E_chol and the
    deflated solve its NaN exit, as on the CPU and in the JAX package."""
    from conjugategradient_tpu_torch import deflated_cg_solve, lobpcg_eigs
    from conjugategradient_tpu_torch.solver import deflation_basis_from_vectors

    a = _poisson_csr(12, dev, np.float64)
    n = a.shape[0]
    X0 = torch.randn(n, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    X0[5, 1] = float("nan")
    res = lobpcg_eigs(a, k=3, X0=X0.to(dev), tol=1e-6, maxiter=5)
    assert res.iters == 5 and np.isnan(res.values).all() and not res.converged.any()
    B = torch.eye(n, dtype=torch.float64, device=dev)
    B[3, 3] = float("nan")
    res = lobpcg_eigs(a, k=3, B=B, tol=1e-6, maxiter=4)
    assert res.iters == 4 and np.isnan(res.values).all()
    # a zero column: E = WᵀAW has an exact zero pivot on every device (a
    # repeated column leaves one of rounding size, which cuSOLVER accepts)
    _, V = np.linalg.eigh(a.to_dense().cpu().numpy())
    W = torch.from_numpy(np.concatenate([V[:, :3], np.zeros((n, 1))], axis=1)).to(dev)
    basis = deflation_basis_from_vectors(a, W)
    assert bool(torch.isnan(basis.E_chol).any())
    b = torch.ones(n, dtype=torch.float64, device=dev)
    x, info = deflated_cg_solve(a, b, basis, tol=1e-8)
    assert int(info.iterations) == 1 and not bool(info.converged)
    assert bool(torch.isnan(x).all())


@pytest.mark.cuda
def test_tester_eigs_and_deflate_on_the_card(dev, capsys):
    import json

    from conjugategradient_tpu_torch import tester

    mtx = str(pathlib.Path(__file__).resolve().parents[1] / "problems" / "poisson2d_34.mtx")
    assert tester.main([mtx, "--deflate", "8", "--tol", "1e-8", "--summary",
                        "--device", "cuda"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[0] == "1156" and float(lines[0].split()[3]) < 1e-10
    assert json.loads(lines[1])["converged"] == [True]
    for extra in (["--precond", "jacobi", "--history"], ["--eigs-method", "lanczos"]):
        assert tester.main([mtx, "--eigs", "4", "--layout", "bell", "--dtype", "float32",
                            "--device", "cuda", *extra]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        rec = json.loads(lines[1])
        assert len(rec["eigenvalues"]) == 4 and np.all(np.isfinite(rec["eigenvalues"]))


@pytest.mark.cuda
def test_scipy_compat_on_the_card(dev):
    """scipy matrices go to the card; a numpy-backed LinearOperator is
    refused there with TypeError."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from conjugategradient_tpu_torch import scipy_compat
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    rows, cols, vals, shape = poisson2d_coo(12)
    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    b = np.arange(1, shape[0] + 1, dtype=np.float64)
    x, info = scipy_compat.cg(A, b, rtol=1e-10, device=dev)
    assert info == 0 and x.is_cuda
    assert np.linalg.norm(b - A @ x.cpu().numpy()) <= 1.1e-10 * np.linalg.norm(b)
    lo = spla.LinearOperator(A.shape, matvec=lambda v: A @ np.asarray(v))
    with pytest.raises(TypeError, match="numpy-backed"):
        scipy_compat.cg(lo, b, device=dev)
    w = scipy_compat.eigsh(A, k=4, which="SM", return_eigenvectors=False, device=dev)
    np.testing.assert_allclose(w, np.sort(spla.eigsh(A, k=4, which="SM")[0]), rtol=1e-8)


# ---- the bfloat16-tile forms of kernels 1, 4, 5 and 7 ----------------------

def _sym_case(dev, storage):
    rng = np.random.default_rng(3)
    bn, nrb = 32, 13
    if storage == "sym-banded":
        n = nrb * bn
        blocks, bcols, nnz = block_tridiag_tiles(n, bn, bn, seed=2)
        return SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), (n, n), (n, n), nnz,
                                      check=False, device=dev)
    return SymBellMatrix.from_bell(BlockedEllMatrix.from_csr_host(
        *_block_csr(rng, nrb, bn, bn, 3), bm=bn, bn=bn, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["full", "sym-banded", "sym-general"])
def test_bf16_dir_kernels_bit_equal_to_widened(dev, storage):
    """Kernels 4 and 1 on bfloat16 tiles, ± Jacobi d, β = 0 and β ≠ 0: every
    output bit-equal to the float32 launch on the widened tiles (the bf16
    form widens each element as it loads it and sums in the float32
    order); p_new bit-equal to the plain version, q within RTOL, pap within
    RTOL; counted under the ``_bf16`` names."""
    if storage == "full":
        rng = np.random.default_rng(5)
        a = BlockedEllMatrix.from_csr_host(*_block_csr(rng, 13, 32, 32, 3), bm=32, bn=32,
                                           device=dev).astype(torch.bfloat16)
        name = "fused_dir_spmv_dot_bf16"
        nrb, bn = a.nrb, a.bn

        def launch(lo, *args):
            t = a.blocks if lo else a.blocks.float()
            return fc.fused_dir_spmv_dot(t, a.block_cols, *args, row_group=3)

        def plain(*args):
            return fc._full_dir_plain(a.blocks, a.block_cols, *args, None, None)
    else:
        a = _sym_case(dev, storage).astype(torch.bfloat16)
        mirror = "banded" if storage == "sym-banded" else "scatter"
        name = "sym_fused_dir_spmv_dot_bf16"
        nrb, bn = a.nrb, a.bn

        def launch(lo, *args):
            dg, off = (a.diag_blocks, a.off_blocks) if lo else (a.diag_blocks.float(),
                                                                a.off_blocks.float())
            return fc.sym_fused_dir_spmv_dot(dg, off, a.off_cols, *args, mirror=mirror,
                                             row_group=4, mirror_src=a.mirror_src)

        def plain(*args):
            return fc._sym_dir_plain(a.diag_blocks, a.off_blocks, a.off_cols, *args,
                                     a.mirror_src, None, None)
    r, p = torch.randn(nrb, bn, device=dev), torch.randn(nrb, bn, device=dev)
    d = torch.rand(nrb, bn, device=dev) + 0.5
    for beta_v in (0.0, 0.37):
        beta = torch.full((1, 1), beta_v, device=dev)
        for dd in (None, d):
            before = fc.LAUNCHES[name]
            k = launch(True, r, p, beta, dd)
            assert fc.LAUNCHES[name] == before + 1
            w = launch(False, r, p, beta, dd)
            pl = plain(r, p, beta, dd)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(k, w))
            assert torch.equal(k[0], pl[0])
            _close(k[1], pl[1])
            np.testing.assert_allclose(float(k[2]), float(pl[2]), rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["full", "sym"])
@pytest.mark.parametrize("bn", [8, 32, 128])
def test_bf16_packed_kernels_bit_equal(dev, bn, storage):
    """The packed kernels 5 and 4 on a bfloat16 view (6 bytes a nonzero):
    y, p_new and q bit-equal to the float32 launch on the widened values
    and to the plain versions, pap within RTOL; the route takes the packed
    view for bf16 tiles too; counted under the ``_bf16`` names."""
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.types.bell import PackedBell

    rng = np.random.default_rng(bn + 1)
    nrb = 5 if bn == 128 else 13
    n = nrb * bn - 3
    a = BlockedEllMatrix.from_csr_host(*_sparse_csr(rng, n, n, 3, spd=True), bm=bn, bn=bn,
                                       device=dev)
    if storage == "sym":
        a = SymBellMatrix.from_bell(a)
    lo = a.astype(torch.bfloat16)
    assert bell_packed_route(lo)
    pk = lo.packed()
    assert pk.vals.dtype == torch.bfloat16
    wide = PackedBell(pk.vals.float(), pk.cols, pk.row_len, pk.chunk_off, pk.nnz, pk.ncols,
                      pk.symmetric)
    x = torch.randn(pk.ncols, device=dev)
    before = fc.LAUNCHES["bell_spmv_packed_bf16"]
    y = kb.bell_spmv_packed(pk, x)
    assert fc.LAUNCHES["bell_spmv_packed_bf16"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(y, kb.bell_spmv_packed(wide, x))
    assert torch.equal(y, kb.packed_apply(pk, x))
    name = ("sym_fused_dir_spmv_dot_packed_bf16" if storage == "sym"
            else "fused_dir_spmv_dot_packed_bf16")
    r, p = torch.randn(nrb, bn, device=dev), torch.randn(nrb, bn, device=dev)
    d = torch.rand(nrb, bn, device=dev) + 0.5
    for beta_v in (0.0, 0.37):
        beta = torch.full((1, 1), beta_v, device=dev)
        for dd in (None, d):
            before = fc.LAUNCHES[name]
            k = fc.fused_dir_spmv_dot_packed(pk, r, p, beta, dd)
            assert fc.LAUNCHES[name] == before + 1
            w = fc.fused_dir_spmv_dot_packed(wide, r, p, beta, dd)
            pl = fc._packed_dir_plain(pk, r, p, beta, dd, None, None)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(k, w))
            assert torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1])
            np.testing.assert_allclose(float(k[2]), float(pl[2]), rtol=RTOL)


@pytest.mark.cuda
def test_bf16_solves_take_the_bf16_kernels(dev):
    """cg_solve on bfloat16 blocked-ELL tiles with float32 vectors runs the
    fused bf16 kernels (dense tiles: kernels 4 and 1; the packed view on
    sparse tiles), refined_cg_solve reaches a float32 tolerance with them,
    MINRES on bf16 tiles runs the fused bf16 kernels 14 / 15 (packed on
    sparse tiles) with kernel 16, its sticky NaN flag set by a NaN tile
    value, BiCGStab on bf16 tiles runs its portable loop on kernel 5's bf16
    forms, and no plain version runs on CUDA tensors."""
    from conjugategradient_tpu_torch import (bicgstab_solve, cg_solve, minres_solve,
                                             refined_cg_solve)
    from conjugategradient_tpu_torch.problems import poisson2d_coo
    from conjugategradient_tpu_torch.types import CSRMatrix

    n = 64 * 128
    blocks, bcols, nnz = block_tridiag_tiles(n, 128, 128, seed=0)
    full = BlockedEllMatrix(torch.from_numpy(blocks).to(dev),
                            torch.from_numpy(bcols).to(dev), (n, n), nnz)
    sym = SymBellMatrix.from_bell(full)
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    rows, cols, vals, shape = poisson2d_coo(64)
    csr = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device="cpu")
    sparse = BlockedEllMatrix.from_csr_host(csr.data.numpy(), csr.indices.numpy(),
                                            csr.indptr.numpy(), shape, bm=128, bn=128,
                                            device=dev)
    bs = torch.arange(1, shape[0] + 1, dtype=torch.float32, device=dev)
    for a, rhs, kernel in ((full, b, "fused_dir_spmv_dot_bf16"),
                           (sym, b, "sym_fused_dir_spmv_dot_bf16"),
                           (sparse, bs, "fused_dir_spmv_dot_packed_bf16")):
        fc.reset_counts()
        tol = 1e-4 * float(rhs.norm())  # above float32's floor on poisson2d(64)
        x, info = refined_cg_solve(a, rhs, tol=tol)
        assert info.converged and info.refinements >= 1
        assert fc.LAUNCHES[kernel] >= info.inner_iterations
        assert float((rhs.double() - a.matvec(x).double()).norm()) <= 1.05 * tol
        _, cinfo = cg_solve(a.astype(torch.bfloat16), rhs, maxiter=8, tol=-1.0)
        assert int(cinfo.iterations) == 8
        assert not any(fc.PLAIN_ON_CUDA.values()), fc.PLAIN_ON_CUDA
    lo = full.astype(torch.bfloat16)
    # the one bell_spmv_bf16 of a full-storage MINRES solve is its true
    # residual after the loop (as the JAX solve computes it); symmetric
    # storage's is the plain form, the packed route's the packed kernel
    for a, rhs, kernel, spmv in ((lo, b, "minres_dir_spmv_dot_bf16", 1),
                                 (sym.astype(torch.bfloat16), b, "sym_minres_dir_spmv_dot_bf16", 0),
                                 (sparse.astype(torch.bfloat16), bs,
                                  "minres_dir_spmv_dot_packed_bf16", 0)):
        fc.reset_counts()
        _, minfo = minres_solve(a, rhs, maxiter=8, tol=0.0)
        assert int(minfo.iterations) == 8 and np.isfinite(float(minfo.rnorm))
        assert fc.LAUNCHES[kernel] >= 8 and fc.LAUNCHES["minres_update_dot"] >= 8
        assert fc.LAUNCHES["bell_spmv_bf16"] == spmv
        assert not any(fc.PLAIN_ON_CUDA.values()), fc.PLAIN_ON_CUDA
    bad = lo.blocks.clone()
    bad[0, 0, 0, 0] = float("nan")
    _, ninfo = minres_solve(BlockedEllMatrix(bad, lo.block_cols, lo.shape, lo.nnz), b,
                            maxiter=8, tol=0.0)
    assert not bool(ninfo.converged) and math.isnan(float(ninfo.rnorm))
    assert int(ninfo.iterations) == 1
    fc.reset_counts()
    _, binfo = bicgstab_solve(lo, b, maxiter=8, tol=0.0)
    assert fc.LAUNCHES["bell_spmv_bf16"] > 0 and fc.LAUNCHES["bicgstab_dir_spmv_dot"] == 0
    assert np.isfinite(float(binfo.rnorm))
    assert not any(fc.PLAIN_ON_CUDA.values()), fc.PLAIN_ON_CUDA


@pytest.mark.cuda
def test_tester_refine_and_bf16_on_the_card(dev, capsys):
    """The tester's --refine and --dtype bfloat16 on the card, SymDIA
    included (kernel 10's bf16 forms), and the stencil on bf16 vectors
    (kernel 11's bf16 form; rel_error under 5e-3, as on the CPU)."""
    import json

    from conjugategradient_tpu_torch import tester

    mtx = str(pathlib.Path(__file__).resolve().parents[1] / "problems" / "poisson2d_34.mtx")
    for extra in (["--dtype", "float32", "--refine", "bfloat16", "--tol", "1"],
                  ["--dtype", "float64", "--refine", "float32", "--tol", "1e-8"],
                  ["--dtype", "bfloat16", "--tol", "1"]):
        for layout in ("csr", "bell", "dia", "symdia"):
            assert tester.main([mtx, "--layout", layout, "--summary", "--device", "cuda",
                                *extra]) == 0
            lines = capsys.readouterr().out.strip().splitlines()
            assert lines[0].split()[:2] == ["1156", "5644"]
            assert json.loads(lines[1])["converged"] == [True], (layout, extra)
    before = _k11_launches("_bf16")
    assert tester.main(["stencil:16", "--dtype", "bfloat16", "--tol", "1e-1", "--summary",
                        "--device", "cuda"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:2] == ["4096", "27136"]
    assert json.loads(lines[1])["converged"] == [True] and float(lines[0].split()[3]) < 5e-3
    assert _k11_launches("_bf16") > before


# ---- kernels 1 and 15 on the banded landing: the staged tile ring ------------

# (nrb, R): one block-row; ragged strips; fewer strips than SMs; more strips
# than resident CTAs (326 strips of 4 rows on at most 2 x 132 CTAs), so the
# persistent spans cross strip boundaries, unevenly
BANDED_SHAPES = [(1, 8), (13, 4), (100, 1), (1301, 4)]


def _banded_tiles(nrb, bn, dev, seed):
    """Random block-tridiagonal symmetric storage on the card: diagonal
    tiles, upper tiles at column block row + 1, and padding slots (a zero
    tile at the row's own block) for the last row and, from nrb = 13, rows
    3 and 7, so a strip's halo is skipped; the transposed index last."""
    from conjugategradient_tpu_torch.types.bell import mirror_index

    g = torch.Generator(device=dev).manual_seed(seed)
    diag = torch.randn(nrb, bn, bn, device=dev, generator=g)
    off = torch.randn(nrb, 1, bn, bn, device=dev, generator=g)
    cols = np.arange(1, nrb + 1).reshape(nrb, 1)
    for h in (nrb - 1, *((3, 7) if nrb >= 13 else ())):
        cols[h] = h
        off[h] = 0
    return (diag, off, torch.from_numpy(cols.astype(np.int32)).to(dev),
            torch.from_numpy(mirror_index(cols).astype(np.int32)).to(dev))


def _dot_close(got, want, a, b):
    """A dot against the plain one: float32 sums in another order, so to
    RTOL of sum |a_i b_i| (the tiles are random, the dot may cancel)."""
    atol = RTOL * float((a.double() * b.double()).abs().sum())
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("nrb,R", BANDED_SHAPES)
@pytest.mark.parametrize("bn", [32, 64, 128, 256])
def test_banded_sym_dir_kernel_staged(dev, bn, nrb, R):
    """Kernel 1 on the banded landing, float32 and bf16 tiles, ± Jacobi d,
    β = 0 and β ≠ 0: p_new bit-equal to the plain version, q within RTOL of
    max|q|, pap within RTOL of sum |p q|; the bf16 launch bit-equal to the
    float32 launch on the widened tiles; one launch counted; not live, it
    writes nothing; a NaN tile value reaches pap."""
    from conjugategradient_tpu_torch.ops.cuda._common import form

    diag, off, cols, msrc = _banded_tiles(nrb, bn, dev, seed=bn + nrb)
    lo = (diag.bfloat16(), off.bfloat16())
    g = torch.Generator(device=dev).manual_seed(7)
    r, p = (torch.randn(nrb, bn, device=dev, generator=g) for _ in range(2))
    d = torch.rand(nrb, bn, device=dev, generator=g) + 0.5

    def launch(tiles, beta, dd, **kw):
        return fc.sym_fused_dir_spmv_dot(*tiles, cols, r, p, beta, dd, mirror="banded",
                                         row_group=R, mirror_src=msrc, **kw)

    for beta_v in (0.0, 0.37):
        beta = torch.full((1, 1), beta_v, device=dev)
        for dd in (None, d):
            for tiles in ((diag, off), lo):
                name = form("sym_fused_dir_spmv_dot", tiles[0].dtype)
                before = fc.LAUNCHES[name]
                k = launch(tiles, beta, dd)
                assert fc.LAUNCHES[name] == before + 1
                pl = fc._sym_dir_plain(*tiles, cols, r, p, beta, dd, msrc, None, None)
                torch.cuda.synchronize()
                assert torch.equal(k[0], pl[0])
                _close(k[1], pl[1])
                _dot_close(k[2], pl[2], pl[0], pl[1])
            kb, kw = launch(lo, beta, dd), launch(tuple(t.float() for t in lo), beta, dd)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(kb, kw))
    # not live: nothing written, not even alpha
    work = fc.FusedWork.new(dev, maxiter=0)
    scal = work.scal.clone()
    out = (torch.full_like(r, 7.0), torch.full_like(r, 7.0))
    launch(lo, beta, d, out=out, work=work)
    torch.cuda.synchronize()
    assert bool((out[0] == 7).all() and (out[1] == 7).all())
    assert torch.equal(work.scal, scal) and int(work.counter) == 0
    # a NaN tile value, widened, reaches q and pap
    bad = lo[0].clone()
    bad[nrb // 2, 0, 0] = float("nan")
    kn = launch((bad, lo[1]), beta, d)
    torch.cuda.synchronize()
    assert torch.isnan(kn[1][nrb // 2, 0]) and torch.isnan(kn[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nrb,R", BANDED_SHAPES)
@pytest.mark.parametrize("bn", [32, 64, 128, 256])
def test_banded_minres_dir_kernel_staged(dev, bn, nrb, R):
    """Kernel 15 on the banded landing, float32 and bf16 tiles, ± Jacobi d,
    with and without the pending update, launched in place as the solver
    launches it: v, w and x' bit-equal to the plain version, q within RTOL,
    both dots within RTOL of their sum |a b|; the bf16 launch bit-equal to
    the float32 launch on the widened tiles; not live, it writes nothing;
    a NaN tile value reaches q and v.q."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.cuda._common import form
    from conjugategradient_tpu_torch.ops.spmv import sym_bell_apply

    diag, off, cols, msrc = _banded_tiles(nrb, bn, dev, seed=3 * bn + nrb)
    lo = (diag.bfloat16(), off.bfloat16())

    shape = types.SimpleNamespace(nrb=nrb, bn=bn)

    def launch(tiles, vecs, su, dd, **kw):
        return fm.sym_minres_dir_spmv_dot(*tiles, cols, *vecs, su, dd, mirror="banded",
                                          row_group=R, mirror_src=msrc, **kw)

    for with_d in (False, True):
        for first in (False, True):
            vecs, su, dd = _minres_operands(shape, dev, bn + nrb, with_d, first)
            for tiles in ((diag, off), lo):
                name = form("sym_minres_dir_spmv_dot", tiles[0].dtype)
                wide = tuple(t.float() for t in tiles)
                pl = fm._dir_plain(name, lambda v: sym_bell_apply(wide[0], wide[1], cols, msrc, v),
                                   vecs, su, dd, None, None)
                r2, r1, vprev, wm1, wm2, x = (v.clone() for v in vecs)
                q = torch.empty_like(r2)
                before = fc.LAUNCHES[name]
                k = launch(tiles, (r2, r1, vprev, wm1, wm2, x), su, dd, out=(vprev, q, wm2, x))
                assert fc.LAUNCHES[name] == before + 1
                torch.cuda.synchronize()
                for i in (0, 2, 3):
                    assert torch.equal(k[i], pl[i]), ("v", "q", "w", "x")[i]
                _close(k[1], pl[1])
                _dot_close(k[4], pl[4], pl[0], pl[1])
                _dot_close(k[5], pl[5], pl[0], vecs[1])
            kb, kw = launch(lo, vecs, su, dd), launch(tuple(t.float() for t in lo), vecs, su, dd)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(kb, kw))
    work = fm.MinresWork.new(dev, maxiter=0)
    scal = work.scal.clone()
    out = tuple(torch.full_like(vecs[0], 7.0) for _ in range(4))
    launch(lo, vecs, su, dd, out=out, work=work)
    torch.cuda.synchronize()
    assert all(bool((o == 7).all()) for o in out)
    assert torch.equal(work.scal, scal) and int(work.counter) == 0
    bad = lo[0].clone()
    bad[nrb // 2, 0, 0] = float("nan")
    kn = launch((bad, lo[1]), vecs, su, dd)
    torch.cuda.synchronize()
    assert torch.isnan(kn[1][nrb // 2, 0]) and torch.isnan(kn[4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_banded_kernels_same_bits_at_every_ring_depth(dev, dtype):
    """The ring depth is a measurement knob: kernels 1 and 15 give the same
    bits at 3, 4 and 7 stages as at the default."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    nrb, bn, R = 301, 128, 1
    diag, off, cols, msrc = _banded_tiles(nrb, bn, dev, seed=11)
    tiles = (diag.to(dtype), off.to(dtype))
    g = torch.Generator(device=dev).manual_seed(5)
    r, p = (torch.randn(nrb, bn, device=dev, generator=g) for _ in range(2))
    beta = torch.full((1, 1), 0.37, device=dev)

    vecs, su, dd = _minres_operands(types.SimpleNamespace(nrb=nrb, bn=bn), dev, 9, True)

    def both():
        k1 = fc.sym_fused_dir_spmv_dot(*tiles, cols, r, p, beta, mirror="banded",
                                       row_group=R, mirror_src=msrc)
        k15 = fm.sym_minres_dir_spmv_dot(*tiles, cols, *vecs, su, dd, mirror="banded",
                                         row_group=R, mirror_src=msrc)
        torch.cuda.synchronize()
        return (*k1, *k15)

    ref = both()
    try:
        for stages in (3, 4, 7):
            fc.set_banded_ring_stages(stages)
            assert all(torch.equal(u, v) for u, v in zip(both(), ref)), stages
    finally:
        fc.set_banded_ring_stages(0)


# ---- kernels 6 and 17 on the staged tile ring ------------------------------------

# (nrb, row_group): one row; strips of 3 and 8 with a ragged last strip; one
# strip a CTA; more strips than the card holds CTAs at once, so a CTA walks
# a span of several
SHARD_SHAPES = [(1, 1), (13, 3), (13, 8), (256, 1), (256, 3), (1301, 1), (1301, 8)]


def _ring_shard(nrb, bn, dev, seed):
    """One shard of three on the card, made there: random (nrb, 3, bn, bn)
    tiles with GLOBAL column blocks over 3 nrb block-rows, padding slots
    (a zero tile at column block 0) in slot 2 of the last row and, from
    nrb = 13, rows 3 and 7; the gathered operand and the shard's offset."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ncb = 3 * nrb
    blocks = torch.randn(nrb, 3, bn, bn, device=dev, generator=g)
    cols = torch.randint(0, ncb, (nrb, 3), device=dev, generator=g, dtype=torch.int32)
    for h in (nrb - 1, *((3, 7) if nrb >= 13 else ())):
        blocks[h, 2] = 0.0
        cols[h, 2] = 0
    full = torch.randn(ncb, bn, device=dev, generator=g)
    return blocks, cols, full, nrb * bn


@pytest.mark.cuda
@pytest.mark.parametrize("nrb,R", SHARD_SHAPES)
@pytest.mark.parametrize("bn", [32, 64, 128, 256])
def test_bell_spmv_dot_kernel_staged(dev, bn, nrb, R):
    """Kernel 6 on the staged tile ring, float32 and bf16 tiles: q within
    RTOL of max|q| and pap within RTOL of sum |x q| of the plain version;
    one launch counted; two launches bit-identical; the bf16 launch
    bit-equal to the float32 launch on the widened tiles; not live, it
    writes nothing."""
    from conjugategradient_tpu_torch.ops.cuda._common import form

    blocks, cols, full, off = _ring_shard(nrb, bn, dev, seed=bn + nrb)
    lo = blocks.bfloat16()
    win = full[off // bn:off // bn + nrb]
    for tiles in (blocks, lo):
        name = form("bell_spmv_dot", tiles.dtype)
        before = fc.LAUNCHES[name]
        qk, pk = fc.bell_spmv_dot(tiles, cols, full, off, row_group=R)
        assert fc.LAUNCHES[name] == before + 1
        qk2, pk2 = fc.bell_spmv_dot(tiles, cols, full, off, row_group=R)
        qp, pp = fc._spmv_dot_plain(tiles, cols, full, off, None, None)
        torch.cuda.synchronize()
        _close(qk, qp)
        _dot_close(pk, pp, win, qp)
        assert torch.equal(qk, qk2) and torch.equal(pk, pk2)
    kb, kw = (fc.bell_spmv_dot(t, cols, full, off, row_group=R) for t in (lo, lo.float()))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(kb, kw))
    work = fc.FusedWork.new(dev, maxiter=0)
    out = (torch.full((nrb, bn), 7.0, device=dev), torch.full((1, 1), 7.0, device=dev))
    fc.bell_spmv_dot(lo, cols, full, off, row_group=R, out=out, work=work)
    torch.cuda.synchronize()
    assert all(bool((o == 7).all()) for o in out) and int(work.counter) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nrb,R", SHARD_SHAPES)
@pytest.mark.parametrize("bn", [32, 64, 128, 256])
def test_minres_shard_kernel_staged(dev, bn, nrb, R):
    """Kernel 17 on the staged tile ring, float32 and bf16 tiles, with and
    without the pending update, launched in place as the loop launches it
    (w over w-2, x' over x): w and x' bit-equal to the plain version, q
    within RTOL of max|q|, both dots within RTOL of their sum |a b|; one
    launch counted; the bf16 launch bit-equal to the float32 launch on the
    widened tiles; not live, it writes nothing."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.cuda._common import form

    blocks, cols, full, off = _ring_shard(nrb, bn, dev, seed=3 * bn + nrb)
    lo = blocks.bfloat16()
    win = full[off // bn:off // bn + nrb]
    g = torch.Generator(device=dev).manual_seed(nrb)
    vecs = [torch.randn(nrb, bn, device=dev, generator=g) for _ in range(5)]
    for first in (False, True):
        su = torch.zeros(1, 8, device=dev)
        su[0, fm.SU_SHIFT] = 0.07
        if not first:
            su[0, fm.SU_OLDEPS:fm.SU_PHI + 1] = torch.tensor([0.11, 0.23, 0.57, 0.83])
        for tiles in (blocks, lo):
            name = form("minres_shard_spmv_dot", tiles.dtype)
            pl = fm._shard_plain(tiles, cols, full, tuple(vecs), su, off, None, None)
            r1, vprev, wm1, wm2, x = (v.clone() for v in vecs)
            out = (torch.empty_like(r1), wm2, x, torch.empty(2, device=dev))
            before = fc.LAUNCHES[name]
            k = fm.minres_shard_spmv_dot(tiles, cols, full, r1, vprev, wm1, wm2, x, su, off,
                                         row_group=R, out=out)
            assert fc.LAUNCHES[name] == before + 1
            torch.cuda.synchronize()
            assert torch.equal(k[1], pl[1]) and torch.equal(k[2], pl[2])
            _close(k[0], pl[0])
            _dot_close(k[3], pl[3], win, pl[0])
            _dot_close(k[4], pl[4], win, vecs[0])
        kb, kw = (fm.minres_shard_spmv_dot(t, cols, full, *vecs, su, off, row_group=R)
                  for t in (lo, lo.float()))
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(kb, kw))
    work = fm.MinresWork.new(dev, maxiter=0)
    out = tuple(torch.full_like(vecs[0], 7.0) for _ in range(3)) + (
        torch.full((2,), 7.0, device=dev),)
    fm.minres_shard_spmv_dot(lo, cols, full, *vecs, su, off, row_group=R, out=out, work=work)
    torch.cuda.synchronize()
    assert all(bool((o == 7).all()) for o in out) and int(work.counter) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sharded_kernels_same_bits_at_every_ring_depth(dev, dtype):
    """The ring depth is a measurement knob: kernels 6 and 17 give the same
    bits at 3, 4 and 7 stages as at the default."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    nrb, bn, R = 301, 128, 1
    blocks, cols, full, off = _ring_shard(nrb, bn, dev, seed=13)
    tiles = blocks.to(dtype)
    g = torch.Generator(device=dev).manual_seed(5)
    vecs = [torch.randn(nrb, bn, device=dev, generator=g) for _ in range(5)]
    su = torch.zeros(1, 8, device=dev)
    su[0, fm.SU_SHIFT:fm.SU_PHI + 1] = torch.tensor([0.07, 0.11, 0.23, 0.57, 0.83])

    def both():
        k6 = fc.bell_spmv_dot(tiles, cols, full, off, row_group=R)
        k17 = fm.minres_shard_spmv_dot(tiles, cols, full, *vecs, su, off, row_group=R)
        torch.cuda.synchronize()
        return (*k6, *k17)

    ref = both()
    try:
        for stages in (3, 4, 7):
            fc.set_sharded_ring_stages(stages)
            assert all(torch.equal(u, v) for u, v in zip(both(), ref)), stages
    finally:
        fc.set_sharded_ring_stages(0)


# ---- kernel 11 on two routes: the staged kernel and the register march -----------

STENCIL_DTYPES = [torch.float32, torch.float64, torch.bfloat16]
STENCIL_IDS = ["f32", "f64", "bf16"]
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16}


def _assert_same_bits(got, want):
    """Bit for bit, signed zeros included; NaNs at the same points (their
    payloads are the conversion's, not compared)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits = _BITS[want.dtype]
    assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


def _route_launch(ks, u, c, w, route):
    """One call of kernel 11's wrapper, which must launch ``route``'s kernel
    once and count it there (``_bf16`` on a bf16 volume) and nowhere else."""
    name = route + ("_bf16" if u.dtype == torch.bfloat16 else "")
    before = dict(fc.LAUNCHES)
    y = ks.stencil7(u, c, w)
    torch.cuda.synchronize()
    assert fc.LAUNCHES[name] == before[name] + 1
    assert sum(fc.LAUNCHES.values()) == sum(before.values()) + 1
    return y


def _both_routes(ks, u, c, w, monkeypatch):
    """The wrapper's route (the staged kernel wherever u's rows are 16-byte
    multiples on an aligned base: the size threshold is off here), then the
    register march forced, each against the plain version bit for bit."""
    want = ks._stencil7_plain(u, c, w)
    _assert_same_bits(_route_launch(ks, u, c, w, ks.stencil_route(u)), want)
    with monkeypatch.context() as m:
        m.setattr(ks, "stencil_route", lambda u: "stencil7")
        _assert_same_bits(_route_launch(ks, u, c, w, "stencil7"), want)


@pytest.fixture
def ks_all_staged(monkeypatch):
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    monkeypatch.setattr(ks, "STAGED_MIN_POINTS", dict.fromkeys(STENCIL_DTYPES, 0))
    return ks


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [1, 7, 8, 9, 130, 256, 264])
@pytest.mark.parametrize("dtype", STENCIL_DTYPES, ids=STENCIL_IDS)
def test_stencil7_routes_bit_equal_on_ragged_shapes(dev, dtype, nz, ks_all_staged, monkeypatch):
    """Kernel 11 on every (nx, ny) of {1, 2, 33} x {1, 2, 9}: the staged
    kernel where nz·itemsize is a multiple of 16 (one tile or several
    across z and y), else the register march, and the march forced; each
    bit-equal to the plain version and counted under its own route."""
    ks = ks_all_staged
    g = torch.Generator(device=dev).manual_seed(nz)
    for nx in (1, 2, 33):
        for ny in (1, 2, 9):
            u = torch.randn(nx, ny, nz, device=dev, generator=g).to(dtype)
            staged = (nz * u.element_size()) % 16 == 0
            assert ks.stencil_route(u) == ("stencil7_staged" if staged else "stencil7")
            _both_routes(ks, u, 6.0, -1.0, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 8))
@pytest.mark.parametrize("dtype", STENCIL_DTYPES, ids=STENCIL_IDS)
def test_stencil7_offset_views(dev, dtype, k, ks_all_staged, monkeypatch):
    """u as ``buf[k:k + n].view(shape)``, as a row of a batch reaches the
    kernel: its base is 16-byte aligned only where k·itemsize is, the route
    goes by it, and either kernel gives the plain version's bits."""
    ks = ks_all_staged
    shape = (5, 9, 256)
    n = math.prod(shape)
    g = torch.Generator(device=dev).manual_seed(k)
    buf = torch.randn(n + 8, device=dev, generator=g).to(dtype)
    u = buf[k:k + n].view(shape)
    aligned = (k * u.element_size()) % 16 == 0
    assert ks.stencil_route(u) == ("stencil7_staged" if aligned else "stencil7")
    _both_routes(ks, u, 0.1, -1 / 3, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [8, 64, 264])
def test_stencil7_bf16_special_values(dev, nz, ks_all_staged, monkeypatch):
    """bf16 volumes of normals, subnormals, ±0, values near bf16's largest,
    ±inf and a NaN, with coefficients whose products underflow or overflow
    and a -0 center: both routes bit-equal to the plain version, signed
    zeros included, NaNs at the same points."""
    ks = ks_all_staged
    bf16 = torch.bfloat16
    special = torch.tensor([0.0, -0.0, 2.0 ** -133, -(2.0 ** -133), 3 * 2.0 ** -130, 2.0 ** -126,
                            -(2.0 ** -127), 3.0e38, -3.0e38, 1.0, -1.0], device=dev)
    g = torch.Generator(device=dev).manual_seed(nz)
    shape = (6, 9, nz)
    pick = torch.randint(0, len(special), shape, device=dev, generator=g)
    u = torch.where(torch.rand(shape, device=dev, generator=g) < 0.5, special[pick],
                    torch.randn(shape, device=dev, generator=g)).to(bf16)
    u[2, 4, nz // 2] = float("inf")
    u[4, 0, 0] = float("-inf")
    u[3, 8, nz - 1] = float("nan")
    for c, w in ((6.0, -1.0), (0.1, -1 / 3), (2.0 ** -120, -(2.0 ** -125)), (-0.0, 1.0),
                 (1.0e30, 3.0e8)):
        _both_routes(ks, u, c, w, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STENCIL_DTYPES, ids=STENCIL_IDS)
def test_stencil7_coefficients_bf16_cannot_hold(dev, dtype, ks_all_staged, monkeypatch):
    """Coefficients that bf16 cannot hold (float32 0.1 and -1/3, random
    float32 values): the kernels multiply in float32 (float64 for a float64
    volume) and round each product once, as the plain version does."""
    ks = ks_all_staged
    g = torch.Generator(device=dev).manual_seed(3)
    u = torch.randn(7, 10, 264, device=dev, generator=g).to(dtype)
    pairs = [(0.1, -1 / 3)] + [tuple(float(v) for v in torch.randn(2, generator=g, device=dev))
                               for _ in range(4)]
    for c, w in pairs:
        _both_routes(ks, u, c, w, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STENCIL_DTYPES, ids=STENCIL_IDS)
def test_stencil7_staged_same_bits_at_every_ring_depth(dev, dtype, ks_all_staged,
                                                        monkeypatch):
    """The staged kernel's ring depth and planes a CTA only change the
    time: the same bits at 3, 4 and 6 stages and 1, 2, 5 and 8 planes a
    CTA as at the defaults; a depth the kernel is not built for is refused
    before the launch (cudaErrorInvalidValue), not run."""
    ks = ks_all_staged
    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.randn(40, 33, 264, device=dev, generator=g).to(dtype)
    assert ks.stencil_route(u) == "stencil7_staged"
    ref = ks.stencil7(u, 6.0, -1.0)
    for stages in (3, 4, 6):
        monkeypatch.setattr(ks, "staged_stages", lambda xc, s=stages: s)
        for xchunk in (1, 2, 5, 8):
            monkeypatch.setattr(ks, "STAGED_XCHUNK", (xchunk, xchunk))
            _assert_same_bits(ks.stencil7(u, 6.0, -1.0), ref)
    monkeypatch.setattr(ks, "staged_stages", lambda xc: 5)
    with pytest.raises(RuntimeError, match="cudaError"):
        ks.stencil7(u, 6.0, -1.0)
    _assert_same_bits(ref, ks._stencil7_plain(u, 6.0, -1.0))


# ---- implicit gradients and the row-sharded layouts -----------------------------------

def _cut_tridiag(n, bn=128, seed=5, factor=2.5):
    """The block-tridiagonal tiles with the diagonal tiles cut to ``factor``
    times the coupling tile's spectral radius (host numpy)."""
    blocks, cols, nnz = block_tridiag_tiles(n, bn, bn, seed=seed)
    rho_off = float(np.abs(np.linalg.eigvalsh(blocks[1, 1].astype(np.float64))).max())
    blocks[:, 0] = np.eye(bn, dtype=np.float32) * np.float32(factor * rho_off)
    return blocks, cols, nnz


def _on(op, dev):
    """``op`` with its tensor fields moved to ``dev``."""
    import dataclasses

    return dataclasses.replace(op, **{f.name: getattr(op, f.name).to(dev)
                                      for f in dataclasses.fields(op)
                                      if isinstance(getattr(op, f.name), torch.Tensor)})


def _grads(op, fields, b, c, **kw):
    import dataclasses

    from conjugategradient_tpu_torch import implicit_cg_solve

    leaves = [getattr(op, f).detach().clone().requires_grad_() for f in fields]
    bb = b.clone().requires_grad_()
    x, _ = implicit_cg_solve(dataclasses.replace(op, **dict(zip(fields, leaves))), bb, **kw)
    return torch.autograd.grad(torch.dot(c, x), [bb, *leaves])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["banded", "packed"])
def test_implicit_cg_gradient_through_the_fused_kernels(dev, route):
    """implicit_cg_solve's forward and adjoint run the fused kernels on the
    card (the banded kernel 1 on symmetric block-tridiagonal tiles, the
    packed kernel 4 on poisson2d's sparse tiles, kernel 2 in both); the
    gradients of <c, x> in b and in the stored values match the plain route
    (the same solve on CPU tensors) to 1e-4 in 2-norm."""
    from conjugategradient_tpu_torch import CSRMatrix
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    if route == "banded":
        blocks, cols, nnz = _cut_tridiag(1024)
        op = SymBellMatrix._pack_np(blocks, cols.astype(np.int64), (1024, 1024), (1024, 1024),
                                    nnz, check=False, device="cpu")
        fields, kernel = ("diag_blocks", "off_blocks"), "sym_fused_dir_spmv_dot"
    else:
        rows, cols, vals, shape = poisson2d_coo(40)
        csr = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device="cpu")
        op = BlockedEllMatrix.from_csr(csr, bm=128, bn=128)
        fields, kernel = ("blocks",), "fused_dir_spmv_dot_packed"
    n = op.shape[0]
    rng = np.random.default_rng(7)
    b, c = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32) for _ in range(2))
    tol = 1e-5 * float(b.norm())
    fc.reset_counts()
    g_card = _grads(_on(op, dev), fields, b.to(dev), c.to(dev), tol=tol)
    assert fc.LAUNCHES[kernel] > 0 and fc.LAUNCHES["fused_update_dot"] > 0
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    g_cpu = _grads(op, fields, b, c, tol=tol)
    for u, v in zip(g_card, g_cpu):
        assert u.dtype == v.dtype == torch.float32
        assert float((u.cpu().double() - v.double()).norm() / v.double().norm()) <= 1e-4


@pytest.mark.cuda
def test_implicit_gmres_gradient_through_kernel_7(dev):
    """implicit_gmres_solve on a convection-diffusion DIA operator: kernel 7
    carries the forward steps, the adjoint runs on the plain product's VJP;
    the gradients match the same solve on CPU tensors to 1e-3 in 2-norm,
    and two backward passes give the same bits."""
    import dataclasses

    from conjugategradient_tpu_torch import CSRMatrix, DIAMatrix, implicit_gmres_solve
    from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo

    rows, cols, vals, shape = convection_diffusion_2d_coo(32, peclet=10.0)
    op = DIAMatrix.from_csr(CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32,
                                               device="cpu"))
    n = shape[0]
    rng = np.random.default_rng(8)
    b, c = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32) for _ in range(2))
    kw = dict(tol=1e-5 * float(b.norm()), maxiter=20 * n, restart=32)

    def grads(a, bv, cv, twice=False):
        leaf = a.diags.detach().clone().requires_grad_()
        bb = bv.clone().requires_grad_()
        x, info = implicit_gmres_solve(dataclasses.replace(a, diags=leaf), bb, **kw)
        assert bool(info.converged)
        loss = torch.dot(cv, x)
        g = torch.autograd.grad(loss, [bb, leaf], retain_graph=twice)
        return (g, torch.autograd.grad(loss, [bb, leaf])) if twice else g

    fc.reset_counts()
    g1, g2 = grads(_on(op, dev), b.to(dev), c.to(dev), twice=True)
    assert fc.LAUNCHES["dia_spmv_rows"] > 0
    assert all(torch.equal(u, v) for u, v in zip(g1, g2))
    for u, v in zip(g1, grads(op, b, c)):
        assert float((u.cpu().double() - v.double()).norm() / v.double().norm()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dia", "symbell"])
def test_sharded_layout_matches_one_device(dev, layout):
    """sharded_dia_cg_solve (kernel 7 on each shard's haloed window) and
    sharded_symbell_cg_solve at P = 4 on the card against the one-device
    CG of the same operator to 1e-5 ||b||: iteration counts within one, x
    within 1e-4 of max|x|, two runs bit for bit."""
    import scipy.sparse as sp

    from conjugategradient_tpu_torch import CSRMatrix, DIAMatrix, cg_solve
    from conjugategradient_tpu_torch.parallel import (make_row_mesh, partition_dia_rows,
                                                      partition_symbell_rows,
                                                      sharded_dia_cg_solve,
                                                      sharded_symbell_cg_solve)
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    mesh = make_row_mesh(4, dev)
    if layout == "dia":
        rows, cols, vals, shape = poisson2d_coo(32)
        one = DIAMatrix.from_csr(CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32,
                                                    device=dev))
        diags, n_pad = partition_dia_rows(one.diags.cpu().numpy(), shape, 4)

        def run(bp, tol):
            return sharded_dia_cg_solve(diags, one.offsets, bp, mesh=mesh, tol=tol)

        kernel = "dia_spmv_rows"
    else:
        blocks, bcols, nnz = _cut_tridiag(1024)
        shape = (1024, 1024)
        one = SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), shape, shape, nnz,
                                     check=False, device=dev)
        a = sp.csr_matrix(one.to_dense().cpu().numpy())
        parts = partition_symbell_rows(a.data, a.indices, a.indptr, shape, 4, bn=128)
        n_pad = parts[-1]

        def run(bp, tol):
            return sharded_symbell_cg_solve(*parts[:-1], bp, mesh=mesh, tol=tol)

        kernel = None
    n = shape[0]
    b = torch.as_tensor(np.random.default_rng(9).standard_normal(n), dtype=torch.float32,
                        device=dev)
    bp = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    bp[:n] = b
    tol = 1e-5 * float(b.norm())
    x1, i1 = cg_solve(one, b, tol=tol)
    fc.reset_counts()
    xs, is_ = run(bp, tol)
    if kernel:
        assert fc.LAUNCHES[kernel] >= 4 * int(is_.iterations)
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    assert bool(is_.converged) and abs(int(is_.iterations) - int(i1.iterations)) <= 1
    _close(xs[:n], x1, rtol=1e-4)
    xs2, is2 = run(bp, tol)
    assert torch.equal(xs, xs2)
    assert torch.equal(is_.rho_history.view(torch.int32), is2.rho_history.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bell", "dia"])
def test_sharded_run_cg_through_a_file_is_the_portable_solve(dev, layout, tmp_path):
    """sharded_run_cg (bell: kernel 5 on each shard) and sharded_dia_run_cg
    (kernel 7 on each haloed window) at P = 4, in chunks through a file,
    give the bits of the uninterrupted portable sharded solve
    (use_fused="never") on the card."""
    import scipy.sparse as sp

    from conjugategradient_tpu_torch import CSRMatrix, DIAMatrix
    from conjugategradient_tpu_torch import parallel as tpar
    from conjugategradient_tpu_torch.problems import poisson2d_coo
    from conjugategradient_tpu_torch.solver.checkpoint import load_state, save_state

    rows, cols, vals, shape = poisson2d_coo(64)
    n = shape[0]
    g = tpar.make_row_mesh(4, dev)
    if layout == "bell":
        a = sp.csr_matrix((np.asarray(vals, np.float32), (rows, cols)), shape=shape)
        a.sort_indices()
        blocks, bcols, n_pad = tpar.partition_csr_rows(a.data, a.indices, a.indptr, shape, 4)
        ops = (blocks, bcols)
        solve, init, run = tpar.sharded_cg_solve, tpar.sharded_cg_init, tpar.sharded_run_cg
        kernel = "bell_spmv"
    else:
        one = DIAMatrix.from_csr(CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32,
                                                    device="cpu"))
        diags, n_pad = tpar.partition_dia_rows(one.diags.numpy(), shape, 4)
        ops = (diags, one.offsets)
        solve, init = tpar.sharded_dia_cg_solve, tpar.sharded_dia_cg_init
        run, kernel = tpar.sharded_dia_run_cg, "dia_spmv_rows"
    b = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    b[:n] = torch.as_tensor(np.random.default_rng(3).standard_normal(n), dtype=torch.float32)
    tol = 1e-5 * float(b.norm())
    kw = {"use_fused": "never"} if layout == "bell" else {}
    x_ref, info = solve(*ops, b, mesh=g, tol=tol, **kw)
    fc.reset_counts()
    state = init(*ops, b, mesh=g, maxiter=n_pad + 1)
    while bool(state.live):
        state = run(*ops, state, tol=tol, steps=37, mesh=g)
        save_state(tmp_path / "s.npz", state)
        state = load_state(tmp_path / "s.npz", device=dev)
    assert fc.LAUNCHES[kernel] >= 4 * int(info.iterations)
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    x, done = tpar.sharded_state_result(state)
    assert int(done.iterations) == int(info.iterations) > 37 and bool(done.converged)
    assert torch.equal(x.view(torch.int32), x_ref.view(torch.int32))
    assert torch.equal(done.rho_history.view(torch.int32), info.rho_history.view(torch.int32))


@pytest.mark.cuda
def test_sharded_2d_matches_one_device(dev):
    """sharded_cg_solve_2d at p = 2 (kernel 5 on each block) against the
    one-device CG to 1e-5 ||b||: counts within one, x within 1e-4 of
    max|x|, no all_gather, two runs bit for bit."""
    import scipy.sparse as sp

    from conjugategradient_tpu_torch import CSRMatrix, cg_solve
    from conjugategradient_tpu_torch import parallel as tpar
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    rows, cols, vals, shape = poisson2d_coo(64)
    n = shape[0]
    a = sp.csr_matrix((np.asarray(vals, np.float32), (rows, cols)), shape=shape)
    a.sort_indices()
    blocks, bcols, n_pad = tpar.partition_csr_blocks_2d(a.data, a.indices, a.indptr, shape, 2)
    b = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    b[:n] = torch.as_tensor(np.random.default_rng(4).standard_normal(n), dtype=torch.float32)
    tol = 1e-5 * float(b.norm())
    x1, i1 = cg_solve(CSRMatrix.from_scipy(a, device=dev), b[:n], tol=tol)
    fc.reset_counts()
    g = tpar.make_mesh_2d(2, dev)
    xs, is_ = tpar.sharded_cg_solve_2d(blocks, bcols, b, mesh=g, tol=tol)
    assert fc.LAUNCHES["bell_spmv"] >= 4 * int(is_.iterations)
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    assert g.counts["all_gather"] == 0 and g.counts["transpose"] == g.counts["col_sum"]
    assert bool(is_.converged) and abs(int(is_.iterations) - int(i1.iterations)) <= 1
    _close(xs[:n], x1, rtol=1e-4)
    xs2, is2 = tpar.sharded_cg_solve_2d(blocks, bcols, b, mesh=tpar.make_mesh_2d(2, dev), tol=tol)
    assert torch.equal(xs, xs2)
    assert torch.equal(is_.rho_history.view(torch.int32), is2.rho_history.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(64, 64, 64), (16, 24, 40)])
def test_sharded_stencil_product_is_the_one_device_slice(dev, grid):
    """Each shard's product (kernel 11 on its haloed window) is bit for bit
    the matching slice of the one-device kernel 11 product, across routes:
    at 64^3 the whole volume takes the staged kernel and each (18, 64, 64)
    window the register march; on the small grid both the march."""
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks
    from conjugategradient_tpu_torch.ops.stencil import stencil7_apply
    from conjugategradient_tpu_torch.parallel import make_row_mesh
    from conjugategradient_tpu_torch.parallel.sharded_stencil import _local_stencil_matvec

    u = torch.as_tensor(np.random.default_rng(5).standard_normal(grid), dtype=torch.float32,
                        device=dev)
    fc.reset_counts()
    whole = ks.stencil7(u, 6.0, -1.0)
    P = 4
    sx = grid[0] // P
    g = make_row_mesh(P, dev)
    flat = u.reshape(-1)
    m = flat.numel() // P
    parts = _local_stencil_matvec(g, [flat[i * m:(i + 1) * m] for i in range(P)], 6.0, -1.0,
                                  (sx,) + grid[1:])
    launches = fc.LAUNCHES["stencil7"] + fc.LAUNCHES["stencil7_staged"]
    assert launches == 1 + P
    assert torch.equal(torch.cat(parts).view(torch.int32), whole.reshape(-1).view(torch.int32))
    plain = stencil7_apply(u.cpu(), 6.0, -1.0)
    assert torch.equal(whole.cpu().view(torch.int32), plain.view(torch.int32))


@pytest.mark.cuda
def test_sharded_mg_apply_matches_one_device(dev):
    """The x-slab sharded V-cycle at P = 4 on 64^3 (kernel 11 on every
    sweep's haloed windows, the agglomerated tail on the one-device cycle)
    gives the one-device apply's bits on the card."""
    from conjugategradient_tpu_torch import StencilOperator, multigrid_preconditioner
    from conjugategradient_tpu_torch.parallel import make_row_mesh, sharded_multigrid_preconditioner

    shape = (64, 64, 64)
    r = torch.as_tensor(np.random.default_rng(6).standard_normal(int(np.prod(shape))),
                        dtype=torch.float32, device=dev)
    want = multigrid_preconditioner(StencilOperator.poisson(shape, device=dev))(r)
    pre = sharded_multigrid_preconditioner(shape, 4, dtype=torch.float32, agglomerate_below=4096)
    g = make_row_mesh(4, dev)
    fc.reset_counts()
    m = r.numel() // 4
    got = torch.cat(pre.make_local_apply([], g)([r[i * m:(i + 1) * m] for i in range(4)]))
    assert fc.LAUNCHES["stencil7"] + fc.LAUNCHES["stencil7_staged"] > 0
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["amg", "fsai", "cg"])
def test_sharded_8_wide_tiles_take_packed_kernel_5(dev, case):
    """Float32 shards of 8 x 8 tiles, a width the dense-tile kernel does not
    take, run their products on packed kernel 5 on the card: every level
    of the sharded SA-AMG apply and both FSAI products at P = 4 (against
    the float64 apply on the CPU to float32 accuracy), and a
    ``sharded_cg_solve`` on bn = 8 shards (against the one-device CG); no
    plain version runs on CUDA tensors."""
    import scipy.sparse as sp

    from conjugategradient_tpu_torch import CSRMatrix, cg_solve
    from conjugategradient_tpu_torch import parallel as tpar
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    rows, cols, vals, shape = poisson2d_coo(64)
    n = shape[0]
    a = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    a.sort_indices()
    a32 = a.astype(np.float32)
    blocks, bcols, n_pad = tpar.partition_csr_rows(a32.data, a32.indices, a32.indptr, shape, 4,
                                                   bm=8, bn=8)
    r = np.zeros(n_pad)
    r[:n] = np.random.default_rng(7).standard_normal(n)
    fc.reset_counts()
    if case == "cg":
        b = torch.as_tensor(r, dtype=torch.float32, device=dev)
        tol = 1e-5 * float(b.norm())
        xs, is_ = tpar.sharded_cg_solve(blocks, bcols, b, mesh=tpar.make_row_mesh(4, dev),
                                        tol=tol, use_fused="never")
        assert fc.LAUNCHES["bell_spmv_packed"] >= 4 * int(is_.iterations)
        assert fc.LAUNCHES["bell_pack"] == 4
        x1, i1 = cg_solve(CSRMatrix.from_scipy(a32, device=dev), b[:n], tol=tol)
        assert bool(is_.converged) and abs(int(is_.iterations) - int(i1.iterations)) <= 1
        _close(xs[:n], x1, rtol=1e-4)
    else:
        def build(dtype):
            A = CSRMatrix.from_scipy(a, device="cpu")
            if case == "amg":
                return tpar.sharded_amg_preconditioner(A, 4, n_pad, agglomerate_below=1,
                                                       dtype=dtype)
            return tpar.sharded_fsai_preconditioner(A, 4, n_pad, dtype=dtype)

        def apply(pre, device, dtype):
            g = tpar.make_row_mesh(4, device)
            arrays = [torch.as_tensor(x, device=device) for x in pre.op_arrays]
            rt = torch.as_tensor(r, dtype=dtype, device=device)
            m = n_pad // 4
            return torch.cat(pre.make_local_apply(arrays, g)(
                [rt[i * m:(i + 1) * m] for i in range(4)]))

        got = apply(build(torch.float32), dev, torch.float32)
        assert fc.LAUNCHES["bell_spmv_packed"] > 0 and fc.LAUNCHES["bell_spmv"] == 0
        want = apply(build(torch.float64), "cpu", torch.float64)
        _close(got.cpu().double(), want, rtol=1e-4)
    assert all(v == 0 for v in fc.PLAIN_ON_CUDA.values())
