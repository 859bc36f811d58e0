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

import math
import pathlib

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
    with pytest.raises(TypeError, match="not ported"):
        kb.bell_spmv_tiles(a.blocks.bfloat16(), a.block_cols, x2d)


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
        before = fc.LAUNCHES["dia_spmv"]
        yk = kd.dia_spmv_diags(d, offsets, od, x)
        assert fc.LAUNCHES["dia_spmv"] == before + 1
        yp = kd._dia_plain(d, offsets, x)
        torch.cuda.synchronize()
        assert torch.equal(yk, yp), label
        if min(offsets) >= 0 and ncols == d.shape[1]:
            ys = kd.sym_dia_spmv_diags(d, offsets, od, x)
            assert torch.equal(ys, kd._sym_dia_plain(d, offsets, x)), label
    with pytest.raises(TypeError, match="not ported"):
        kd.dia_spmv_diags(d.bfloat16(), offsets, od, x)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil7_kernel_bit_equal_to_plain(dev, dtype):
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    for shape in STENCIL_SHAPES:
        u = torch.randn(shape, dtype=dtype, device=dev)
        before = fc.LAUNCHES["stencil7"]
        yk = ks.stencil7(u, 6.0, -1.0)
        assert fc.LAUNCHES["stencil7"] == before + 1
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
    assert fc.LAUNCHES["stencil7"] > 0
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
    with pytest.raises(TypeError, match="not ported"):
        fm.minres_dir_spmv_dot(a.blocks.bfloat16(), a.block_cols, *vecs, su, d)
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
    within 2 ulp and its control words equal; ω = 0 returns x_h and s."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    g = torch.Generator().manual_seed(n)
    xh, sh, s, t, rhat = (torch.randn(n, generator=g).to(dev) for _ in range(5))
    w = torch.full((1, 1), 0.45, device=dev)
    wk, wp = _bicg_work(dev), _bicg_work(dev)
    k = fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, work=wk)
    p = fb._update_plain(xh, sh, s, t, rhat, w, None, None)
    xc, sc = xh.clone(), s.clone()
    k2 = fb.bicgstab_update_dot(xc, sh, sc, t, rhat, w, out=(xc, sc))
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k2[0], p[0]) and torch.equal(k2[1], p[1])
    for i in (2, 3):
        np.testing.assert_allclose(float(k[i]), float(p[i]), rtol=RTOL,
                                   atol=RTOL * float(p[1].norm() * (p[1] if i == 2 else rhat).norm()))
    fb.finish_update(wp, k[2][0, 0], k[3][0, 0])
    assert _tail_ulps(wk, wp) <= 2 and torch.equal(wk.ctl, wp.ctl) and int(wk.ctl[0]) == 1
    z = fb.bicgstab_update_dot(xh, sh, s, t, rhat, torch.zeros(1, 1, device=dev))
    assert torch.equal(z[0], xh) and torch.equal(z[1], s)


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
    ragged nrb = 13 at a shard offset that is not 0."""
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
    with pytest.raises(TypeError, match="not ported"):
        fc.bell_spmv_dot(blocks.bfloat16(), cols, full, off)
    with pytest.raises(ValueError, match="alias"):
        fc.bell_spmv_dot(blocks, cols, full, off, out=(full[:13], pk))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [32, 64, 128])
@pytest.mark.parametrize("case", ["pending", "first", "jacobi"])
def test_minres_shard_kernel_matches_plain(dev, bn, case):
    """Kernel 17: w and x' bit-equal to the plain version (also written
    over w-2 and x), q to 1e-5 of max|q|, the dots to 1e-5 relative (v·r1
    of ||v|| ||r1||), two launches bit-identical; with a shift, with su = 0
    (a first step: w = 0, x unchanged) and with a Jacobi-scaled v."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    nrb = 13
    blocks, cols, full, off = _shard_operands(dev, nrb, bn, 2, 1, bn + 1)
    rng = np.random.default_rng(bn)
    r1, vprev, wm1, wm2, x = (torch.as_tensor(rng.standard_normal((nrb, bn)),
                                              dtype=torch.float32, device=dev)
                              for _ in range(5))
    if case == "jacobi":
        full = full * (torch.rand_like(full) + 0.5) * 0.31
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
    np.testing.assert_allclose(float(k[3]), float(p[3]), rtol=RTOL)
    np.testing.assert_allclose(float(k[4]), float(p[4]), rtol=0,
                               atol=RTOL * float(full[off // bn:off // bn + nrb].norm() * r1.norm()))
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
