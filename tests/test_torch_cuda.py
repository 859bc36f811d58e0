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
    p1 = fb._dir_plain(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, d, None, None)
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
    p2 = fb._s_plain(a.blocks, a.block_cols, r, k1[2], x, k1[1], alpha, d, None, None)
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
