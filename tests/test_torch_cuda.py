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
