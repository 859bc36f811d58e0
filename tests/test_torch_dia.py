"""The port's DIA and symmetric-DIA layouts against the JAX package, on the
CPU, from the same numpy inputs.

* Packing, bitwise: ``diags``/``offsets``/``nnz`` of both layouts on every
  file in problems/, with and without RCM; ``choose_layout`` returns the
  same string on every file at (bm, bn) = (8, 128) and (128, 128).
* SpMV against each JAX kernel in interpret mode — ``dia_spmv_pallas`` (7),
  ``dia_spmv_pallas_2d`` (8), ``dia_spmv_pallas_blocked`` (9) and
  ``sym_dia_spmv_pallas_blocked`` (10) — f32, within 1e-5 of max|y| (the
  bound of ``tests/test_symdia.py``: XLA:CPU may fuse a multiply-add pair
  into one FMA where the port rounds twice).  f64 plain forms against the
  JAX XLA path within 1e-12 relative.
* Solves: portable f64 DIA and SymDIA solves (plain CG, Jacobi PCG,
  residual replacement) take the JAX solve's iteration count, with
  ``rho_history`` within 1e-10 relative (under residual replacement with an
  absolute floor of 1e-16·ρ₀, as in ``tests/test_torch_restart.py``), at a
  tolerance above the roundoff floor; f32 solves keep the JAX trajectory
  (rtol 1e-3 over 25 steps).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu import reorder as jreorder
from conjugategradient_tpu.io import loader as jloader
from conjugategradient_tpu.ops import spmv as jspmv
from conjugategradient_tpu.ops.pallas import dia_spmv as jk
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import DIAMatrix as JDIA
from conjugategradient_tpu.types import SymDIAMatrix as JSym
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch.io import loader as tloader
from conjugategradient_tpu_torch.ops import spmv as tspmv
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import dia_spmv as tk
from conjugategradient_tpu_torch.problems import banded_spd_coo, reference_rhs
from conjugategradient_tpu_torch.solver import cg_solve, jacobi_preconditioner
from conjugategradient_tpu_torch.types import CSRMatrix, DIAMatrix, SymDIAMatrix

ROOT = pathlib.Path(__file__).resolve().parents[1]
MTX = sorted((ROOT / "problems").glob("*.mtx"))
SPMV_RTOL = 1e-5
F64_RTOL = 1e-12

# choose_layout on (bm, bn) = (8, 128): the table the port must reproduce
AUTO_PLAIN = {p.name: "sell" if p.name == "powerlaw_1138.mtx" else "dia" for p in MTX}
AUTO_RCM = {p.name: "dia" if p.name == "dense_256.mtx" else "sell" for p in MTX}


@pytest.fixture(scope="module")
def host_csr():
    """Each file's host CSR, as read (False) and RCM-permuted (True)."""
    out = {}
    for p in MTX:
        data, indices, indptr, shape = tloader.read_csr_host(p)
        out[p.name, False] = (data, indices, indptr, shape)
        perm = jreorder.rcm_permutation(indices, indptr, shape[0])
        out[p.name, True] = (*jreorder.permute_csr(data, indices, indptr, shape, perm), shape)
    return out


@pytest.mark.parametrize("rcm", [False, True], ids=["plain", "rcm"])
@pytest.mark.parametrize("path", MTX, ids=lambda p: p.name)
def test_dia_and_symdia_packing_bitwise(path, rcm, host_csr):
    data, indices, indptr, shape = host_csr[path.name, rcm]
    vals = data.astype(np.float32)
    jd = JDIA.from_csr_host(vals, indices, indptr, shape)
    td = DIAMatrix.from_csr_host(vals, indices, indptr, shape, device="cpu")
    assert td.offsets == jd.offsets and td.nnz == jd.nnz and td.shape == tuple(jd.shape)
    assert td.diags.dtype == torch.float32
    assert np.array_equal(td.diags.numpy(), np.asarray(jd.diags))
    assert td.offsets_dev.tolist() == list(jd.offsets)
    try:
        js = JSym.from_dia(jd, check=True)
    except ValueError as e:
        # non-symmetric files (convdiff_34) fail the same check the same way
        with pytest.raises(ValueError) as te:
            SymDIAMatrix.from_dia(td, check=True)
        assert str(te.value) == str(e)
        return
    del jd
    ts = SymDIAMatrix.from_dia(td, check=True)
    del td
    assert ts.offsets == js.offsets and ts.nnz == js.nnz and ts.shape == tuple(js.shape)
    assert np.array_equal(ts.diags.numpy(), np.asarray(js.diags))
    assert ts.full_diag_bytes() == js.full_diag_bytes()


def test_symdia_check_rejects_convdiff():
    path = ROOT / "problems" / "convdiff_34.mtx"
    with pytest.raises(ValueError) as je:
        jloader.load_matrix(path, layout="symdia")
    with pytest.raises(ValueError) as te:
        tloader.load_matrix(path, layout="symdia", device="cpu")
    assert str(te.value) == str(je.value) and "not symmetric" in str(te.value)


@pytest.mark.parametrize("rcm", [False, True], ids=["plain", "rcm"])
@pytest.mark.parametrize("path", MTX, ids=lambda p: p.name)
def test_choose_layout_matches_jax(path, rcm, host_csr):
    _, indices, indptr, shape = host_csr[path.name, rcm]
    for bm, bn in ((8, 128), (128, 128)):
        got = tloader.choose_layout(indices, indptr, shape, bm=bm, bn=bn)
        assert got == jloader.choose_layout(indices, indptr, shape, bm=bm, bn=bn)
    expected = (AUTO_RCM if rcm else AUTO_PLAIN)[path.name]
    assert tloader.choose_layout(indices, indptr, shape) == expected


def _dense_closeness(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=SPMV_RTOL * scale)


def _stencil_scale_sym(rng):
    """The n = 4096, k = 1100 half band of tests/test_symdia.py."""
    n, k = 4096, 1100
    d0 = 4.0 + rng.random(n).astype(np.float32)
    d1 = (0.1 * rng.standard_normal(n)).astype(np.float32)
    d1[n - k:] = 0.0
    return np.stack([d0, d1]), (0, k), n


def _operators():
    """(label, host CSR) of the SpMV shapes."""
    out = []
    for n, bw, seed in ((300, 5, 9), (3000, 9, 5)):
        rows, cols, vals, shape = banded_spd_coo(n, bandwidth=bw, seed=seed)
        c = JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32)
        out.append((f"banded{n}", (np.asarray(c.data), np.asarray(c.indices),
                                   np.asarray(c.indptr), shape)))
    for name in ("poisson2d_34", "dense_256"):
        data, indices, indptr, shape = tloader.read_csr_host(ROOT / "problems" / f"{name}.mtx")
        out.append((name, (data.astype(np.float32), indices, indptr, shape)))
    return out


OPERATORS = _operators()


@pytest.mark.parametrize("label,csr", OPERATORS, ids=[o[0] for o in OPERATORS])
def test_dia_spmv_matches_jax_kernels(label, csr):
    rng = np.random.default_rng(len(label))
    jd = JDIA.from_csr_host(*csr)
    td = DIAMatrix.from_csr_host(*csr, device="cpu")
    x = rng.standard_normal(td.shape[1]).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    y = tk.dia_spmv_diags(td.diags, td.offsets, td.offsets_dev, xt).numpy()
    assert np.array_equal(td.matvec(xt).numpy(), y)
    assert np.array_equal(tspmv.dia_spmv(td, xt, use_kernel="never").numpy(), y)
    n = td.n
    for want in (
        jk.dia_spmv_pallas(jd.diags, jd.offsets, xj, interpret=True, block_len=128),
        jk.dia_spmv_pallas_2d(jd.diags, jd.offsets, xj, interpret=True, block_len=128),
        jk.dia_spmv_pallas_blocked(jd.with_blocked(block_len=128).diags_blocked,
                                   jd.offsets, xj, n=n, interpret=True),
    ):
        _dense_closeness(y, np.asarray(want))
    # the symmetric half of the same operator against kernel 10 (halo'd
    # 1024-blocks, so the banded3000 mirror crosses block boundaries)
    js = JSym.from_dia(jd)
    ts = SymDIAMatrix.from_dia(td)
    blk = js.with_blocked(block_len=1024)
    ys = tk.sym_dia_spmv_diags(ts.diags, ts.offsets, ts.offsets_dev, xt).numpy()
    assert np.array_equal(ts.matvec(xt).numpy(), ys)
    _dense_closeness(ys, np.asarray(jk.sym_dia_spmv_pallas_blocked(
        blk.diags_blocked, blk.offsets, xj, n=n, hw=blk.blocked_halo, interpret=True)))
    _dense_closeness(ys, y)
    assert _common.PLAIN_ON_CUDA["dia_spmv"] == _common.PLAIN_ON_CUDA["sym_dia_spmv"] == 0


def test_sym_dia_spmv_stencil_scale_offsets():
    rng = np.random.default_rng(3)
    diags, offsets, n = _stencil_scale_sym(rng)
    nnz = n + 2 * (n - offsets[1])
    js = JSym(jnp.asarray(diags), offsets, (n, n), nnz)
    ts = convert.sym_dia_from_arrays(diags, offsets, (n, n), nnz, device="cpu")
    x = rng.standard_normal(n).astype(np.float32)
    blk = js.with_blocked(block_len=1024)
    assert blk.blocked_halo >= offsets[1]
    want = jk.sym_dia_spmv_pallas_blocked(blk.diags_blocked, blk.offsets, jnp.asarray(x),
                                          n=n, hw=blk.blocked_halo, interpret=True)
    got = ts.matvec(torch.from_numpy(x)).numpy()
    _dense_closeness(got, np.asarray(want))
    _dense_closeness(got, np.asarray(js.matvec(jnp.asarray(x))))
    # the full layout of the same operator, through kernel 9
    full_offs = (-offsets[1], 0, offsets[1])
    d_neg = np.zeros(n, np.float32)
    d_neg[offsets[1]:] = diags[1][: n - offsets[1]]
    full = np.stack([d_neg, diags[0], diags[1]])
    jd = JDIA(jnp.asarray(full), full_offs, (n, n), nnz)
    td = convert.dia_from_arrays(full, full_offs, (n, n), nnz, device="cpu")
    yd = td.matvec(torch.from_numpy(x)).numpy()
    _dense_closeness(yd, np.asarray(jk.dia_spmv_pallas_blocked(
        jd.with_blocked(block_len=1024).diags_blocked, full_offs, jnp.asarray(x), n=n,
        interpret=True)))
    _dense_closeness(yd, got)


@pytest.mark.parametrize("label,csr", OPERATORS[:3], ids=[o[0] for o in OPERATORS[:3]])
def test_f64_plain_matches_jax_xla_path(label, csr):
    data, indices, indptr, shape = csr
    data = data.astype(np.float64)
    jd = JDIA.from_csr_host(data, indices, indptr, shape)
    td = DIAMatrix.from_csr_host(data, indices, indptr, shape, device="cpu")
    x = np.random.default_rng(1).standard_normal(shape[1])
    y = td.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float64
    want = np.asarray(jspmv.dia_spmv(jd, jnp.asarray(x), use_pallas="never"))
    np.testing.assert_allclose(y.numpy(), want, rtol=F64_RTOL, atol=F64_RTOL * np.abs(want).max())
    ys = SymDIAMatrix.from_dia(td).matvec(torch.from_numpy(x)).numpy()
    want_s = np.asarray(jspmv.sym_dia_spmv(JSym.from_dia(jd), jnp.asarray(x)))
    np.testing.assert_allclose(ys, want_s, rtol=F64_RTOL, atol=F64_RTOL * np.abs(want_s).max())


def test_rectangular_and_negative_only_offsets():
    rng = np.random.default_rng(4)
    n, ncols = 37, 53
    A = np.zeros((n, ncols), np.float32)
    for off in (-5, -1, 3, 20):
        idx = np.arange(n)
        ok = (idx + off >= 0) & (idx + off < ncols)
        A[idx[ok], idx[ok] + off] = rng.standard_normal(ok.sum())
    for M in (A, np.tril(A)):
        rows, cols = np.nonzero(M)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
        csr = (M[rows, cols], cols, indptr, (n, ncols))
        jd = JDIA.from_csr_host(*csr)
        td = DIAMatrix.from_csr_host(*csr, device="cpu")
        x = rng.standard_normal(ncols).astype(np.float32)
        y = td.matvec(torch.from_numpy(x)).numpy()
        _dense_closeness(y, M.astype(np.float64) @ x)
        _dense_closeness(y, np.asarray(jk.dia_spmv_pallas(jd.diags, jd.offsets, jnp.asarray(x),
                                                          interpret=True, block_len=128)))
        np.testing.assert_allclose(td.to_dense().numpy(), M)
        assert td.padding_ratio() == jd.padding_ratio()
        assert td.memory_footprint() == jd.memory_footprint()


def test_nan_in_x_stays_in_its_rows():
    """A column outside the matrix contributes diags · 0, never a read of a
    clamped x: a NaN in x reaches exactly the rows whose band covers it."""
    n = 16
    diags = np.ones((3, n), np.float32)
    diags[0, :1] = 0.0
    diags[2, -1:] = 0.0
    td = convert.dia_from_arrays(diags, (-1, 0, 1), (n, n), 3 * n - 2, device="cpu")
    x = np.ones(n, np.float32)
    x[0] = np.nan
    y = td.matvec(torch.from_numpy(x)).numpy()
    assert np.isnan(y[:2]).all() and np.isfinite(y[2:]).all()


def test_diagonal_needs_offset_zero():
    td = convert.dia_from_arrays(np.ones((1, 4), np.float32), (1,), (4, 4), 3, device="cpu")
    with pytest.raises(ValueError, match="main diagonal"):
        td.diagonal()
    with pytest.raises(ValueError, match="main diagonal"):
        convert.sym_dia_from_arrays(np.ones((1, 4)), (1,), (4, 4), 6, device="cpu").diagonal()
    with pytest.raises(ValueError, match="offsets >= 0"):
        tk.sym_dia_spmv_diags(td.diags, (-1,), td.offsets_dev, torch.ones(4))


def test_wrapper_contract():
    td = convert.dia_from_arrays(np.ones((2, 8), np.float32), (0, 1), (8, 8), 15, device="cpu")
    x = torch.ones(8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.dia_spmv_diags(td.diags.double(), td.offsets, td.offsets_dev, x)
    with pytest.raises(ValueError, match="offsets"):
        tk.dia_spmv_diags(td.diags, (0,), td.offsets_dev, x)
    with pytest.raises(ValueError, match="int32"):
        tk.dia_spmv_diags(td.diags, td.offsets, td.offsets_dev.long(), x)
    with pytest.raises(ValueError, match="1-D float32"):
        tk.dia_spmv_diags(td.diags, td.offsets, td.offsets_dev, x.double())
    with pytest.raises(ValueError, match="use_kernel"):
        tspmv.dia_spmv(td, x, use_kernel="sometimes")
    # bf16 diagonals run the plain version on the CPU, in f32
    yb = tk.dia_spmv_diags(td.diags.bfloat16(), td.offsets, td.offsets_dev, x)
    assert yb.dtype == torch.float32 and torch.equal(yb, td.matvec(x))
    assert torch.equal(td.astype(torch.bfloat16).matvec(x), yb)
    assert td.to("cpu").offsets_dev.device.type == "cpu"


# ---- solves ----------------------------------------------------------------

@pytest.fixture(scope="module")
def poisson_f64():
    """poisson2d_34 as DIA (f64) in both packages, and the reference rhs."""
    path = ROOT / "problems" / "poisson2d_34.mtx"
    jd = jloader.load_matrix(path, layout="dia", dtype=np.float64)
    td = tloader.load_matrix(path, layout="dia", dtype=np.float64, device="cpu")
    return jd, td, reference_rhs(td.n)


def _hist(info, k):
    return np.asarray(info.rho_history, np.float64)[: k + 1]


@pytest.mark.parametrize("storage", ["dia", "symdia"])
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_f64_solve_matches_jax(poisson_f64, storage, precond):
    jd, td, b = poisson_f64
    if storage == "symdia":
        jd, td = JSym.from_dia(jd), SymDIAMatrix.from_dia(td)
    tol = 1e-8 * float(np.linalg.norm(b))
    jM = jcg.jacobi_preconditioner(jd) if precond == "jacobi" else None
    tM = jacobi_preconditioner(td) if precond == "jacobi" else None
    xj, ij = jcg.cg_solve(jd, jnp.asarray(b), tol=tol, M=jM)
    xt, it = cg_solve(td, torch.from_numpy(b), tol=tol, M=tM)
    k = int(ij.iterations)
    assert bool(it.converged) and bool(ij.converged)
    assert int(it.iterations) == k
    np.testing.assert_allclose(_hist(it, k), _hist(ij, k), rtol=1e-10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-9)


def test_f64_recompute_matches_jax(poisson_f64):
    jd, td, b = poisson_f64
    # every restart forms b - Ax, which cancels ~log10(||b|| / ||r||)
    # digits: entries near rho_0·1e-16 are noise, hence the floor (as in
    # tests/test_torch_restart.py)
    tol = 1e-6 * float(np.linalg.norm(b))
    _, ij = jcg.cg_solve(jd, jnp.asarray(b), tol=tol, recompute_r_every=8)
    _, it = cg_solve(td, torch.from_numpy(b), tol=tol, recompute_r_every=8)
    k = int(ij.iterations)
    assert int(it.iterations) == k and k > 8
    h0 = float(ij.rho_history[0])
    np.testing.assert_allclose(_hist(it, k), _hist(ij, k), rtol=1e-10, atol=1e-16 * h0)


@pytest.mark.parametrize("storage", ["dia", "symdia"])
def test_f32_solve_keeps_the_jax_trajectory(storage):
    rows, cols, vals, shape = banded_spd_coo(3000, bandwidth=9, seed=5)
    jc = JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32)
    tc = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device="cpu")
    if storage == "dia":
        jd, td = JDIA.from_csr(jc), DIAMatrix.from_csr(tc)
    else:
        jd, td = JSym.from_csr(jc), SymDIAMatrix.from_csr(tc)
    assert td.device.type == "cpu"
    b = np.random.default_rng(2).standard_normal(shape[0]).astype(np.float32)
    _, ij = jcg.cg_solve(jd, jnp.asarray(b), tol=0.0, maxiter=25)
    _, it = cg_solve(td, torch.from_numpy(b), tol=0.0, maxiter=25)
    assert int(it.iterations) == int(ij.iterations) == 25
    np.testing.assert_allclose(_hist(it, 25), _hist(ij, 25), rtol=1e-3)
