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


# ---- kernel 10's tiling (ops/cuda/dia_spmv.sym_dia_tiling) -----------------

@pytest.mark.parametrize("label,offsets,n,want,pays", [
    # symdia-big: 21 offsets k * 1024, pitch 1024 (k moves k planes), 20
    # halo planes, 32 column tiles x 32 plane tiles
    ("symdia-big", tuple(k * 1024 for k in range(21)), 1 << 21, (1024, 20, 1024), True),
    # poisson3d_48: gcd 1, contiguous rows (pitch 32), 2304 = 72 planes:
    # a halo beyond the tile and a 54-CTA grid, so sym_dia_spmv runs it
    ("poisson3d_48", (0, 1, 48, 2304), 110592, (32, 72, 54), False),
    ("0,3,300 at n=1001", (0, 3, 300), 1001, (32, 10, 1), False),
    # offsets >= n move nothing: only 5 counts (a 1-plane halo)
    ("offsets past n", (0, 5, 1000, 2000), 1000, (32, 1, 1), False),
    ("one diagonal", (0,), 1 << 20, (32, 0, 512), True),
    ("pitch 96: gcd a multiple of 32", (0, 96, 192), 96 * 64 * 50, (96, 2, 150), True),
    ("gcd 48 is not: contiguous rows", (0, 48, 96), 1 << 20, (32, 3, 512), True),
])
def test_sym_dia_tiling_choice(label, offsets, n, want, pays):
    t = tk.sym_dia_tiling(offsets, n)
    assert (t.pitch, t.halo, t.ctas(n)) == want, label
    assert t.pays(n) == pays, label
    # x over the tile and both halos, then a ring of diagonal stages over the
    # tile and the halo before it, then the offsets and their shifts: each
    # dtype's launch fits in float32 stages (a bf16 operator that is not
    # 16-byte aligned widens into them)
    nd = len(offsets)
    assert t.planes == tk.TILE_PLANES in tk.TILE_PLANE_CHOICES
    for dtype, (planes, stages) in tk.TILE_GEOMETRY.items():
        lt, ls = tk.launch_tiling(t, dtype)
        assert (lt.pitch, lt.halo, lt.planes, ls) == (t.pitch, t.halo, planes, stages)
        assert planes in tk.TILE_PLANE_CHOICES and 2 <= stages <= tk.MAX_TILE_STAGES
        assert lt.smem_bytes(stages, 4, nd) == tk.TILE_COLS * (
            4 * (planes + 2 * t.halo) + 4 * stages * (planes + t.halo)) + 8 * nd
        assert lt.smem_bytes(stages, 4, nd) <= tk.MAX_TILE_SMEM
    # pure Python on (offsets, n): the same answer for a list of numpy ints
    assert tk.sym_dia_tiling(tuple(np.int64(o) for o in offsets), n) == t


def test_sym_dia_tiling_refuses_a_halo_beyond_shared_memory():
    """An offset that no pitch divides and that lies farther than shared
    memory reaches (a thin 2-D grid of 20000-point rows) has no tiling; a
    wide pitch keeps a far offset a few planes away."""
    assert tk.sym_dia_tiling((0, 1, 20000), 64 * 20000) is None
    far = tk.sym_dia_tiling((0, 32 * 1000), 32 * 1000 * 200)
    assert far == tk.SymDiaTiling(32000, 1)


def test_sym_dia_route_by_shape_on_the_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper runs the plain version whatever the
    tiling, and counts no launch."""
    rng = np.random.default_rng(9)
    for offsets, n in (((0, 1, 48, 2304), 5000), (tuple(k * 64 for k in range(4)), 64 * 300)):
        d = torch.from_numpy(rng.standard_normal((len(offsets), n)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        od = torch.tensor(offsets, dtype=torch.int32)
        before = dict(_common.LAUNCHES)
        y = tk.sym_dia_spmv_diags(d, offsets, od, x)
        assert _common.LAUNCHES == before
        assert torch.equal(y, tspmv.sym_dia_apply(d, offsets, x))


# ---- kernel 10's route (ops/cuda/dia_spmv.sym_dia_route) --------------------

POS27 = (0, 1, 47, 48, 49, 2255, 2256, 2257, 2303, 2304, 2305, 2351, 2352, 2353)


# the cases whose bf16 route differs from float32's: each dtype's tiling is
# judged at the tile height it launches (TILE_GEOMETRY), and bf16's
# 128-plane tiles give half the 64-plane grid's CTAs, so a grid of
# MIN_TILE_CTAS to twice it tiles in float32 only
BF16_ROUTES = {
    "40 offsets that tile": "sym_dia_spmv",  # 256 CTAs, 128 at bf16's height
    "one diagonal, 200 CTAs": "sym_dia_spmv_rows",
    "0,1,40 at 140 CTAs": "sym_dia_spmv_rows",
    "one diagonal, 262 CTAs": "sym_dia_spmv_rows",  # 131 at bf16's height
}


@pytest.mark.parametrize("label,offsets,n,want", [
    # symdia-big: its tiling pays (1,024 CTAs, a 20-plane halo; 512 in bf16)
    ("symdia-big", tuple(k * 1024 for k in range(21)), 1 << 21, "sym_dia_spmv_tiled"),
    # poisson3d_48: the tiling does not pay (54 CTAs, 72 halo planes); its
    # 4 stored offsets go by value
    ("poisson3d_48", (0, 1, 48, 2304), 110592, "sym_dia_spmv_rows"),
    ("poisson3d_48 ragged", (0, 1, 48, 2304), 110591, "sym_dia_spmv_rows"),
    ("27-point half band", POS27, 110592, "sym_dia_spmv_rows"),
    ("0,3,300 at n=1001", (0, 3, 300), 1001, "sym_dia_spmv_rows"),
    ("offsets past n", (0, 5, 2000), 1000, "sym_dia_spmv_rows"),
    ("dense_256", tuple(range(256)), 256, "sym_dia_spmv"),
    ("at the cap", tuple(range(32)), 4096, "sym_dia_spmv_rows"),
    ("above the cap", tuple(range(33)), 4096, "sym_dia_spmv"),
    # the tiled kernel takes a band that tiles, whatever its count
    ("40 offsets that tile", tuple(k * 64 for k in range(40)), 64 * 8192, "sym_dia_spmv_tiled"),
    ("no tiling fits", (0, 1, 20000), 40000, "sym_dia_spmv_rows"),
    ("one diagonal, small", (0,), 777, "sym_dia_spmv_rows"),
    ("one diagonal, large", (0,), 1 << 20, "sym_dia_spmv_tiled"),
    # between MIN_TILE_CTAS and twice it only float32 tiles (BF16_ROUTES)
    ("one diagonal, 200 CTAs", (0,), 32 * 64 * 200, "sym_dia_spmv_tiled"),
    ("0,1,40 at 140 CTAs", (0, 1, 40), 32 * 64 * 140, "sym_dia_spmv_tiled"),
    ("one diagonal, 264 CTAs", (0,), 32 * 64 * 264, "sym_dia_spmv_tiled"),
    ("one diagonal, 262 CTAs", (0,), 32 * 64 * 262, "sym_dia_spmv_tiled"),
])
def test_sym_dia_route_choice(label, offsets, n, want):
    want32, want16 = want, BF16_ROUTES.get(label, want)
    assert tk.sym_dia_route(offsets, n) == want32, label
    assert tk.sym_dia_route(offsets, n, torch.float32) == want32, label
    assert tk.sym_dia_route(offsets, n, torch.bfloat16) == want16, label
    # pure Python on (offsets, n): the same answer for numpy ints
    assert tk.sym_dia_route(tuple(np.int64(o) for o in offsets), int(np.int64(n))) == want32
    tiling = tk.sym_dia_tiling(offsets, n)
    for dtype, w in ((torch.float32, want32), (torch.bfloat16, want16)):
        pays = tiling is not None and tk.launch_tiling(tiling, dtype)[0].pays(n)
        assert (w == "sym_dia_spmv_tiled") == pays, (label, dtype)
        if w != "sym_dia_spmv_tiled":
            assert (w == "sym_dia_spmv_rows") == (len(offsets) <= tk.MAX_PARAM_DIAGS), label
    # float32 launches the route's own 64-plane tiling
    assert (want32 == "sym_dia_spmv_tiled") == (tiling is not None and tiling.pays(n)), label


# each symmetric file's stored offsets as SymDIA (the convection-diffusion
# operator is not symmetric), and the kernel its route takes: none is large
# enough for the tiled kernel
SYM_FILE_ROUTES = {
    "bcsstk17_profile.mtx": (35, "sym_dia_spmv"),
    "dense_256.mtx": (256, "sym_dia_spmv"),
    "elasticity3d_16.mtx": (50, "sym_dia_spmv"),
    "elasticity3d_8.mtx": (50, "sym_dia_spmv"),
    "poisson2d_110.mtx": (3, "sym_dia_spmv_rows"),
    "poisson2d_34.mtx": (3, "sym_dia_spmv_rows"),
    "poisson3d_48.mtx": (4, "sym_dia_spmv_rows"),
    "powerlaw_1138.mtx": (850, "sym_dia_spmv"),
}


@pytest.mark.parametrize("name", sorted(SYM_FILE_ROUTES))
def test_sym_dia_route_on_the_problem_files(name, host_csr):
    data, indices, indptr, shape = host_csr[name, False]
    d = DIAMatrix.from_csr_host(data.astype(np.float32), indices, indptr, shape, device="cpu")
    s = SymDIAMatrix.from_dia(d, check=True)
    assert (s.ndiag, tk.sym_dia_route(s.offsets, s.n)) == SYM_FILE_ROUTES[name]
    # a bf16 operator of the same shape takes the same kernel (none tiles)
    lo = s.astype(torch.bfloat16)
    assert tk.sym_dia_route(lo.offsets, s.n, lo.diags.dtype) == SYM_FILE_ROUTES[name][1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("label,offsets,n", [
    ("by value", (0, 1, 48, 2304), 5000),
    ("by value, offsets past n", (0, 5, 2000), 1000),
    ("one thread a row", tuple(range(33)), 2000),
])
def test_sym_dia_routes_on_the_cpu_run_the_plain_version(dtype, label, offsets, n):
    """On CPU tensors the wrapper runs ``sym_dia_apply`` on the widened
    diagonals whichever kernel the route names, and counts no launch."""
    rng = np.random.default_rng(n + len(offsets))
    d = torch.from_numpy(rng.standard_normal((len(offsets), n)).astype(np.float32)).to(dtype)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x[n // 3] = float("nan")
    od = torch.tensor(offsets, dtype=torch.int32)
    launches, plain = dict(_common.LAUNCHES), dict(_common.PLAIN_ON_CUDA)
    y = tk.sym_dia_spmv_diags(d, offsets, od, x)
    assert _common.LAUNCHES == launches and _common.PLAIN_ON_CUDA == plain
    assert {"sym_dia_spmv_rows", "sym_dia_spmv_rows_bf16"} <= set(_common.LAUNCHES)
    want = tspmv.sym_dia_apply(d.float(), offsets, x)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32)), label


# ---- kernel 7's route (ops/cuda/dia_spmv.dia_route) ------------------------

O27 = tuple(sorted(i + 48 * j + 2304 * k for i in (-1, 0, 1) for j in (-1, 0, 1)
                   for k in (-1, 0, 1)))


@pytest.mark.parametrize("label,offsets,want", [
    # poisson3d_48 as --layout auto loads it: 7 diagonals, the by-value kernel
    ("poisson3d_48", (-2304, -48, -1, 0, 1, 48, 2304), "dia_spmv_rows"),
    # symdia-big in full storage: 41 diagonals, one thread a row
    ("symdia-big", tuple(k * 1024 for k in range(-20, 21)), "dia_spmv"),
    ("dense_256", tuple(range(-255, 256)), "dia_spmv"),
    ("27-point stencil", O27, "dia_spmv_rows"),
    ("at the cap", tuple(range(32)), "dia_spmv_rows"),
    ("above the cap", tuple(range(33)), "dia_spmv"),
    # the shape does not enter: a ragged n (1001), a rectangular operator
    # (1001 x 1300) and misaligned operands take the by-value kernel, which
    # handles them itself (test_dia_route_on_the_cpu_runs_the_plain_version
    # and the card tests drive them)
    ("n % 4 != 0", (-1, 0, 1), "dia_spmv_rows"),
    ("rectangular 1001 x 1300", (-7, 0, 5, 299), "dia_spmv_rows"),
    ("negative offsets only", (-300, -3, -1), "dia_spmv_rows"),
    ("no diagonal", (), "dia_spmv_rows"),
])
def test_dia_route_choice(label, offsets, want):
    assert tk.dia_route(offsets) == want, label
    # pure Python on the offsets: the same answer for numpy ints
    assert tk.dia_route(tuple(np.int64(o) for o in offsets)) == want, label
    assert (len(offsets) <= tk.MAX_PARAM_DIAGS) == (want == "dia_spmv_rows")


def test_dia_route_on_the_problem_files(host_csr):
    """Every file ``choose_layout`` stores as DIA: the stencils and the
    convection-diffusion operator (5 or 7 diagonals) take the by-value
    kernel, the wide bands (bcsstk17 69, elasticity 99, dense_256 511)
    one thread a row."""
    wide = {"bcsstk17_profile.mtx", "elasticity3d_16.mtx", "elasticity3d_8.mtx",
            "dense_256.mtx"}
    for p in MTX:
        if AUTO_PLAIN[p.name] != "dia":
            continue
        data, indices, indptr, shape = host_csr[p.name, False]
        d = DIAMatrix.from_csr_host(data.astype(np.float32), indices, indptr, shape, device="cpu")
        want = "dia_spmv" if p.name in wide else "dia_spmv_rows"
        assert tk.dia_route(d.offsets) == want, (p.name, d.ndiag)


def test_host_offsets_are_made_once_per_tuple():
    offsets = (-2304, -48, -1, 0, 1, 48, 2304)
    buf = tk.host_offsets(offsets)
    assert list(buf) == list(offsets) and len(buf) == len(offsets)
    # an equal tuple built anew, or of numpy ints, finds the same buffer
    assert tk.host_offsets(tuple(list(offsets))) is buf
    assert tk.host_offsets(tuple(np.int32(o) for o in offsets)) is buf
    assert tk.host_offsets((0, 1)) is not buf and list(tk.host_offsets((0, 1))) == [0, 1]


@pytest.mark.parametrize("ndiag", [7, 32, 33])
@pytest.mark.parametrize("n,ncols,xshift", [(1001, 1001, 0), (1001, 1300, 1), (110592, 110592, 1)])
def test_dia_route_on_the_cpu_runs_the_plain_version(ndiag, n, ncols, xshift):
    """On CPU tensors the wrapper runs ``dia_apply`` whichever kernel the
    route names (x a view at offset 1 too), and counts no launch."""
    rng = np.random.default_rng(ndiag + n)
    offsets = tuple(int(o) for o in rng.choice(np.arange(-n - 3, ncols + 3), ndiag,
                                               replace=False))
    d = torch.from_numpy(rng.standard_normal((ndiag, n)).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal(ncols + 1).astype(np.float32))
    x = xb[xshift:xshift + ncols]
    od = torch.tensor(offsets, dtype=torch.int32)
    launches, plain = dict(_common.LAUNCHES), dict(_common.PLAIN_ON_CUDA)
    y = tk.dia_spmv_diags(d, offsets, od, x)
    assert _common.LAUNCHES == launches and _common.PLAIN_ON_CUDA == plain
    assert "dia_spmv_rows" in _common.LAUNCHES
    assert torch.equal(y, tspmv.dia_apply(d, offsets, x))


# ---- kernel 7's bfloat16 form (diagonals in bf16, x and y float32) ----------

@pytest.mark.parametrize("label,csr", OPERATORS, ids=[o[0] for o in OPERATORS])
def test_dia_spmv_bf16_diagonals_match_jax_kernel(label, csr):
    """The plain version of kernel 7's bf16 form (diagonals widened to
    float32 first) against the Pallas kernel in interpret mode on the same
    bf16 diagonals and float32 x, to the float32 cases' tolerance; the
    result is float32, the promoted dtype; astype(bfloat16) gives the JAX
    diagonals' bits and shares the offsets."""
    rng = np.random.default_rng(len(label) + 1)
    jd = JDIA.from_csr_host(*csr).astype(jnp.bfloat16)
    td32 = DIAMatrix.from_csr_host(*csr, device="cpu")
    td = td32.astype(torch.bfloat16)
    assert td.offsets_dev is td32.offsets_dev and td.offsets == jd.offsets
    assert np.array_equal(td.diags.float().numpy(), np.asarray(jd.diags.astype(jnp.float32)))
    x = rng.standard_normal(td.shape[1]).astype(np.float32)
    xt = torch.from_numpy(x)
    y = tk.dia_spmv_diags(td.diags, td.offsets, td.offsets_dev, xt)
    assert y.dtype == torch.float32
    assert torch.equal(td.matvec(xt), y)
    assert torch.equal(tk.dia_spmv_diags(td.diags.float(), td.offsets, td.offsets_dev, xt), y)
    want = jk.dia_spmv_pallas(jd.diags, jd.offsets, jnp.asarray(x), interpret=True,
                              block_len=128)
    assert want.dtype == jnp.float32
    _dense_closeness(y.numpy(), np.asarray(want))
