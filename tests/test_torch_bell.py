"""Full-storage blocked-ELL in the port against the JAX package (CPU):
``BlockedEllMatrix`` packing, ``bell_spmv`` and its kernel's plain version,
the full-storage K1 (``fused_dir_spmv_dot``), the full-storage fused CG and
PCG solves, and the RCM reordering.

Same numpy inputs on both sides; the JAX Pallas kernels run in interpret
mode.  Tolerances, with their reasons:

* host packing, ``diagonal``, ``to_dense`` and the reordering: bitwise (the
  same numpy code on the same inputs);
* SpMV and q: max-abs error within ``RTOL = 1e-5`` of max|y| (f32 sums over
  a row's slots in another order);
* p_new: bitwise at β = 0; otherwise within the rounding of the product,
  because XLA:CPU fuses z + β·p_old into one FMA where the port rounds
  twice (the kernel and the plain version are bitwise equal on the card);
* pap: rtol 1e-5 (an f32 dot in another order);
* fused solves: the f32 rule of ROADMAP — ``rho_history`` within rtol 1e-3
  over the first 20 steps (a well-conditioned problem, where f32 order
  differences stay ~1e-6 that early), both converge, iterations within 4,
  x to rtol 1e-4.
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
from conjugategradient_tpu.ops.pallas import ell_spmv as jell
from conjugategradient_tpu.ops.pallas import fused_cg as jfc
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import SymBellMatrix as JSym
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch import reorder as treorder
from conjugategradient_tpu_torch.io import loader as tloader
from conjugategradient_tpu_torch.ops import spmv as tspmv
from conjugategradient_tpu_torch.ops.cuda import bell_spmv as tk5
from conjugategradient_tpu_torch.ops.cuda import fused_cg as tfc
from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import (
    cg_solve,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    fused_supported,
    jacobi_preconditioner,
)
from conjugategradient_tpu_torch.types import BlockedEllMatrix, CSRMatrix, SymBellMatrix

ROOT = pathlib.Path(__file__).resolve().parents[1]
MTX = sorted((ROOT / "problems").glob("*.mtx"))
RTOL = 1e-5
PACK = dict(bm=8, bn=32)  # small tiles keep the largest files' packs small


@pytest.fixture(scope="module")
def parsed():
    return {p.name: tloader.read_csr_host(p) for p in MTX}


def _port(jbell):
    return convert.bell_from_arrays(np.asarray(jbell.blocks), np.asarray(jbell.block_cols),
                                    jbell.shape, jbell.nnz, device="cpu")


def _random_block(rng, nrb, bm, bn, per_row, ncols=None, spd=True):
    """Random block-sparse matrix as dense numpy: SPD (square tiles,
    symmetric, diagonally dominant) or general/rectangular."""
    n = nrb * bm
    m = n if ncols is None else ncols
    A = np.zeros((n, m), np.float32)
    ncb = -(-m // bn)
    for i in range(nrb):
        if spd:
            D = rng.standard_normal((bm, bm)).astype(np.float32)
            A[i * bm:(i + 1) * bm, i * bm:(i + 1) * bm] = D + D.T + 20 * np.eye(bm, dtype=np.float32)
            hi = np.arange(i + 1, nrb)
            for c in rng.choice(hi, size=min(per_row, len(hi)), replace=False):
                B = rng.standard_normal((bm, bm)).astype(np.float32)
                A[i * bm:(i + 1) * bm, c * bm:(c + 1) * bm] = B
                A[c * bm:(c + 1) * bm, i * bm:(i + 1) * bm] = B.T
        else:
            for c in rng.choice(ncb, size=min(per_row, ncb), replace=False):
                blk = rng.standard_normal((bm, bn)).astype(np.float32)
                blk[rng.random((bm, bn)) < 0.5] = 0
                hi = min((c + 1) * bn, m)
                A[i * bm:(i + 1) * bm, c * bn:hi] = blk[:, : hi - c * bn]
    return A


def _jax_bell(A, bm, bn):
    rows, cols = np.nonzero(A)
    csr = JCSR.from_coo(rows, cols, A[rows, cols], A.shape, dtype=A.dtype)
    return JBell.from_csr(csr, bm=bm, bn=bn)


# ---- packing ----------------------------------------------------------------

@pytest.mark.parametrize("path", MTX, ids=lambda p: p.name)
def test_bell_packing_bitwise(path, parsed):
    data, indices, indptr, shape = parsed[path.name]
    jb = JBell.from_csr_host(data, indices, indptr, shape, dtype=np.float32, **PACK)
    tb = BlockedEllMatrix.from_csr_host(data, indices, indptr, shape, dtype=np.float32, **PACK, device="cpu")
    assert np.array_equal(tb.blocks.numpy(), np.asarray(jb.blocks))
    assert np.array_equal(tb.block_cols.numpy(), np.asarray(jb.block_cols))
    assert tb.block_cols.dtype == torch.int32
    assert (tb.shape, tb.nnz, tb.padded_shape) == (tuple(jb.shape), jb.nnz, jb.padded_shape)
    assert (tb.bm, tb.bn, tb.kmax) == (jb.bm, jb.bn, jb.kmax)
    assert np.array_equal(tb.diagonal().numpy(), np.asarray(jb.diagonal()))
    assert tb.memory_footprint() == jb.memory_footprint()
    assert tb.padding_ratio() == jb.padding_ratio()
    if jb.blocks.shape[0] * jb.kmax <= 1000:  # the JAX to_dense loops over tiles
        assert np.array_equal(tb.to_dense().numpy(), np.asarray(jb.to_dense()))


def test_to_dense_diagonal_astype_to():
    rng = np.random.default_rng(4)
    A = _random_block(rng, 6, 8, 8, 2, ncols=70, spd=False)
    jb = _jax_bell(A, 8, 32)
    tb = _port(jb)
    assert tb.padded_shape == (48, 96) and tb.shape == (48, 70)
    assert np.array_equal(tb.to_dense().numpy(), np.asarray(jb.to_dense()))
    assert np.array_equal(tb.to_dense().numpy(), A)
    assert tb.astype(torch.float64).dtype == torch.float64
    assert tb.to("cpu").device.type == "cpu"
    sq = _port(_jax_bell(_random_block(rng, 5, 8, 8, 2), 8, 32))
    assert np.array_equal(sq.diagonal().numpy(), np.diag(sq.to_dense().numpy()))


def test_sym_from_bell_and_csr_match_jax():
    rng = np.random.default_rng(8)
    A = _random_block(rng, 9, 16, 16, 2)
    jb = _jax_bell(A, 16, 16)
    js = JSym.from_bell(jb)
    for ts in (SymBellMatrix.from_bell(_port(jb)),
               SymBellMatrix.from_csr(CSRMatrix.from_coo(*np.nonzero(A), A[np.nonzero(A)],
                                                         A.shape, device="cpu"), bm=16, bn=16)):
        assert np.array_equal(ts.diag_blocks.numpy(), np.asarray(js.diag_blocks))
        assert np.array_equal(ts.off_blocks.numpy(), np.asarray(js.off_blocks))
        assert np.array_equal(ts.off_cols.numpy(), np.asarray(js.off_cols))
        assert (ts.full_kmax, ts.banded) == (js.full_kmax, js.banded)


def test_load_matrix_bell_bitwise():
    path = ROOT / "problems" / "elasticity3d_8.mtx"
    jb = jloader.load_matrix(path, layout="bell", dtype=np.float32, bm=8, bn=128)
    tb = tloader.load_matrix(path, layout="bell", dtype=np.float32, device="cpu")  # bm=8, bn=128
    assert np.array_equal(tb.blocks.numpy(), np.asarray(jb.blocks))
    assert np.array_equal(tb.block_cols.numpy(), np.asarray(jb.block_cols))
    M = jacobi_preconditioner(tb)
    jM = jcg.jacobi_preconditioner(jb)
    assert np.array_equal(M.inv_diag.numpy(), np.asarray(jM.inv_diag))


# ---- SpMV (kernel 5's plain version) ----------------------------------------

SPMV_CASES = [  # (nrb, bm, bn, ncols): bm 8 / 32 / 128, rectangular last
    (16, 8, 32, None), (12, 32, 32, None), (4, 128, 128, None), (16, 8, 128, None),
    (10, 8, 32, 130),
]


@pytest.mark.parametrize("nrb,bm,bn,ncols", SPMV_CASES)
def test_bell_spmv_matches_jax(nrb, bm, bn, ncols):
    rng = np.random.default_rng(nrb * 1000 + bm + bn)
    A = _random_block(rng, nrb, bm, bn, 3, ncols=ncols, spd=False)
    jb = _jax_bell(A, bm, bn)
    tb = _port(jb)
    m = A.shape[1]
    x = rng.standard_normal(m).astype(np.float32)
    xp = np.zeros(tb.padded_shape[1], np.float32)
    xp[:m] = x
    x2d = xp.reshape(-1, bn)
    want_k = np.asarray(jell.bell_spmv_pallas(jb.blocks, jb.block_cols, jnp.asarray(x2d),
                                              interpret=True))
    want_e = np.asarray(jspmv._bell_spmv_jnp(jb.blocks, jb.block_cols, jnp.asarray(x2d)))
    before = dict(tfc.LAUNCHES)
    got_k = tk5.bell_spmv_tiles(tb.blocks, tb.block_cols, torch.from_numpy(x2d)).numpy()
    got = tb.matvec(torch.from_numpy(x)).numpy()
    assert tfc.LAUNCHES == before  # CPU tensors: the plain versions ran
    assert got_k.shape == want_k.shape == (tb.padded_shape[0],) and got.shape == (A.shape[0],)
    scale = np.abs(want_k).max()
    for a, b in ((got_k, want_k), (got_k, want_e), (got, want_e[: A.shape[0]]),
                 (got, A.astype(np.float64) @ x)):
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale)


def test_bell_spmv_dtypes_and_routes():
    rng = np.random.default_rng(3)
    A = _random_block(rng, 6, 8, 8, 2, spd=False)
    tb = _port(_jax_bell(A, 8, 32))
    x = torch.from_numpy(rng.standard_normal(48))  # float64 x, f32 tiles
    y = tb.matvec(x)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), A.astype(np.float64) @ x.numpy(), rtol=1e-12)
    for route in ("never", "always"):
        np.testing.assert_allclose(tspmv.bell_spmv(tb, x.float(), use_kernel=route).numpy(),
                                   A @ x.float().numpy(), rtol=0, atol=1e-5 * 50)
    with pytest.raises(ValueError, match="use_kernel"):
        tspmv.bell_spmv(tb, x, use_kernel="sometimes")
    t64 = tb.astype(torch.float64)
    assert t64.matvec(x).dtype == torch.float64
    with pytest.raises(TypeError, match="float32"):
        tk5.bell_spmv_tiles(t64.blocks, t64.block_cols, torch.zeros(2, 32))
    # bf16 tiles run the plain version on the CPU (f32 accumulate)
    tbf = tb.astype(torch.bfloat16)
    y16 = tk5.bell_spmv_tiles(tbf.blocks, tbf.block_cols, torch.ones(2, 32))
    assert y16.dtype == torch.float32
    with pytest.raises(ValueError, match="x2d"):
        tk5.bell_spmv_tiles(tb.blocks, tb.block_cols, torch.zeros(2, 16))
    with pytest.raises(ValueError, match="block_cols"):
        tk5.bell_spmv_tiles(tb.blocks, tb.block_cols.long(), torch.zeros(2, 32))


# ---- kernel 4's plain version ------------------------------------------------

@pytest.fixture(scope="module")
def square_ops():
    rng = np.random.default_rng(21)
    out = {}
    for nrb, b in ((12, 32), (4, 128)):
        A = _random_block(rng, nrb, b, b, 3)
        jb = _jax_bell(A, b, b)
        out[b] = (A, jb, _port(jb))
    return out


@pytest.mark.parametrize("beta", [0.0, 0.37])
@pytest.mark.parametrize("with_d", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("bn", [32, 128])
def test_fused_dir_spmv_dot_matches_jax(square_ops, bn, with_d, beta):
    A, jb, tb = square_ops[bn]
    rng = np.random.default_rng(bn + int(with_d))
    n = A.shape[0]
    r = rng.standard_normal(n).astype(np.float32).reshape(-1, bn)
    p = rng.standard_normal(n).astype(np.float32).reshape(-1, bn)
    d = (1.0 / np.diag(A)).astype(np.float32).reshape(-1, bn) if with_d else None
    b1 = np.full((1, 1), beta, np.float32)
    jp, jq, jpap = jfc.fused_dir_spmv_dot(
        jb.blocks, jb.block_cols, jnp.asarray(r), jnp.asarray(p), jnp.asarray(b1),
        inv_diag2d=None if d is None else jnp.asarray(d), interpret=True)
    before = dict(tfc.LAUNCHES)
    tp, tq, tpap = tfc.fused_dir_spmv_dot(
        tb.blocks, tb.block_cols, torch.from_numpy(r), torch.from_numpy(p),
        torch.from_numpy(b1), None if d is None else torch.from_numpy(d))
    assert tfc.LAUNCHES == before
    if beta == 0.0:
        assert np.array_equal(tp.numpy(), np.asarray(jp))  # bit for bit
    else:
        # XLA:CPU contracts z + β·p_old into one FMA; the port rounds the
        # product and the sum apart (so that the kernel's gathered rows equal
        # the plain version bit for bit on the card): the two differ by the
        # product's rounding and the sum's, within 2·eps32·(|z| + |β·p_old|)
        z = r if d is None else d * r
        bound = 2 * np.finfo(np.float32).eps * (np.abs(z) + np.abs(beta * p))
        assert np.all(np.abs(tp.numpy().astype(np.float64) - np.asarray(jp)) <= bound)
    assert tq.shape == (tb.nrb, tb.bm)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=RTOL * np.abs(np.asarray(jq)).max())
    assert tpap.shape == (1, 1)
    np.testing.assert_allclose(float(tpap), float(jpap[0, 0]), rtol=RTOL)


def test_fused_dir_wrapper_contract(square_ops):
    _, _, tb = square_ops[32]
    v = torch.zeros(tb.nrb, 32)
    beta = torch.zeros(1, 1)
    with pytest.raises(TypeError, match="float32"):
        tfc.fused_dir_spmv_dot(tb.blocks.double(), tb.block_cols, v, v, beta)
    with pytest.raises(ValueError, match="square tiles"):
        tfc.fused_dir_spmv_dot(tb.blocks[:, :, :16], tb.block_cols, v, v, beta)
    with pytest.raises(ValueError, match="vectors"):
        tfc.fused_dir_spmv_dot(tb.blocks, tb.block_cols, v[:-1], v, beta)
    with pytest.raises(ValueError, match="alias"):
        tfc.fused_dir_spmv_dot(tb.blocks, tb.block_cols, v, v, beta, out=(v, v.clone()))
    with pytest.raises(ValueError, match="row_group"):
        tfc.fused_dir_spmv_dot(tb.blocks, tb.block_cols, v, v, beta, row_group=0)


# ---- the full-storage fused solve --------------------------------------------

@pytest.fixture(scope="module")
def poisson_bell():
    rows, cols, vals, shape = poisson2d_coo(12)
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32), bm=32, bn=32)
    b = reference_rhs(shape[0]).astype(np.float32)
    inv_d = (1.0 / np.asarray(jb.diagonal())).astype(np.float32)
    return jb, _port(jb), b, inv_d


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("path", ["fused", "portable"])
def test_full_storage_solve_matches_jax(poisson_bell, path, precond):
    jb, tb, b, inv_d = poisson_bell
    jd, td = jnp.asarray(inv_d), torch.from_numpy(inv_d)
    tM = jacobi_preconditioner(tb) if precond == "jacobi" else None
    jM = jcg.jacobi_preconditioner(jb) if precond == "jacobi" else None
    if path == "fused":
        def sj(tol, mi):
            if precond == "none":
                return jfused.fused_bell_cg_solve(jb, jnp.asarray(b), tol=tol, maxiter=mi,
                                                  interpret=True)
            return jfused.fused_bell_pcg_solve(jb, jnp.asarray(b), jd, tol=tol, maxiter=mi,
                                               interpret=True)

        def st(tol, mi):
            if precond == "none":
                return fused_bell_cg_solve(tb, torch.from_numpy(b), tol=tol, maxiter=mi)
            return fused_bell_pcg_solve(tb, torch.from_numpy(b), td, tol=tol, maxiter=mi)
    else:
        def sj(tol, mi):
            return jcg.cg_solve(jb, jnp.asarray(b), tol=tol, maxiter=mi, M=jM, fused="never")

        def st(tol, mi):
            return cg_solve(tb, torch.from_numpy(b), tol=tol, maxiter=mi, M=tM, fused="never")
    _, ij = sj(0.0, 20)
    _, it = st(0.0, 20)
    np.testing.assert_allclose(it.rho_history[1:21].double().numpy(),
                               np.asarray(ij.rho_history[1:21], np.float64), rtol=1e-3)
    xj, ij = sj(1e-3, 400)
    xt, it = st(1e-3, 400)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 4
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(xj)).max())


def test_full_storage_dispatch_and_warm_start(poisson_bell):
    _, tb, b, _ = poisson_bell
    assert not fused_supported(tb)  # CPU tensors: the fused path needs CUDA
    rect = BlockedEllMatrix.from_csr_host(*_csr_arrays(), bm=8, bn=32, device="cpu")
    assert not fused_supported(rect)
    with pytest.raises(ValueError, match="BlockedEllMatrix or SymBellMatrix"):
        cg_solve(tb, torch.from_numpy(b), fused="always")
    # x0 at the solution: r0 = b - A x0 goes through bell_spmv, rho0 == 0
    x0 = torch.ones(tb.n)
    bb = tb.matvec(x0)
    x, info = fused_bell_cg_solve(tb, bb, x0, tol=0.0, maxiter=5)
    assert torch.equal(x, x0) and int(info.iterations) == 1


def _csr_arrays():
    rows, cols, vals, shape = poisson2d_coo(6)
    A = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device="cpu")
    return A.data.numpy(), A.indices.numpy(), A.indptr.numpy(), shape


# ---- reordering --------------------------------------------------------------

@pytest.mark.parametrize("path", MTX, ids=lambda p: p.name)
def test_reorder_bitwise(path, parsed):
    data, indices, indptr, shape = parsed[path.name]
    n = shape[0]
    jp = jreorder.rcm_permutation(indices, indptr, n)
    tp = treorder.rcm_permutation(indices, indptr, n)
    assert tp.dtype == jp.dtype and np.array_equal(tp, jp)
    for a, b in zip(treorder.permute_csr(data, indices, indptr, shape, tp),
                    jreorder.permute_csr(data, indices, indptr, shape, jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert treorder.count_diagonals(indices, indptr) == jreorder.count_diagonals(indices, indptr)
    assert treorder.bandwidth(indices, indptr) == jreorder.bandwidth(indices, indptr)
    assert np.array_equal(treorder.degree_sort_permutation(indices, indptr, n),
                          jreorder.degree_sort_permutation(indices, indptr, n))


def test_load_matrix_reorder_returns_jax_perm():
    path = ROOT / "problems" / "powerlaw_1138.mtx"
    jop, jperm = jloader.load_matrix(path, layout="bell", dtype=np.float32, bm=8, bn=32,
                                     reorder=True)
    top, tperm = tloader.load_matrix(path, layout="bell", dtype=np.float32, bm=8, bn=32,
                                     reorder=True, device="cpu")
    assert np.array_equal(tperm, jperm)
    assert np.array_equal(top.blocks.numpy(), np.asarray(jop.blocks))
    assert np.array_equal(top.block_cols.numpy(), np.asarray(jop.block_cols))
    csr, perm = tloader.load_matrix(path, layout="csr", dtype=np.float64, reorder=True, device="cpu")
    assert np.array_equal(perm, jperm) and csr.shape == (1138, 1138)
    # sell composes the degree sort on top of RCM, as the JAX loader does
    jsell, jsperm = jloader.load_matrix(path, layout="sell", dtype=np.float32, reorder=True)
    tsell, tsperm = tloader.load_matrix(path, layout="sell", dtype=np.float32, reorder=True,
                                        device="cpu")
    assert np.array_equal(tsperm, jsperm) and not np.array_equal(tsperm, jperm)
    assert tsell.pos_identity and jsell.pos_identity


def test_permute_vector_roundtrip():
    perm = np.random.default_rng(0).permutation(50)
    v = torch.arange(50, dtype=torch.float64)
    pv = treorder.permute_vector(v, perm)
    assert np.array_equal(pv.numpy(), jreorder.permute_vector(v.numpy(), perm))
    back = treorder.unpermute_vector(pv, perm)
    assert torch.equal(back, v)
    assert np.array_equal(back.numpy(), jreorder.unpermute_vector(pv.numpy(), perm))
