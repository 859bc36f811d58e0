"""The port's preconditioners (``solver/precond.py``: identity,
block-Jacobi, the spectral-bound estimate and Chebyshev) against the JAX
package's, on the same numpy inputs (CPU).

Tolerances, with their reasons: the diagonal blocks are extracted on the
host in float64 by the same numpy code, so they are equal bit for bit.  The
block-Jacobi apply agrees to 1e-12 of max|y| in float64 (products summed in
another order; XLA fuses multiply-adds) and to 1e-5 of max|y| in float32
(the DIA bound of the port's tests).  Chebyshev applies agree to 1e-12
relative, the Lanczos interval to 1e-8 relative.  Preconditioned CG in
float64 takes the same number of iterations as the JAX package at a
tolerance of 1e-8 ‖b‖ (not at the roundoff floor: ROADMAP queue 3 on
``tests/test_deflated.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
import conjugategradient_tpu.solver.precond as jp
import conjugategradient_tpu.types as jt
import conjugategradient_tpu_torch.solver.precond as tp
import conjugategradient_tpu_torch.types as tt
from conjugategradient_tpu_torch import cg_solve, jacobi_preconditioner
from conjugategradient_tpu_torch.problems import poisson2d_coo

CPU = "cpu"


def _poisson(nx):
    rows, cols, vals, shape = poisson2d_coo(nx)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


@pytest.fixture(scope="module")
def p24():
    return _poisson(24)


def _csr_pair(a, dtype=np.float64):
    return jt.CSRMatrix.from_scipy(a, dtype=dtype), tt.CSRMatrix.from_scipy(a, dtype=dtype,
                                                                            device=CPU)


def _layouts(a):
    """The same matrix in each layout block-Jacobi takes, in both packages."""
    a = a.tocsr()
    d, i, p, s = a.data, a.indices, a.indptr, a.shape
    return {
        "csr": _csr_pair(a),
        "sell": (jt.SellMatrix.from_csr_host(d, i, p, s),
                 tt.SellMatrix.from_csr_host(d, i, p, s, device=CPU)),
        "dia": (jt.DIAMatrix.from_csr_host(d, i, p, s),
                tt.DIAMatrix.from_csr_host(d, i, p, s, device=CPU)),
        "dense": (jt.DenseOperator(jnp.asarray(a.toarray())),
                  tt.DenseOperator(torch.from_numpy(a.toarray()))),
    }


def test_identity():
    r = torch.arange(5.0)
    assert tp.identity_preconditioner()(r) is r


def test_block_size_one_is_jacobi(p24):
    _, ta = _csr_pair(p24)
    M = tp.block_jacobi_preconditioner(ta, block_size=1)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(p24.shape[0]))
    assert torch.equal(M(r), jacobi_preconditioner(ta)(r))
    assert torch.equal(M.inv_diag, jacobi_preconditioner(ta).inv_diag)
    with pytest.raises(ValueError, match="block_size must be >= 1"):
        tp.block_jacobi_preconditioner(ta, block_size=0)


@pytest.mark.parametrize("layout", ["csr", "sell", "dia", "dense"])
@pytest.mark.parametrize("b", [3, 8, 20])
def test_diagonal_blocks_equal_jax(p24, layout, b):
    """Extraction parity: the same float64 host blocks from each layout."""
    a = p24.copy()
    a.data = a.data * (1.0 + 0.01 * np.arange(a.nnz))  # distinct entries, still symmetric-free
    ja, ta = _layouts(a)[layout]
    np.testing.assert_array_equal(tp._diagonal_blocks_host(ta, b), jp._diagonal_blocks_host(ja, b))


@pytest.mark.parametrize("b", [3, 8, 20])
def test_diagonal_blocks_of_the_stencil_equal_jax(b):
    grid = (5, 4, 6)
    ja = jt.StencilOperator.poisson(grid, dtype=jnp.float64)
    ta = tt.StencilOperator.poisson(grid, dtype=torch.float64, device=CPU)
    np.testing.assert_array_equal(tp._diagonal_blocks_host(ta, b), jp._diagonal_blocks_host(ja, b))


def test_blocked_ell_is_refused(p24):
    ta = tt.BlockedEllMatrix.from_csr(_csr_pair(p24)[1], bm=8, bn=8)
    with pytest.raises(TypeError, match="cannot extract diagonal blocks from BlockedEllMatrix"):
        tp.block_jacobi_preconditioner(ta, 4)


@pytest.mark.parametrize("layout", ["csr", "dia"])
@pytest.mark.parametrize("b", [3, 8, 20])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_block_jacobi_apply_matches_jax(p24, layout, b, dtype):
    a = p24.copy()
    a.data = a.data * (1.0 + 0.01 * np.arange(a.nnz))
    ja, ta = _layouts(a.astype(dtype))[layout]
    Mj, Mt = jp.block_jacobi_preconditioner(ja, b), tp.block_jacobi_preconditioner(ta, b)
    assert Mt.block_size == b
    np.testing.assert_array_equal(np.asarray(Mt.inv_blocks), np.asarray(Mj.inv_blocks))
    r = np.random.default_rng(b).standard_normal(a.shape[0]).astype(dtype)
    yj, yt = np.asarray(Mj(jnp.asarray(r))), Mt(torch.from_numpy(r)).numpy()
    assert yt.dtype == yj.dtype == dtype
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(yt, yj, rtol=0, atol=tol * np.abs(yj).max())


def test_block_jacobi_dia_form_has_2b_minus_1_diagonals(p24):
    """b <= 16 applies as a DIA product (kernel 7 on the card): a ragged
    last block (576 = 7 * 82 + 2) included."""
    _, ta = _csr_pair(p24, np.float32)
    M = tp.block_jacobi_preconditioner(ta, 7)
    blocks = M.inv_blocks
    n = p24.shape[0]
    dense = np.zeros((n, n))
    for i in range(blocks.shape[0]):
        lo, hi = 7 * i, min(7 * i + 7, n)
        dense[lo:hi, lo:hi] = blocks[i, : hi - lo, : hi - lo]
    r = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = M(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(y, dense @ r, rtol=0, atol=1e-5 * np.abs(y).max())


def test_estimate_spectral_bounds_matches_jax(p24):
    """The interval ROADMAP queue 3 records on poisson2d(24) at iters=40:
    [0.0079, 8.77] against the true [0.0315, 7.97], kept as it is."""
    ja, ta = _csr_pair(p24)
    for kw in (dict(iters=40), dict(), dict(iters=12, seed=3, safety=1.0, min_margin=1.0)):
        lj, hj = jp.estimate_spectral_bounds(ja, **kw)
        lt, ht = tp.estimate_spectral_bounds(ta, **kw)
        np.testing.assert_allclose([lt, ht], [lj, hj], rtol=1e-8)
    lt, ht = tp.estimate_spectral_bounds(ta, iters=40)
    assert abs(lt - 0.0079) < 1e-4 and abs(ht - 8.77) < 1e-2


@pytest.mark.parametrize("degree", [2, 4, 8])
def test_chebyshev_apply_matches_jax(p24, degree):
    ja, ta = _csr_pair(p24)
    lo, hi = jp.estimate_spectral_bounds(ja)
    Mj = jp.chebyshev_preconditioner(ja, lo, hi, degree=degree)
    Mt = tp.chebyshev_preconditioner(ta, lo, hi, degree=degree)
    r = np.random.default_rng(degree).standard_normal(p24.shape[0])
    yj, yt = np.asarray(Mj(jnp.asarray(r))), Mt(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())


def test_chebyshev_guards(p24):
    _, ta = _csr_pair(p24)
    with pytest.raises(ValueError, match="degree must be >= 2"):
        tp.chebyshev_preconditioner(ta, 0.1, 8.0, degree=1)
    for lo, hi in ((0.0, 8.0), (8.0, 0.1), (-1.0, 8.0)):
        with pytest.raises(ValueError, match="need 0 < lam_min < lam_max"):
            tp.chebyshev_preconditioner(ta, lo, hi)


@pytest.mark.parametrize("precond", ["blockjacobi-4", "blockjacobi-20", "chebyshev-4",
                                     "chebyshev-8"])
def test_pcg_iterations_match_jax(p24, precond):
    ja, ta = _csr_pair(p24)
    kind, size = precond.split("-")
    size = int(size)
    if kind == "blockjacobi":
        Mj, Mt = jp.block_jacobi_preconditioner(ja, size), tp.block_jacobi_preconditioner(ta, size)
    else:
        lo, hi = jp.estimate_spectral_bounds(ja)
        Mj = jp.chebyshev_preconditioner(ja, lo, hi, degree=size)
        Mt = tp.chebyshev_preconditioner(ta, *tp.estimate_spectral_bounds(ta), degree=size)
    b = np.random.default_rng(7).standard_normal(p24.shape[0])
    tol = 1e-8 * np.linalg.norm(b)
    xj, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=tol, M=Mj)
    xt, it = cg_solve(ta, torch.from_numpy(b), tol=tol, M=Mt)
    _, plain = cg_solve(ta, torch.from_numpy(b), tol=tol)
    assert bool(it.converged) and bool(ij.converged)
    assert int(it.iterations) == int(ij.iterations) < int(plain.iterations)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(xj)).max())
    r = b - p24 @ xt.numpy()
    assert np.linalg.norm(r) <= 2 * tol


def test_block_jacobi_on_the_stencil_matches_jax():
    grid = (6, 5, 7)
    ja = jt.StencilOperator.poisson(grid, dtype=jnp.float64)
    ta = tt.StencilOperator.poisson(grid, dtype=torch.float64, device=CPU)
    Mj, Mt = jp.block_jacobi_preconditioner(ja, 7), tp.block_jacobi_preconditioner(ta, 7)
    r = np.random.default_rng(2).standard_normal(ta.shape[0])
    yj, yt = np.asarray(Mj(jnp.asarray(r))), Mt(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12 * np.abs(yj).max())
