"""The port's GMRES(m) (``solver/gmres.py``) against the JAX package's, on
the same numpy inputs (CPU), mirroring ``tests/test_gmres.py``.

Tolerances, with their reasons: float64 solves take the same steps in both
packages with dots summed in another order, so ``iterations``, ``cycles``,
``converged`` and ``breakdown`` are equal, ``rnorm_history`` agrees to
1e-10 relative above the roundoff floor (an absolute 1e-12 of ‖r₀‖: the
Givens estimates near convergence are themselves ~1e-10 of ‖r₀‖, where
the two sum orders part at the 1e-6 relative level), and x to 1e-10 of
max|x|.  Float32 solves show trajectory parity: the history to 1e-3
relative over the first 16 steps, the same flag, iterations within 10%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver.precond import block_jacobi_preconditioner as jbj
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (BlockedEllMatrix, CSRMatrix, DIAMatrix, GmresInfo,
                                         cg_solve, gmres_solve, jacobi_preconditioner)
from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo
from conjugategradient_tpu_torch.solver.precond import block_jacobi_preconditioner

CPU = "cpu"


def _convdiff(nx=16, peclet=20.0):
    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=peclet)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


@pytest.fixture(scope="module")
def convdiff():
    return _convdiff()


def _pair(a, dtype=np.float64):
    return JCSR.from_scipy(a, dtype=dtype), CSRMatrix.from_scipy(a, dtype=dtype, device=CPU)


def _check_f64(ij, it, xj, xt):
    k = int(ij.iterations)
    assert int(it.iterations) == k
    assert int(it.cycles) == int(ij.cycles)
    assert bool(it.converged) == bool(ij.converged)
    assert bool(it.breakdown) == bool(ij.breakdown)
    hj, ht = np.asarray(ij.rnorm_history), it.rnorm_history.numpy()
    assert ht.shape == hj.shape
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    fin = np.isfinite(hj)
    np.testing.assert_allclose(ht[fin], hj[fin], rtol=1e-10, atol=1e-12 * hj[0])
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-10 * max(1.0, np.abs(xj).max()))
    np.testing.assert_allclose(float(it.rnorm), float(ij.rnorm), rtol=1e-6, atol=1e-12 * hj[0])


def _jacobi_pair(ja, ta):
    return jcg.jacobi_preconditioner(ja), jacobi_preconditioner(ta)


CASES = {
    "m5": dict(restart=5, tol=1e-8, maxiter=4000),
    "m30": dict(restart=30, tol=1e-10),
    "m-n": dict(restart=256, tol=1e-10),
    "jacobi": dict(restart=30, tol=1e-9, M="jacobi"),
    "flexible-jacobi": dict(restart=20, tol=1e-9, M="jacobi", flexible=True),
    "flexible-no-m": dict(restart=30, tol=1e-8, flexible=True),
    "blockjacobi-4": dict(restart=20, tol=1e-9, M="blockjacobi"),
    "cap-tol0": dict(restart=8, tol=0.0, maxiter=17),
    "unroll-never": dict(restart=6, tol=1e-9, maxiter=1024, unroll="never"),
    "unroll-always": dict(restart=6, tol=1e-9, maxiter=1024, unroll="always"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(convdiff, case):
    kw = dict(CASES[case])
    ja, ta = _pair(convdiff)
    b = np.random.default_rng(len(case)).standard_normal(convdiff.shape[0])
    mj = mt = None
    if kw.get("M") == "jacobi":
        mj, mt = _jacobi_pair(ja, ta)
    elif kw.get("M") == "blockjacobi":
        mj, mt = jbj(ja, 4), block_jacobi_preconditioner(ta, 4)
    kw.pop("M", None)
    xj, ij = jcg.gmres_solve(ja, jnp.asarray(b), M=mj, **kw)
    xt, it = gmres_solve(ta, torch.from_numpy(b), M=mt, **kw)
    _check_f64(ij, it, xj, xt)
    if case == "cap-tol0":
        assert int(it.iterations) == 17 and not bool(it.converged) and int(it.cycles) == 3
    else:
        assert bool(it.converged)
        assert int(it.iterations) <= int(it.cycles) * min(kw["restart"], convdiff.shape[0])
    if case == "m-n":
        assert int(it.cycles) == 1
        h = it.rnorm_history.numpy()
        h = h[~np.isnan(h)]
        assert (np.diff(h) <= 1e-9 * h[0]).all()  # minimal residual: monotone


def test_converges_on_nonsymmetric(convdiff):
    b = np.random.default_rng(0).standard_normal(convdiff.shape[0])
    x_ref = spla.spsolve(convdiff.tocsc(), b)
    x, info = gmres_solve(CSRMatrix.from_scipy(convdiff, device=CPU), torch.from_numpy(b),
                          tol=1e-10)
    assert isinstance(info, GmresInfo)
    assert bool(info.converged) and not bool(info.breakdown)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=1e-8)
    r = b - convdiff @ x.numpy()
    assert abs(float(info.rnorm) - np.linalg.norm(r)) <= 1e-9
    assert float(info.rnorm_true) == float(info.rnorm)
    assert info.residual_norms is info.rnorm_history


def test_warm_start_matches_jax(convdiff):
    n = convdiff.shape[0]
    ja, ta = _pair(convdiff)
    b = np.random.default_rng(8).standard_normal(n)
    x1j, i1j = jcg.gmres_solve(ja, jnp.asarray(b), tol=1e-4, restart=20)
    x1t, i1t = gmres_solve(ta, torch.from_numpy(b), tol=1e-4, restart=20)
    _check_f64(i1j, i1t, x1j, x1t)
    h = i1t.rnorm_history.numpy()
    k = int(i1t.iterations)
    assert h.shape == (n + 1,) and not np.isnan(h[: k + 1]).any() and np.isnan(h[k + 1:]).all()
    x2j, i2j = jcg.gmres_solve(ja, jnp.asarray(b), x0=jnp.asarray(x1t.numpy()), tol=1e-10,
                               restart=20)
    x2t, i2t = gmres_solve(ta, torch.from_numpy(b), x0=x1t, tol=1e-10, restart=20)
    _check_f64(i2j, i2t, x2j, x2t)
    _, i3t = gmres_solve(ta, torch.from_numpy(b), tol=1e-10, restart=20)
    assert bool(i2t.converged) and int(i2t.iterations) < int(i3t.iterations)


def test_spd_case_matches_cg_and_jax():
    a = _convdiff(12, peclet=0.0)
    ja, ta = _pair(a)
    b = np.random.default_rng(4).standard_normal(a.shape[0])
    xj, ij = jcg.gmres_solve(ja, jnp.asarray(b), tol=1e-10)
    xt, it = gmres_solve(ta, torch.from_numpy(b), tol=1e-10)
    _check_f64(ij, it, xj, xt)
    xc, _ = cg_solve(ta, torch.from_numpy(b), tol=1e-10)
    np.testing.assert_allclose(xt.numpy(), xc.numpy(), atol=1e-8)


def test_gmres_succeeds_where_cg_fails(convdiff):
    b = np.random.default_rng(3).standard_normal(convdiff.shape[0])
    A = CSRMatrix.from_scipy(convdiff, device=CPU)
    xg, ig = gmres_solve(A, torch.from_numpy(b), tol=1e-8)
    assert bool(ig.converged)
    xc, _ = cg_solve(A, torch.from_numpy(b), tol=1e-8, maxiter=int(ig.iterations) + 10)
    rc = np.linalg.norm(b - convdiff @ xc.numpy())
    rg = np.linalg.norm(b - convdiff @ xg.numpy())
    assert rg <= 1e-8 < rc


def test_jacobi_helps_on_a_scaled_system():
    a = _convdiff(16, peclet=10.0)
    a = (sp.diags(np.logspace(0, 4, a.shape[0])) @ a).tocsr()
    ja, ta = _pair(a)
    b = np.random.default_rng(5).standard_normal(a.shape[0])
    tol = 1e-6 * np.linalg.norm(b)
    mj, mt = _jacobi_pair(ja, ta)
    xj, ij = jcg.gmres_solve(ja, jnp.asarray(b), tol=tol, restart=30, maxiter=3000, M=mj)
    xt, it = gmres_solve(ta, torch.from_numpy(b), tol=tol, restart=30, maxiter=3000, M=mt)
    _check_f64(ij, it, xj, xt)
    _, iu = gmres_solve(ta, torch.from_numpy(b), tol=tol, restart=30, maxiter=3000)
    assert bool(it.converged) and int(it.iterations) < int(iu.iterations)


def test_happy_breakdown_is_convergence():
    n = 32
    a = np.eye(n) * 3.0
    b = np.random.default_rng(6).standard_normal(n)
    xj, ij = jcg.gmres_solve(jnp.asarray(a), jnp.asarray(b), tol=1e-12)
    xt, it = gmres_solve(torch.from_numpy(a), torch.from_numpy(b), tol=1e-12)
    _check_f64(ij, it, xj, xt)
    assert bool(it.converged) and not bool(it.breakdown) and int(it.iterations) == 1
    np.testing.assert_allclose(xt.numpy(), b / 3.0, atol=1e-12)


def test_nan_operator_is_clean_breakdown():
    n = 16
    a = np.eye(n)
    a[3, 3] = np.nan
    b = np.ones(n)
    xj, ij = jcg.gmres_solve(jnp.asarray(a), jnp.asarray(b), tol=1e-10)
    xt, it = gmres_solve(torch.from_numpy(a), torch.from_numpy(b), tol=1e-10)
    assert bool(it.breakdown) and not bool(it.converged)
    assert bool(ij.breakdown) and not bool(ij.converged)
    assert int(it.iterations) == int(ij.iterations) and int(it.cycles) == int(ij.cycles)
    np.testing.assert_array_equal(np.isnan(it.rnorm_history.numpy()),
                                  np.isnan(np.asarray(ij.rnorm_history)))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


def test_callable_operator_matches_jax(convdiff):
    n = convdiff.shape[0]
    dense = convdiff.toarray()
    b = np.random.default_rng(9).standard_normal(n)
    dj, dt = jnp.asarray(dense), torch.from_numpy(dense)
    xj, ij = jcg.gmres_solve(lambda v: dj @ v, jnp.asarray(b), tol=1e-9, n=n)
    xt, it = gmres_solve(lambda v: dt @ v, torch.from_numpy(b), tol=1e-9, n=n)
    _check_f64(ij, it, xj, xt)


def test_inner_krylov_preconditioner_matches_jax(convdiff):
    """FGMRES with an inner CG on the symmetric part (nonlinear in v)."""
    n = convdiff.shape[0]
    a = convdiff.toarray()
    sym = 0.5 * (a + a.T)
    ja, ta = _pair(convdiff)
    b = np.random.default_rng(21).standard_normal(n)
    sj, st = jnp.asarray(sym), torch.from_numpy(sym)
    xj, ij = jcg.gmres_solve(ja, jnp.asarray(b), tol=1e-8, restart=20, maxiter=400, flexible=True,
                             M=lambda v: jcg.cg_solve(sj, v, tol=0.0, maxiter=8)[0])
    xt, it = gmres_solve(ta, torch.from_numpy(b), tol=1e-8, restart=20, maxiter=400,
                         flexible=True, M=lambda v: cg_solve(st, v, tol=0.0, maxiter=8)[0])
    _check_f64(ij, it, xj, xt)
    _, plain = gmres_solve(ta, torch.from_numpy(b), tol=1e-8, restart=20, maxiter=400)
    assert bool(it.converged) and int(it.iterations) < int(plain.iterations)


def test_flexible_fixed_m_coincides(convdiff):
    ta = CSRMatrix.from_scipy(convdiff, device=CPU)
    b = torch.from_numpy(np.random.default_rng(20).standard_normal(convdiff.shape[0]))
    M = jacobi_preconditioner(ta)
    xs, i_s = gmres_solve(ta, b, tol=1e-9, restart=20, M=M)
    xf, i_f = gmres_solve(ta, b, tol=1e-9, restart=20, M=M, flexible=True)
    assert bool(i_f.converged) and int(i_f.iterations) == int(i_s.iterations)
    np.testing.assert_allclose(xf.numpy(), xs.numpy(), atol=1e-10)
    x1, i1 = gmres_solve(ta, b, tol=1e-8, flexible=True)
    x2, i2 = gmres_solve(ta, b, tol=1e-8)
    assert torch.equal(x1, x2) and int(i1.iterations) == int(i2.iterations)


def _traj(it, ij, b):
    """float32 trajectory parity (module doc)."""
    hj, ht = np.asarray(ij.rnorm_history, np.float64), it.rnorm_history.double().numpy()
    np.testing.assert_allclose(ht[:16], hj[:16], rtol=1e-3)
    assert bool(it.converged) == bool(ij.converged)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert abs(kt - kj) <= max(2, kj // 10)


def test_float32_trajectory(convdiff):
    b = np.random.default_rng(10).standard_normal(convdiff.shape[0])
    bn = np.linalg.norm(b)
    ja, ta = _pair(convdiff, np.float32)
    xj, ij = jcg.gmres_solve(ja, jnp.asarray(b, jnp.float32), tol=1e-4 * bn, maxiter=3000)
    xt, it = gmres_solve(ta, torch.from_numpy(b.astype(np.float32)), tol=1e-4 * bn, maxiter=3000)
    _traj(it, ij, b)
    r = b - convdiff @ xt.numpy().astype(np.float64)
    assert bool(it.converged) and np.linalg.norm(r) <= 2e-4 * bn


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_dia_route_matches_jax(convdiff, dtype):
    """The DIA operator (its plain version here; kernel 7 on the card)."""
    ja, _ = _pair(convdiff, dtype)
    c = convdiff.tocsr()
    ta = DIAMatrix.from_csr_host(c.data, c.indices, c.indptr, c.shape, dtype=dtype, device=CPU)
    assert len(ta.offsets) == 5
    b = np.random.default_rng(11).standard_normal(c.shape[0]).astype(dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4 * float(np.linalg.norm(b))
    xj, ij = jcg.gmres_solve(ja, jnp.asarray(b), tol=tol, restart=32, maxiter=2000)
    xt, it = gmres_solve(ta, torch.from_numpy(b), tol=tol, restart=32, maxiter=2000)
    if dtype == np.float64:
        _check_f64(ij, it, xj, xt)
    else:
        _traj(it, ij, b)


def test_packed_bell_route_matches_jax():
    """Float32 blocked-ELL on sparse tiles takes the packed route (its plain
    version here; packed kernel 5 on the card)."""
    a = _convdiff(24, peclet=10.0)
    ja, _ = _pair(a, np.float32)
    ta = BlockedEllMatrix.from_csr(CSRMatrix.from_scipy(a, dtype=np.float32, device=CPU),
                                   bm=32, bn=32)
    assert bell_packed_route(ta)
    b = np.random.default_rng(12).standard_normal(a.shape[0]).astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    xj, ij = jcg.gmres_solve(ja, jnp.asarray(b), tol=tol, restart=32, maxiter=2000)
    xt, it = gmres_solve(ta, torch.from_numpy(b), tol=tol, restart=32, maxiter=2000)
    _traj(it, ij, b)
    r = a @ xt.numpy().astype(np.float64) - b
    assert np.linalg.norm(r) <= 2e-4 * np.linalg.norm(b)


def test_unroll_is_validated(convdiff):
    ta = CSRMatrix.from_scipy(convdiff, device=CPU)
    b = torch.ones(convdiff.shape[0], dtype=torch.float64)
    with pytest.raises(ValueError, match="unroll must be auto/never/always"):
        gmres_solve(ta, b, unroll="sometimes")
    with pytest.raises(ValueError, match="unroll must be auto/never/always"):
        jcg.gmres_solve(JCSR.from_scipy(convdiff), jnp.ones(convdiff.shape[0]), unroll="sometimes")


def test_zero_maxiter_and_zero_rhs(convdiff):
    ja, ta = _pair(convdiff)
    for b in (np.zeros(convdiff.shape[0]), np.ones(convdiff.shape[0])):
        xj, ij = jcg.gmres_solve(ja, jnp.asarray(b), tol=1e-8, maxiter=0)
        xt, it = gmres_solve(ta, torch.from_numpy(b), tol=1e-8, maxiter=0)
        assert int(it.iterations) == int(ij.iterations) == 0
        assert int(it.cycles) == int(ij.cycles) == 0
        assert bool(it.converged) == bool(ij.converged) == (not b.any())
        assert it.rnorm_history.shape == (1,)
