"""The port's scipy drop-in (``scipy_compat.py``) against the JAX package's
shim and against ``scipy.sparse.linalg`` itself, on the same numpy inputs
(CPU: every call passes ``device="cpu"``), mirroring
``tests/test_scipy_compat.py`` and the drop-in tests of
``tests/test_bicgstab.py``, ``tests/test_gmres.py``,
``tests/test_lobpcg.py`` and ``tests/test_round3_fixes.py``.

Tolerances, with their reasons: x within 1e-9 relative of the JAX shim's
(the same float64 solve, sums in another order; the info codes equal) and
within scipy's own tests' bounds of scipy's; eigenvalues within 1e-10 of
the JAX shim's and 1e-8 of scipy's (ARPACK's own tolerance class); the
callback iterates bit for bit against the returned x.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from conjugategradient_tpu import scipy_compat as jsc
from conjugategradient_tpu_torch import scipy_compat as tsc
from conjugategradient_tpu_torch.problems import (convection_diffusion_2d_coo, poisson2d_coo,
                                                  random_spd_dense)

CPU = "cpu"


def _poisson(nx=12):
    rows, cols, vals, shape = poisson2d_coo(nx)
    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    return A, np.arange(1, shape[0] + 1, dtype=np.float64)


def _convdiff(nx=20, peclet=20.0):
    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=peclet)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def _indefinite(n=40, seed=21):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.linspace(-2.0, -0.5, n // 2), np.linspace(0.5, 2.0, n - n // 2)])
    return Q @ np.diag(eigs) @ Q.T, rng.standard_normal(n)


def _x(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_exports_follow_the_jax_shim():
    assert tsc.__all__ == jsc.__all__
    for name in (*jsc.__all__, "gmres"):
        assert callable(getattr(tsc, name))


# --- cg ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"rtol": 1e-10}, {"rtol": 1e-12, "maxiter": 3},
                                {"rtol": 0.0, "atol": 1e-8}],
                         ids=["rtol", "cap", "atol"])
def test_cg_matches_the_jax_shim_and_scipy(kw):
    A, b = _poisson()
    x, info = tsc.cg(A, b, device=CPU, **kw)
    xj, infoj = jsc.cg(A, b, **kw)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert info == infoj
    np.testing.assert_allclose(_x(x), _x(xj), rtol=1e-9, atol=1e-9 * np.abs(_x(xj)).max())
    if "maxiter" in kw:
        assert info == 3
        return
    xs, infos = spla.cg(A, b, **kw)
    assert info == infos == 0
    np.testing.assert_allclose(_x(x), xs, rtol=1e-7, atol=1e-9)
    tol = max(kw["rtol"] * np.linalg.norm(b), kw.get("atol", 0.0))
    assert np.linalg.norm(b - A @ _x(x)) <= 1.1 * tol


def test_cg_preconditioner_operator():
    """scipy-style M ~ A^-1, the inverse diagonal as a scipy matrix."""
    A, b = _poisson()
    M = sp.diags(1.0 / A.diagonal())
    x, info = tsc.cg(A, b, rtol=1e-10, M=M, device=CPU)
    xj, infoj = jsc.cg(A, b, rtol=1e-10, M=M)
    assert info == infoj == 0
    np.testing.assert_allclose(_x(x), _x(xj), rtol=1e-9)
    np.testing.assert_allclose(A @ _x(x), b, rtol=1e-7, atol=1e-7)


def test_cg_callback_sees_every_iterate():
    A, b = _poisson(6)
    seen, seen_j = [], []
    x, info = tsc.cg(A, b, rtol=1e-10, callback=lambda xk: seen.append(xk.copy()), device=CPU)
    xj, infoj = jsc.cg(A, b, rtol=1e-10, callback=lambda xk: seen_j.append(xk.copy()))
    assert info == infoj == 0
    assert isinstance(seen[0], np.ndarray) and len(seen) == len(seen_j) >= 2
    np.testing.assert_array_equal(seen[-1], _x(x))
    np.testing.assert_allclose(np.array(seen), np.array(seen_j), rtol=1e-9, atol=1e-12)
    errs = [np.linalg.norm(b - A @ xk) for xk in seen[:-1]]
    assert errs[-1] < errs[0]
    # the step-at-a-time path gives the device-resident solve's x
    x2, _ = tsc.cg(A, b, rtol=1e-10, device=CPU)
    np.testing.assert_allclose(_x(x), _x(x2), rtol=1e-12)


def test_cg_x0_warm_start_and_matrix_free_callable():
    A, b = _poisson()
    x_cold, _ = tsc.cg(A, b, rtol=1e-10, device=CPU)
    x, info = tsc.cg(A, b, x0=_x(x_cold), rtol=1e-10, device=CPU)
    assert info == 0
    np.testing.assert_allclose(_x(x), _x(x_cold), rtol=1e-9)
    Ad = torch.from_numpy(A.toarray())
    x, info = tsc.cg(lambda v: Ad @ v, b, rtol=1e-10, device=CPU)
    assert info == 0
    np.testing.assert_allclose(A @ _x(x), b, rtol=1e-7, atol=1e-7)


def test_numpy_backed_linear_operator_refused():
    """A numpy-backed scipy LinearOperator (as A or as M) is refused at
    setup with TypeError, as the JAX shim refuses it."""
    A, b = _poisson(8)
    lo = spla.LinearOperator(A.shape, matvec=lambda v: A @ np.asarray(v))
    M = spla.LinearOperator(A.shape, matvec=lambda v: np.asarray(v) / A.diagonal())
    for kw in ({"A": lo}, {"A": A, "M": M}):
        with pytest.raises(TypeError, match="numpy-backed scipy LinearOperator"):
            tsc.cg(kw["A"], b, rtol=1e-8, M=kw.get("M"), device=CPU)
        with pytest.raises(TypeError, match="JAX-traceable"):
            jsc.cg(kw["A"], b, rtol=1e-8, M=kw.get("M"))
    for fn in (tsc.minres, tsc.bicgstab, tsc.gmres):
        with pytest.raises(TypeError, match="numpy-backed"):
            fn(lo, b, device=CPU)
    with pytest.raises(TypeError, match="numpy-backed"):
        tsc.lobpcg(lo, np.ones((A.shape[0], 2)), device=CPU)


def test_numpy_matvec_diagnosed_and_real_errors_propagate():
    def boom(x):
        raise ValueError("boom from user matvec")

    with pytest.raises(ValueError, match="boom from user matvec"):
        tsc.cg(boom, np.ones(4), device=CPU)
    with pytest.raises(TypeError, match="not a torch tensor"):
        tsc.cg(lambda x: np.asarray(x) * 2.0, np.ones(4), device=CPU)


def test_b_shape_checks():
    A, b = _poisson(4)
    with pytest.raises(ValueError, match="1-D"):
        tsc.cg(A, b[:, None], device=CPU)
    with pytest.raises(ValueError, match="expected"):
        tsc.cg(A, b[:-1], device=CPU)


# --- minres -----------------------------------------------------------------

def test_minres_matches_the_jax_shim_and_scipy():
    Ad, b = _indefinite()
    x, info = tsc.minres(torch.from_numpy(Ad), b, rtol=1e-10, maxiter=400)
    xj, infoj = jsc.minres(jnp.asarray(Ad), b, rtol=1e-10, maxiter=400)
    xs, infos = spla.minres(Ad, b, rtol=1e-10)
    assert info == infoj == infos == 0
    np.testing.assert_allclose(_x(x), _x(xj), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_x(x), xs, rtol=1e-6, atol=1e-7)
    assert np.linalg.norm(b - Ad @ _x(x)) <= 1.01e-10 * np.linalg.norm(b)


def test_minres_scipy_input_shift_callback_and_cap():
    A, b = _poisson(10)
    x, info = tsc.minres(A, b, shift=0.05, rtol=1e-10, device=CPU)
    assert info == 0
    r = b - (A @ _x(x) - 0.05 * _x(x))
    assert np.linalg.norm(r) <= 1.01e-10 * np.linalg.norm(b)
    Ad, b = _indefinite(24, seed=23)
    At = torch.from_numpy(Ad)
    seen = []
    x_e, info_e = tsc.minres(At, b, rtol=1e-9, maxiter=200,
                             callback=lambda xk: seen.append(xk.copy()))
    x_c, info_c = tsc.minres(At, b, rtol=1e-9, maxiter=200)
    xj, _ = jsc.minres(jnp.asarray(Ad), b, rtol=1e-9, maxiter=200, callback=lambda xk: None)
    assert info_c == info_e == 0 and len(seen) >= 2
    np.testing.assert_array_equal(seen[-1], _x(x_e))
    np.testing.assert_allclose(_x(x_c), _x(x_e), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(_x(x_e), _x(xj), rtol=1e-9, atol=1e-12)
    Ad, b = _indefinite()
    assert tsc.minres(torch.from_numpy(Ad), b, rtol=1e-14, maxiter=3)[1] == 3


# --- bicgstab ---------------------------------------------------------------

def test_bicgstab_matches_the_jax_shim_and_scipy():
    A = _convdiff()
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    x, flag = tsc.bicgstab(A, b, rtol=1e-9, device=CPU)
    xj, flagj = jsc.bicgstab(A, b, rtol=1e-9)
    xs, flags = spla.bicgstab(A, b, rtol=1e-9)
    assert flag == flagj == flags == 0
    np.testing.assert_allclose(_x(x), _x(xj), rtol=1e-9, atol=1e-12)
    x_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(_x(x) - x_ref) <= max(2 * np.linalg.norm(xs - x_ref), 1e-7)


def test_bicgstab_cap_breakdown_callback_and_preconditioner():
    A = _convdiff()
    assert tsc.bicgstab(A, np.ones(A.shape[0]), rtol=1e-14, maxiter=3, device=CPU)[1] == 3
    Ab = np.array([[0.0, 1.0], [-1.0, 0.0]])
    assert tsc.bicgstab(Ab, np.array([1.0, 0.0]), rtol=1e-12, device=CPU)[1] == -10
    assert jsc.bicgstab(Ab, np.array([1.0, 0.0]), rtol=1e-12)[1] == -10
    seen = []
    b = np.random.default_rng(8).standard_normal(A.shape[0])
    x, flag = tsc.bicgstab(A, b, rtol=1e-8, callback=lambda xk: seen.append(xk.copy()),
                           device=CPU)
    assert flag == 0 and len(seen) >= 1
    np.testing.assert_array_equal(seen[-1], _x(x))
    b = np.random.default_rng(9).standard_normal(A.shape[0])
    x, flag = tsc.bicgstab(A, b, rtol=1e-9, M=sp.diags(1.0 / A.diagonal()), device=CPU)
    assert flag == 0
    np.testing.assert_allclose(_x(x), spla.spsolve(A.tocsc(), b), rtol=0, atol=1e-6)


# --- gmres ------------------------------------------------------------------

def test_gmres_matches_the_jax_shim_and_scipy():
    A = _convdiff()
    b = np.random.default_rng(11).standard_normal(A.shape[0])
    x, info = tsc.gmres(A, b, rtol=1e-8, atol=0.0, device=CPU)
    xj, infoj = jsc.gmres(A, b, rtol=1e-8, atol=0.0)
    x_sp, info_sp = spla.gmres(A, b, rtol=1e-8, atol=0.0)
    assert info == infoj == info_sp == 0
    np.testing.assert_allclose(_x(x), _x(xj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_x(x), x_sp, atol=1e-5)
    assert np.linalg.norm(b - A @ _x(x)) <= 1e-8 * np.linalg.norm(b)


def test_gmres_cycles_callback_and_refusals():
    A = _convdiff()
    b = np.random.default_rng(12).standard_normal(A.shape[0])
    assert tsc.gmres(A, b, rtol=1e-14, atol=0.0, restart=5, maxiter=2, device=CPU)[1] == 2
    seen = []
    b = np.random.default_rng(13).standard_normal(A.shape[0])
    x, info = tsc.gmres(A, b, rtol=1e-8, restart=25, callback=lambda xk: seen.append(xk.copy()),
                        callback_type="x", device=CPU)
    assert info == 0 and len(seen) >= 2
    np.testing.assert_array_equal(seen[-1], _x(x))
    assert np.linalg.norm(b - A @ seen[-1]) < np.linalg.norm(b - A @ seen[0])
    with pytest.raises(ValueError, match="callback_type"):
        tsc.gmres(A, b, callback=lambda *_: None, callback_type="legacy", device=CPU)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="restart"):
            tsc.gmres(sp.eye(8, format="csr") * 2.0, np.ones(8), restart=bad, device=CPU)
    x, info = tsc.gmres(A, b, rtol=1e-9, M=sp.diags(1.0 / A.diagonal()), device=CPU)
    assert info == 0 and np.linalg.norm(b - A @ _x(x)) <= 1e-9 * np.linalg.norm(b)


# --- lobpcg -----------------------------------------------------------------

def test_lobpcg_matches_the_jax_shim_and_scipy():
    rows, cols, vals, shape = poisson2d_coo(16)
    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    X = np.random.default_rng(2).standard_normal((shape[0], 3))
    w_ref, _ = spla.lobpcg(A, X.copy(), largest=False, maxiter=300, tol=1e-8)
    w, v = tsc.lobpcg(A, X, largest=False, maxiter=300, tol=1e-8, device=CPU)
    wj, vj = jsc.lobpcg(A, X, largest=False, maxiter=300, tol=1e-8)
    assert isinstance(w, np.ndarray) and isinstance(v, np.ndarray) and v.shape == (shape[0], 3)
    np.testing.assert_allclose(w, wj, rtol=1e-10)
    np.testing.assert_allclose(np.sort(w), np.sort(w_ref), rtol=1e-6)


def test_lobpcg_order_histories_and_defaults():
    A = np.diag(np.arange(1.0, 61.0))
    X = np.random.default_rng(0).standard_normal((60, 3))
    w, _ = tsc.lobpcg(A, X, maxiter=200, tol=1e-8, device=CPU)  # largest=True by default
    np.testing.assert_allclose(w, [60.0, 59.0, 58.0], rtol=1e-7)
    A = np.diag(np.arange(1.0, 41.0))
    X = np.random.default_rng(1).standard_normal((40, 2))
    out = tsc.lobpcg(A, X, largest=False, maxiter=60, tol=1e-8, retLambdaHistory=True,
                     retResidualNormsHistory=True, device=CPU)
    outj = jsc.lobpcg(A, X, largest=False, maxiter=60, tol=1e-8, retLambdaHistory=True,
                      retResidualNormsHistory=True)
    assert len(out) == len(outj) == 4
    w, _, lh, rh = out
    assert isinstance(lh, list) and isinstance(rh, list) and len(lh) == len(rh) >= 2
    assert lh[0].shape == (2,)
    np.testing.assert_allclose(lh[-1], w, rtol=1e-12)
    np.testing.assert_allclose(np.array(lh[: len(outj[2])]), np.array(outj[2][: len(lh)]),
                               rtol=1e-10)
    # scipy's default tol, n * sqrt(eps), and maxiter 20
    w, _ = tsc.lobpcg(A, X, largest=False, device=CPU)
    wj, _ = jsc.lobpcg(A, X, largest=False)
    np.testing.assert_allclose(w, wj, rtol=1e-10)


def test_lobpcg_generalized_and_preconditioned():
    import scipy.linalg

    rows, cols, vals, shape = poisson2d_coo(12)
    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    n = shape[0]
    B = sp.diags(np.linspace(1.0, 2.0, n)).tocsr()
    w_ref = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    X = np.random.default_rng(3).standard_normal((n, 3))
    Minv = sp.diags(1.0 / A.diagonal()).tocsr()
    w, _ = tsc.lobpcg(A, X, B=B, M=Minv, largest=False, maxiter=400, tol=1e-8, device=CPU)
    wj, _ = jsc.lobpcg(A, X, B=B, M=Minv, largest=False, maxiter=400, tol=1e-8)
    np.testing.assert_allclose(w, w_ref[:3], rtol=1e-6)
    np.testing.assert_allclose(w, wj, rtol=1e-9)
    with pytest.raises(NotImplementedError, match="deflation"):
        tsc.lobpcg(np.eye(30), np.ones((30, 2)), Y=np.ones((30, 1)), device=CPU)
    with pytest.raises(ValueError, match="2-D"):
        tsc.lobpcg(np.eye(30), np.ones(30), device=CPU)


# --- eigsh ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["LM", "LA", "SM", "SA"])
def test_eigsh_matches_the_jax_shim_and_scipy(which):
    A, _ = _poisson()
    w, v = tsc.eigsh(A, k=4, which=which, device=CPU)
    wj, _ = jsc.eigsh(A, k=4, which=which)
    w_ref = np.sort(spla.eigsh(A, k=4, which=which)[0])
    np.testing.assert_allclose(w, wj, rtol=1e-10)
    np.testing.assert_allclose(w, w_ref, rtol=1e-8)
    assert list(w) == sorted(w)
    resid = np.linalg.norm(A @ v - v * w, axis=0)
    assert (resid <= 1e-6 * np.abs(w)).all()


def test_eigsh_no_vectors_v0_and_small_ncv():
    A, _ = _poisson()
    n = A.shape[0]
    w = tsc.eigsh(A, k=3, return_eigenvectors=False, v0=np.ones(n) / np.sqrt(n), device=CPU)
    wj = jsc.eigsh(A, k=3, return_eigenvectors=False, v0=np.ones(n) / np.sqrt(n))
    assert w.shape == (3,) and list(w) == sorted(w)
    np.testing.assert_allclose(w, wj, rtol=1e-10)
    A16, _ = _poisson(16)
    w, v = tsc.eigsh(A16, k=2, which="SM", ncv=4, tol=1e-8, device=CPU)
    assert (np.linalg.norm(A16 @ v - v * w, axis=0) <= 1e-7 * np.abs(w)).all()


def test_eigsh_generalized_pencil():
    import scipy.linalg

    A, _ = _poisson()
    n = A.shape[0]
    B = sp.diags(np.linspace(1.0, 2.0, n)).tocsr()
    w, v = tsc.eigsh(A, k=3, which="SM", M=B, tol=1e-6, device=CPU)
    wj, _ = jsc.eigsh(A, k=3, which="SM", M=B, tol=1e-6)
    w_ref = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)[:3]
    np.testing.assert_allclose(w, w_ref, rtol=1e-6)
    np.testing.assert_allclose(w, wj, rtol=1e-8)
    np.testing.assert_allclose(v.T @ (B @ v), np.eye(3), atol=1e-6)


def test_eigsh_refusals():
    A, _ = _poisson()
    with pytest.raises(NotImplementedError, match="shift-invert"):
        tsc.eigsh(A, k=2, sigma=0.5, device=CPU)
    with pytest.raises(NotImplementedError, match="BE"):
        tsc.eigsh(A, k=2, which="BE", device=CPU)
    with pytest.raises(ValueError, match="k="):
        tsc.eigsh(A, k=0, device=CPU)


def test_eigsh_no_convergence_raises_arpack_exception():
    A = sp.diags(np.linspace(1.0, 1e4, 400)).tocsr()
    B = sp.diags(np.linspace(1.0, 2.0, 400)).tocsr()
    with pytest.raises(spla.ArpackNoConvergence):
        tsc.eigsh(A, k=3, which="SM", M=B, maxiter=1, device=CPU)
    with pytest.raises(spla.ArpackNoConvergence):
        tsc.eigsh(A, k=3, which="SM", maxiter=5, tol=1e-10, device=CPU)


def test_eigsh_degenerate_spectra_return_k_pairs():
    w, v = tsc.eigsh(sp.identity(10, format="csr"), k=3, device=CPU)
    np.testing.assert_allclose(w, 1.0)
    assert v.shape == (10, 3)
    w2 = tsc.eigsh(sp.diags(np.arange(1.0, 11.0)).tocsr(), k=3, which="SM", v0=np.eye(10)[0],
                   return_eigenvectors=False, device=CPU)
    np.testing.assert_allclose(w2, [1.0, 2.0, 3.0], rtol=1e-10)
    w3 = tsc.eigsh(sp.identity(5, format="csr"), k=2, return_eigenvectors=False, device=CPU)
    np.testing.assert_allclose(w3, 1.0)


def test_eigsh_resolves_multiplicity_like_arpack():
    d = np.array([[1.0, 0, 0], [0, 1.132, -0.132], [0, -0.132, 1.132]])
    w = tsc.eigsh(sp.csr_matrix(d), k=2, which="SM", return_eigenvectors=False, tol=1e-8,
                  device=CPU)
    np.testing.assert_allclose(w, [1.0, 1.0], rtol=1e-10)
    d2 = np.kron(np.eye(4), np.array([[2.0, -1], [-1, 2]]))
    w2, v2 = tsc.eigsh(sp.csr_matrix(d2), k=3, which="SM", device=CPU)
    np.testing.assert_allclose(w2, 1.0, rtol=1e-9)
    np.testing.assert_allclose(v2.T @ v2, np.eye(3), atol=1e-8)
    w3 = tsc.eigsh(sp.csr_matrix(d2), k=3, which="LM", return_eigenvectors=False, device=CPU)
    np.testing.assert_allclose(w3, 3.0, rtol=1e-9)
    d = np.array([[2.351, 0.905, 0.446], [0.905, 3.208, -1.303], [0.446, -1.303, 2.749]])
    w = tsc.eigsh(sp.csr_matrix(d), k=2, which="LM", return_eigenvectors=False, tol=1e-8,
                  device=CPU)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(d)[1:], rtol=1e-9)


def test_eigsh_random_spd_both_ends():
    A = random_spd_dense(30, seed=5)
    w_true = np.linalg.eigvalsh(A)
    for which, sl in (("SM", slice(0, 2)), ("LM", slice(28, 30))):
        w = tsc.eigsh(sp.csr_matrix(A), k=2, which=which, return_eigenvectors=False, tol=1e-8,
                      device=CPU)
        np.testing.assert_allclose(w, w_true[sl], rtol=1e-6, atol=1e-8)
