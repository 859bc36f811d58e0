"""The port's deflated and recycling CG (``solver/deflated.py``) against the
JAX package's, on the same numpy inputs (CPU), mirroring
``tests/test_deflated.py``.

Both packages deflate with the same basis: the JAX one's ``W``, ``AW`` and
``E_chol`` carried across by ``convert.deflation_basis_from_arrays``.
Tolerances, with their reasons: float64 iteration counts equal and
``rho_history`` within 1e-10 relative on the entries above 1e-8·ρ₀ (the
same recurrence, sums in another order: measured 7e-15); bases built from
the same vectors within 1e-12 (E_chol) and harvested bases within 1e-10 up
to each column's sign (two LAPACK ``eigh`` of the same tridiagonal);
float32 counts within 2 of the JAX package's (sums in another order near
the float32 floor).  Deflated + Chebyshev is held to the JAX count at tol
1e-8·‖b‖ with its true residual, not ``both <= cheb`` at 1e-10, which sits
on the float64 roundoff floor (ROADMAP §3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver import deflated as jd
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import DIAMatrix as JDIA
from conjugategradient_tpu_torch import (BlockedEllMatrix, CSRMatrix, DeflationBasis, DIAMatrix,
                                         cg_solve, convert, deflated_cg_solve,
                                         harvest_deflation_basis, jacobi_preconditioner,
                                         make_deflation_basis)
from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import deflated as td
from conjugategradient_tpu_torch.solver import (basis_quality, chebyshev_preconditioner,
                                                deflation_basis_from_vectors,
                                                estimate_spectral_bounds)

CPU = "cpu"
HIST_RTOL = 1e-10
HIST_FLOOR = 1e-8


@pytest.fixture(scope="module")
def poisson():
    """poisson2d(24) (n = 576) in both packages, b = reference_rhs, its
    dense eigenvectors, and the plain CG count at 1e-10."""
    rows, cols, vals, shape = poisson2d_coo(24)
    JA = JCSR.from_coo(rows, cols, vals, shape)
    TA = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    b = reference_rhs(shape[0])
    _, V = np.linalg.eigh(TA.to_dense().numpy())
    _, info = cg_solve(TA, torch.from_numpy(b), tol=1e-10)
    return JA, TA, b, V, int(info.iterations)


def _carry(jbasis):
    return convert.deflation_basis_from_arrays(np.asarray(jbasis.W), np.asarray(jbasis.AW),
                                               np.asarray(jbasis.E_chol), device=CPU)


def _hist_close(ht, hj, k):
    ht = ht[: k + 1].double().numpy()
    hj = np.asarray(hj, np.float64)[: k + 1]
    keep = hj > HIST_FLOOR * hj[0]
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=HIST_RTOL)


def _solve_both(JA, TA, b, jbasis, **kw):
    jM = kw.pop("jM", None)
    tM = kw.pop("tM", None)
    xj, ij = jd.deflated_cg_solve(JA, jnp.asarray(b), jbasis, M=jM, **kw)
    xt, it = deflated_cg_solve(TA, torch.from_numpy(b), _carry(jbasis), M=tM, **kw)
    return (np.asarray(xj), ij), (xt.numpy(), it)


@pytest.mark.parametrize("k", [8, 12, 24])
def test_exact_basis_matches_jax(poisson, k):
    JA, TA, b, V, plain = poisson
    jbasis = jd.deflation_basis_from_vectors(JA, jnp.asarray(V[:, :k]))
    tbasis = deflation_basis_from_vectors(TA, torch.from_numpy(V[:, :k]))
    assert isinstance(tbasis, DeflationBasis) and tbasis.k == k
    np.testing.assert_allclose(tbasis.E_chol.numpy(), np.asarray(jbasis.E_chol), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tbasis.AW.numpy(), np.asarray(jbasis.AW), rtol=0, atol=1e-12)
    (xj, ij), (xt, it) = _solve_both(JA, TA, b, jbasis, tol=1e-10)
    k_it = int(ij.iterations)
    assert int(it.iterations) == k_it < plain
    assert bool(it.converged) and bool(ij.converged)
    _hist_close(it.rho_history, ij.rho_history, k_it)
    np.testing.assert_allclose(it.residual_norms[: k_it + 1].numpy(),
                               np.sqrt(it.rho_history[: k_it + 1].numpy()))
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-9 * np.abs(xj).max())
    assert float(basis_quality(TA, tbasis).max()) < 1e-8


def test_residual_stays_W_orthogonal(poisson):
    JA, TA, b, V, _ = poisson
    tbasis = deflation_basis_from_vectors(TA, torch.from_numpy(V[:, :8]))
    x, _ = deflated_cg_solve(TA, torch.from_numpy(b), tbasis, tol=1e-10)
    r = torch.from_numpy(b) - TA.matvec(x)
    assert float(torch.abs(tbasis.W.T @ r).max()) < 1e-9


def test_same_solution_as_plain(poisson):
    _, TA, b, V, _ = poisson
    tbasis = deflation_basis_from_vectors(TA, torch.from_numpy(V[:, :8]))
    x_d, _ = deflated_cg_solve(TA, torch.from_numpy(b), tbasis, tol=1e-12)
    x_p, _ = cg_solve(TA, torch.from_numpy(b), tol=1e-12)
    assert float(torch.linalg.vector_norm(x_d - x_p) / torch.linalg.vector_norm(x_p)) < 1e-9


def test_divergence_guard_matches_jax(poisson):
    """tol below the float64 stagnation floor: both packages stop at the
    guard, unconverged, at the same iteration, and return the best x."""
    JA, TA, b, V, _ = poisson
    jbasis = jd.deflation_basis_from_vectors(JA, jnp.asarray(V[:, :8]))
    (xj, ij), (xt, it) = _solve_both(JA, TA, b, jbasis, tol=1e-30)
    assert not bool(it.converged) and not bool(ij.converged)
    k = int(it.iterations)
    assert k == int(ij.iterations) < TA.shape[0]
    hist = it.rho_history.numpy()
    assert np.all(np.isnan(hist[k + 1:])) and np.all(np.isfinite(hist[: k + 1]))
    # the stop: the last ||r||^2 is 1e6 above the running minimum
    assert hist[k] > 1e6 * np.min(hist[: k])
    # the best iterate, not the diverged one
    np.testing.assert_allclose(float(it.rnorm_sq), np.min(hist[: k + 1]), rtol=0)
    resid = float(torch.linalg.vector_norm(torch.from_numpy(b) - TA.matvec(torch.from_numpy(xt))))
    assert resid < 1e-7
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-8 * np.abs(xj).max())


def test_a_degenerate_basis_gives_nan_and_no_error(poisson):
    """A repeated column: E = WᵀAW is singular, so both packages' Cholesky
    factors are NaN (no error at build time), and the solve takes the NaN
    exit after one step, unconverged."""
    JA, TA, b, V, _ = poisson
    W = np.concatenate([V[:, :3], V[:, :1]], axis=1)
    jbasis = jd.deflation_basis_from_vectors(JA, jnp.asarray(W))
    tbasis = deflation_basis_from_vectors(TA, torch.from_numpy(W))
    assert np.isnan(np.asarray(jbasis.E_chol)).any()
    np.testing.assert_array_equal(np.isnan(tbasis.E_chol.numpy()),
                                  np.isnan(np.asarray(jbasis.E_chol)))
    xj, ij = jd.deflated_cg_solve(JA, jnp.asarray(b), jbasis, tol=1e-10)
    xt, it = deflated_cg_solve(TA, torch.from_numpy(b), tbasis, tol=1e-10)
    assert int(it.iterations) == int(ij.iterations) == 1
    assert not bool(it.converged) and not bool(ij.converged)
    assert bool(torch.isnan(it.rnorm_sq)) and bool(torch.isnan(xt).all())


def test_harvest_coefficients_match_jax(poisson):
    """The harvest pass's alpha, beta, scaled residuals and x_m against the
    JAX device loop, and the bases it makes."""
    JA, TA, b, _, _ = poisson
    m = 40
    jV, jal, jbe, jx = jd._cg_harvest_device(*_flat(JA), jnp.asarray(b), m)
    tV, tal, tbe, tx = td._cg_harvest(TA, torch.from_numpy(b), m)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), rtol=1e-10)
    np.testing.assert_allclose(tbe.numpy(), np.asarray(jbe), rtol=1e-10)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-10)
    jb = jd.harvest_deflation_basis(JA, jnp.asarray(b), k=6, m=m)
    tb = harvest_deflation_basis(TA, torch.from_numpy(b), k=6, m=m)
    wt, wj = tb.W.numpy(), np.asarray(jb.W)
    signs = np.sign(np.sum(wt * wj, axis=0))
    np.testing.assert_allclose(wt * signs, wj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(basis_quality(TA, tb).numpy(),
                               np.asarray(jd.basis_quality(JA, jb)), rtol=1e-8)


def _flat(JA):
    import jax

    arrays, static = jax.tree_util.tree_flatten(JA)
    return tuple(arrays), static


def test_harvest_matches_lanczos_tridiagonal(poisson):
    """The CG-coefficient tridiagonal reproduces the Lanczos Ritz values
    from the same starting vector (the same Krylov space)."""
    _, TA, b, _, _ = poisson
    bt = torch.from_numpy(b)
    Ad = TA.to_dense().numpy()
    W = harvest_deflation_basis(TA, bt, k=6, m=40).W.numpy()
    Wl = make_deflation_basis(TA, k=6, lanczos_iters=40, v0=bt).W.numpy()
    theta_h = np.sort(np.diag(W.T @ Ad @ W) / np.diag(W.T @ W))
    theta_l = np.sort(np.diag(Wl.T @ Ad @ Wl) / np.diag(Wl.T @ Wl))
    np.testing.assert_allclose(theta_h, theta_l, rtol=1e-6)


def test_harvest_with_m_equal_to_n():
    """m = n on a small dense SPD system: a finite basis in both packages,
    and the deflated solve converges (tests/test_deflated.py's case)."""
    n = 24
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((n, n))
    dense = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    TA = CSRMatrix.from_dense(dense, device=CPU)
    tb = harvest_deflation_basis(TA, torch.from_numpy(b), k=4, m=n)
    jb = jd.harvest_deflation_basis(JCSR.from_dense(jnp.asarray(dense)), jnp.asarray(b), k=4, m=n)
    assert bool(torch.isfinite(tb.W).all()) and np.isfinite(np.asarray(jb.W)).all()
    x, info = deflated_cg_solve(TA, torch.from_numpy(b), tb, tol=1e-12)
    assert float(torch.linalg.vector_norm(torch.from_numpy(b) - TA.matvec(x))) < 1e-8


def test_harvest_truncates_at_exact_convergence():
    """A = 2I: the first step takes r to exactly 0, so the rho == 0 guard
    freezes alpha at 0 from the second step on, the host truncates the
    tridiagonal there (its NaN residual row unused) and the basis has one
    finite column, as in the JAX package."""
    n = 24
    dense = 2.0 * np.eye(n)
    b = np.random.default_rng(1).standard_normal(n)
    TA = CSRMatrix.from_dense(dense, device=CPU)
    _, al, be, _ = td._cg_harvest(TA, torch.from_numpy(b), 6)
    np.testing.assert_array_equal(al.numpy(), [0.5, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(be.numpy(), np.zeros(6))
    tb = harvest_deflation_basis(TA, torch.from_numpy(b), k=4, m=6)
    jb = jd.harvest_deflation_basis(JCSR.from_dense(jnp.asarray(dense)), jnp.asarray(b), k=4, m=6)
    assert tb.k == np.asarray(jb.W).shape[1] == 1
    np.testing.assert_allclose(np.abs(tb.W.numpy()), np.abs(np.asarray(jb.W)), rtol=1e-14)


def test_return_x_warm_starts_the_first_solve(poisson):
    JA, TA, b, _, _ = poisson
    tb, x_m = harvest_deflation_basis(TA, torch.from_numpy(b), k=12, m=80, return_x=True)
    _, jx = jd.harvest_deflation_basis(JA, jnp.asarray(b), k=12, m=80, return_x=True)
    assert x_m.dtype == torch.float64 and x_m.shape == (TA.shape[0],)
    np.testing.assert_allclose(x_m.numpy(), np.asarray(jx), rtol=1e-10)
    _, i_cold = deflated_cg_solve(TA, torch.from_numpy(b), tb, tol=1e-10)
    x, i_warm = deflated_cg_solve(TA, torch.from_numpy(b), tb, x0=x_m, tol=1e-10)
    assert int(i_warm.iterations) < int(i_cold.iterations)
    assert float(torch.linalg.vector_norm(torch.from_numpy(b) - TA.matvec(x))) < 1e-8


def test_recycled_basis_speeds_an_unrelated_solve(poisson):
    """Harvest from a solve on b, deflate a solve on another b2: fewer
    iterations than plain CG, and the JAX package's count."""
    JA, TA, b, _, _ = poisson
    b2 = np.random.default_rng(3).standard_normal(TA.shape[0])
    _, i_plain = cg_solve(TA, torch.from_numpy(b2), tol=1e-10)
    jb = jd.harvest_deflation_basis(JA, jnp.asarray(b), k=12, m=80)
    (_, ij), (x2, i2) = _solve_both(JA, TA, b2, jb, tol=1e-10)
    assert int(i2.iterations) == int(ij.iterations) < int(i_plain.iterations)
    _hist_close(i2.rho_history, ij.rho_history, int(ij.iterations))
    assert float(np.linalg.norm(b2 - TA.to_dense().numpy() @ x2)) < 1e-8


@pytest.mark.parametrize("iters", [30, 100])
def test_lanczos_basis_matches_jax(poisson, iters):
    """make_deflation_basis(method='lanczos'): the port's Lanczos vectors
    are the JAX ones up to sign (tests/test_torch_eigs.py), so the solves
    take the same count; quality improves with the pass length."""
    JA, TA, b, _, _ = poisson
    jb = jd.make_deflation_basis(JA, k=8, lanczos_iters=iters)
    tb = make_deflation_basis(TA, k=8, lanczos_iters=iters)
    wt, wj = tb.W.numpy(), np.asarray(jb.W)
    signs = np.sign(np.sum(wt * wj, axis=0))
    np.testing.assert_allclose(wt * signs, wj, rtol=0, atol=1e-8)
    qt = basis_quality(TA, tb).numpy()
    # the qualities of well-converged columns sit at the roundoff floor
    np.testing.assert_allclose(qt, np.asarray(jd.basis_quality(JA, jb)), rtol=1e-6, atol=1e-12)
    (_, ij), (_, it) = _solve_both(JA, TA, b, jb, tol=1e-10)
    assert int(it.iterations) == int(ij.iterations)
    if iters == 100:
        q30 = basis_quality(TA, make_deflation_basis(TA, k=8, lanczos_iters=30)).max()
        assert float(qt.max()) < float(q30)


def test_lobpcg_basis_cuts_iterations(poisson):
    """method='lobpcg': LOBPCG's vectors, so the same basis as the JAX
    package's to the eigensolver's tolerance; with a v0 the starting block
    is drawn from numpy here (jax.random there), so only its quality and
    the iteration cut are held."""
    JA, TA, b, _, plain = poisson
    bt = torch.from_numpy(b)
    tb = make_deflation_basis(TA, k=8, method="lobpcg", maxiter=60)
    jb = jd.make_deflation_basis(JA, k=8, method="lobpcg", maxiter=60)
    # poisson2d(24) has pairs of equal eigenvalues, within which each
    # package's Ritz vectors are any basis: the sorted qualities agree to
    # 1e-3 of the worst column
    qt, qj = np.sort(basis_quality(TA, tb).numpy()), np.sort(np.asarray(jd.basis_quality(JA, jb)))
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-3 * qj.max())
    x, info = deflated_cg_solve(TA, bt, tb, tol=1e-10)
    assert int(info.iterations) < plain
    assert float(torch.linalg.vector_norm(bt - TA.matvec(x))) < 1e-8
    tv = make_deflation_basis(TA, k=8, method="lobpcg", maxiter=60, v0=bt)
    jv = jd.make_deflation_basis(JA, k=8, method="lobpcg", maxiter=60, v0=jnp.asarray(b))
    qt, qj = float(basis_quality(TA, tv).max()), float(jd.basis_quality(JA, jv).max())
    assert qt < 0.5 and qj < 0.5
    x, info = deflated_cg_solve(TA, bt, tv, tol=1e-10)
    assert int(info.iterations) < plain


def test_preconditioned_lobpcg_harvest_quality(poisson):
    _, TA, _, _, _ = poisson
    M = jacobi_preconditioner(TA)
    q_plain = float(basis_quality(TA, make_deflation_basis(TA, k=6, method="lobpcg",
                                                           maxiter=25)).max())
    q_prec = float(basis_quality(TA, make_deflation_basis(TA, k=6, method="lobpcg",
                                                          maxiter=25, M=M)).max())
    assert q_prec <= q_plain * 1.5


def test_method_and_k_validation(poisson):
    _, TA, b, _, _ = poisson
    with pytest.raises(ValueError, match="lanczos.*lobpcg"):
        make_deflation_basis(TA, k=4, method="arnoldi")
    with pytest.raises(ValueError, match="lobpcg"):
        make_deflation_basis(TA, k=4, M=lambda z: z)
    with pytest.raises(ValueError, match="maxiter"):
        make_deflation_basis(TA, k=4, method="lobpcg", lanczos_iters=10)
    with pytest.raises(ValueError, match="k"):
        make_deflation_basis(TA, k=50, lanczos_iters=10)
    with pytest.raises(ValueError, match="k"):
        harvest_deflation_basis(TA, torch.from_numpy(b), k=50, m=10)


def test_with_jacobi_matches_jax(poisson):
    JA, TA, b, V, _ = poisson
    jbasis = jd.deflation_basis_from_vectors(JA, jnp.asarray(V[:, :12]))
    _, i_pcg = cg_solve(TA, torch.from_numpy(b), tol=1e-10, M=jacobi_preconditioner(TA))
    (_, ij), (x, it) = _solve_both(JA, TA, b, jbasis, tol=1e-10,
                                   jM=jcg.jacobi_preconditioner(JA),
                                   tM=jacobi_preconditioner(TA))
    assert int(it.iterations) == int(ij.iterations) < int(i_pcg.iterations)
    _hist_close(it.rho_history, ij.rho_history, int(ij.iterations))
    assert float(np.linalg.norm(b - TA.to_dense().numpy() @ x)) < 1e-8


def test_with_chebyshev_matches_jax(poisson):
    """Deflation with the Chebyshev preconditioner, at tol 1e-8·‖b‖ (off the
    float64 roundoff floor): the JAX package's count and a true residual
    under the tolerance (ROADMAP §3)."""
    from conjugategradient_tpu.solver import chebyshev_preconditioner as jcheb
    from conjugategradient_tpu.solver import estimate_spectral_bounds as jbounds

    JA, TA, b, V, _ = poisson
    tol = 1e-8 * float(np.linalg.norm(b))
    jlo, jhi = jbounds(JA, iters=40)
    lo, hi = estimate_spectral_bounds(TA, iters=40)
    np.testing.assert_allclose([lo, hi], [jlo, jhi], rtol=1e-10)
    jbasis = jd.deflation_basis_from_vectors(JA, jnp.asarray(V[:, :8]))
    (_, ij), (x, it) = _solve_both(JA, TA, b, jbasis, tol=tol,
                                   jM=jcheb(JA, jlo, jhi, degree=4),
                                   tM=chebyshev_preconditioner(TA, lo, hi, degree=4))
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged)
    assert float(np.linalg.norm(b - TA.to_dense().numpy() @ x)) < tol


def test_warm_start(poisson):
    _, TA, b, V, _ = poisson
    bt = torch.from_numpy(b)
    tbasis = deflation_basis_from_vectors(TA, torch.from_numpy(V[:, :8]))
    x0, _ = deflated_cg_solve(TA, bt, tbasis, tol=1e-4)
    x, info = deflated_cg_solve(TA, bt, tbasis, x0=x0, tol=1e-10)
    _, cold = deflated_cg_solve(TA, bt, tbasis, tol=1e-10)
    assert int(info.iterations) < int(cold.iterations)
    assert float(torch.linalg.vector_norm(bt - TA.matvec(x))) < 1e-8


def test_cap_and_masked_steps(poisson):
    """maxiter caps the loop (not converged, k == cap, the history NaN past
    it); a solve that is done at once (b = 0) takes one step, converged."""
    JA, TA, b, V, _ = poisson
    jbasis = jd.deflation_basis_from_vectors(JA, jnp.asarray(V[:, :8]))
    (_, ij), (_, it) = _solve_both(JA, TA, b, jbasis, tol=1e-10, maxiter=7)
    assert int(it.iterations) == int(ij.iterations) == 7 and not bool(it.converged)
    assert np.isnan(it.rho_history.numpy()[8:]).all() if it.rho_history.numel() > 8 else True
    _hist_close(it.rho_history, ij.rho_history, 7)
    zero = np.zeros_like(b)
    (xj, ij), (xt, it) = _solve_both(JA, TA, zero, jbasis, tol=1e-10)
    assert int(it.iterations) == int(ij.iterations) == 1 and bool(it.converged)
    assert not np.any(xt)


@pytest.mark.parametrize("layout", ["dia", "bell"])
def test_float32_layouts_match_jax(poisson, layout):
    """float32 DIA (kernel 7's plain version here) and blocked-ELL (the
    packed kernel 5's plain version: sparse 8 x 8 tiles), with a float32
    basis from the float64 eigenvectors, at 1e-4·‖b‖: both packages
    converge, counts within 2, true residuals under 2x the tolerance."""
    JA, TA, b, V, _ = poisson
    rows, cols, vals, shape = poisson2d_coo(24)
    j32 = JCSR.from_coo(rows, cols, np.asarray(vals, np.float32), shape)
    t32 = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device=CPU)
    if layout == "dia":
        jop, top = JDIA.from_csr(j32), DIAMatrix.from_csr(t32)
    else:
        jop, top = JBell.from_csr(j32, 8, 8), BlockedEllMatrix.from_csr(t32, 8, 8)
    W = V[:, :8].astype(np.float32)
    jbasis = jd.deflation_basis_from_vectors(jop, jnp.asarray(W))
    tbasis = deflation_basis_from_vectors(top, torch.from_numpy(W))
    assert tbasis.W.dtype == torch.float32
    b32 = b.astype(np.float32)
    tol = 1e-4 * float(np.linalg.norm(b))
    xj, ij = jd.deflated_cg_solve(jop, jnp.asarray(b32), jbasis, tol=tol)
    xt, it = deflated_cg_solve(top, torch.from_numpy(b32), tbasis, tol=tol)
    assert bool(it.converged) and bool(ij.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    dense = TA.to_dense().numpy()
    assert np.linalg.norm(b - dense @ xt.numpy().astype(np.float64)) < 2 * tol
