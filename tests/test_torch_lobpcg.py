"""The port's LOBPCG (``solver/lobpcg.py``) against the JAX package's, on
the same numpy inputs (CPU, float64), mirroring ``tests/test_lobpcg.py``.

Both packages draw the same starting blocks (``np.random.default_rng``).
Tolerances, with their reasons: eigenvalues within 1e-10 relative of the
JAX package's and within 1e-8 of a dense ``eigh`` (the solve's own
tolerance); the eigenvalue history within 1e-10 of its largest value on
the common iterations; the residual history within 1e-6 relative on the
entries above 1e-5·θ (below that rounding noise enters: 2.7e-6 measured
above 1e-6·θ, and a converged pair's residual is noise, 1e-16 to 1e-12,
which feeds the next search block, so the two packages' trajectories part
there); iteration counts within ITER_SLACK = 3 of the JAX package's at
tolerances of 1e-9·θ and above (the last pair crosses the tolerance a few
steps apart once the converged pairs' noise steers the block: measured
equal from seed 0, up to 3 of 164 from seed 7 across the five layouts at
1e-9, equal or 1 apart at 1e-8; on random_spd_dense(40), whose two
smallest eigenvalues are 1 and 1.125, equal at 1e-8 but 4 apart at 1e-9
and 36 of 377 at 1e-10, so its counts are held at 1e-8); eigenvectors
within 1e-6 up to each column's sign, on a spectrum without repeated
eigenvalues (the residual over the gap bounds them).  Eigenvector and QR
column signs may differ between the two LAPACKs; values and residuals do
not depend on them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (CSRMatrix, DIAMatrix, EigsResult, fsai_preconditioner,
                                         jacobi_preconditioner, lobpcg_eigs,
                                         smoothed_aggregation_preconditioner)
from conjugategradient_tpu_torch.problems import (banded_spd_coo, poisson2d_coo,
                                                  random_spd_dense)

CPU = "cpu"
ITER_SLACK = 3


@pytest.fixture(scope="module")
def poisson20():
    rows, cols, vals, shape = poisson2d_coo(20)
    JA = JCSR.from_coo(rows, cols, vals, shape)
    TA = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    w = np.linalg.eigvalsh(TA.to_dense().numpy())
    return JA, TA, w


def _both(JA, TA, **kw):
    rj = jcg.lobpcg_eigs(JA, return_history=True, **kw)
    rt = lobpcg_eigs(TA, return_history=True, **kw)
    return rj, rt


def _check_histories(rj, rt):
    (resj, lamj, rnj), (rest, lamt, rnt) = rj, rt
    assert lamt.shape == (rest.iters + 1, len(rest.values)) == rnt.shape
    m = min(len(lamj), len(lamt))
    np.testing.assert_allclose(lamt[:m], lamj[:m], rtol=0, atol=1e-10 * np.abs(lamj).max())
    theta = np.abs(lamj).max()
    keep = rnj[:m] > 1e-5 * theta
    np.testing.assert_allclose(rnt[:m][keep], rnj[:m][keep], rtol=1e-6)
    np.testing.assert_allclose(lamt[-1], rest.values, rtol=0)
    np.testing.assert_allclose(rnt[-1], rest.residuals, rtol=0)


@pytest.mark.parametrize("which,k,tol", [("smallest", 4, 1e-9), ("smallest", 4, 1e-8),
                                          ("largest", 3, 1e-9), ("largest", 3, 1e-6)])
def test_matches_jax_and_dense(poisson20, which, k, tol):
    JA, TA, w = poisson20
    rj, rt = _both(JA, TA, k=k, which=which, tol=tol, maxiter=400)
    resj, rest = rj[0], rt[0]
    assert isinstance(rest, EigsResult)
    assert np.all(rest.converged) and np.all(resj.converged)
    assert abs(rest.iters - resj.iters) <= ITER_SLACK
    np.testing.assert_allclose(rest.values, resj.values, rtol=1e-10)
    ref = w[:k] if which == "smallest" else w[::-1][:k]
    np.testing.assert_allclose(rest.values, ref, rtol=1e-8)
    _check_histories(rj, rt)
    # the residuals really are ||A x - lam x||
    X = rest.vectors.numpy()
    Ad = TA.to_dense().numpy()
    rn = np.linalg.norm(Ad @ X - X * rest.values[None, :], axis=0)
    np.testing.assert_allclose(rest.residuals, rn, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(X.T @ X, np.eye(k), atol=1e-10)


def test_vectors_match_jax_up_to_sign():
    A = random_spd_dense(60, seed=3)
    rj = jcg.lobpcg_eigs(jnp.asarray(A), k=3, tol=1e-10, maxiter=400)
    rt = lobpcg_eigs(torch.from_numpy(A), k=3, tol=1e-10, maxiter=400)
    assert abs(rt.iters - rj.iters) <= ITER_SLACK
    vt, vj = rt.vectors.numpy(), np.asarray(rj.vectors)
    signs = np.sign(np.sum(vt * vj, axis=0))
    np.testing.assert_allclose(vt * signs, vj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.values, np.linalg.eigvalsh(A)[:3], rtol=1e-8)


def test_generalized_pencil_matches_jax_and_scipy():
    import scipy.linalg

    rng = np.random.default_rng(11)
    n = 60
    A = random_spd_dense(n, seed=4)
    C = rng.standard_normal((n, n)) / np.sqrt(n)
    B = C @ C.T + np.eye(n)
    w_ref = scipy.linalg.eigh(A, B, eigvals_only=True)
    rj = jcg.lobpcg_eigs(jnp.asarray(A), k=3, B=jnp.asarray(B), tol=1e-9, maxiter=500)
    rt = lobpcg_eigs(torch.from_numpy(A), k=3, B=torch.from_numpy(B), tol=1e-9, maxiter=500)
    assert abs(rt.iters - rj.iters) <= ITER_SLACK
    np.testing.assert_allclose(rt.values, rj.values, rtol=1e-10)
    np.testing.assert_allclose(rt.values, w_ref[:3], rtol=1e-7)
    X = rt.vectors.numpy()
    np.testing.assert_allclose(X.T @ B @ X, np.eye(3), atol=1e-6)
    rn = np.linalg.norm(A @ X - (B @ X) * rt.values[None, :], axis=0)
    np.testing.assert_allclose(rt.residuals, rn, rtol=1e-5, atol=1e-10)


def test_generalized_identity_B_matches_standard(poisson20):
    _, TA, _ = poisson20
    n = TA.shape[0]
    std = lobpcg_eigs(TA, k=3, tol=1e-9, maxiter=400, seed=3)
    gen = lobpcg_eigs(TA, k=3, B=torch.eye(n, dtype=torch.float64), tol=1e-9, maxiter=400,
                      seed=3)
    np.testing.assert_allclose(gen.values, std.values, rtol=1e-9)


def _scaled_laplacian():
    import scipy.sparse as sp

    rows, cols, vals, shape = poisson2d_coo(20)
    L = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    s = np.exp(np.random.default_rng(9).uniform(-1.5, 1.5, shape[0]))
    A_sp = (sp.diags(s) @ L @ sp.diags(s)).tocsr()
    return A_sp, shape


@pytest.mark.parametrize("make_m", [
    # Jacobi needs a varying diagonal to help, so every case runs on the
    # diagonally scaled Laplacian (tests/test_lobpcg.py)
    lambda A, j: (jcg.jacobi_preconditioner(A) if j else jacobi_preconditioner(A)),
    lambda A, j: (jcg.fsai_preconditioner(A, power=2, dtype=np.float64) if j
                  else fsai_preconditioner(A, power=2, dtype=torch.float64)),
    lambda A, j: (jcg.smoothed_aggregation_preconditioner(A, dtype=np.float64) if j
                  else smoothed_aggregation_preconditioner(A, dtype=torch.float64)),
], ids=["jacobi", "fsai2", "amg"])
def test_preconditioner_cuts_iterations_as_in_jax(make_m):
    A_sp, shape = _scaled_laplacian()
    JA = JCSR.from_arrays(A_sp.data, A_sp.indices, A_sp.indptr, tuple(shape))
    TA = CSRMatrix.from_scipy(A_sp, device=CPU)
    w = np.linalg.eigvalsh(A_sp.toarray())
    plain = lobpcg_eigs(TA, k=4, tol=1e-8, maxiter=800)
    pre = lobpcg_eigs(TA, k=4, M=make_m(TA, False), tol=1e-8, maxiter=800)
    jpre = jcg.lobpcg_eigs(JA, k=4, M=make_m(JA, True), tol=1e-8, maxiter=800)
    assert np.all(pre.converged)
    np.testing.assert_allclose(pre.values, w[:4], rtol=1e-6)
    np.testing.assert_allclose(pre.values, jpre.values, rtol=1e-9)
    assert pre.iters < plain.iters, (pre.iters, plain.iters)
    assert abs(pre.iters - jpre.iters) <= ITER_SLACK


def _layout(name, csr, types):
    if name == "bell":
        return types.BlockedEllMatrix.from_csr(csr, 8, 8)
    if name == "symbell":
        return types.SymBellMatrix.from_csr(csr, 8, 8)
    if name == "sell":
        return types.SellMatrix.from_csr(csr)
    if name == "dia":
        return types.DIAMatrix.from_csr(csr)
    return types.SymDIAMatrix.from_csr(csr)


@pytest.mark.parametrize("layout", ["bell", "symbell", "sell", "dia", "symdia"])
def test_layouts_with_a_multi_rhs_spmv_agree(poisson20, layout):
    """Each layout with a multi-RHS SpMV runs the block matvec through it
    (solver/batched._MULTI) and gives CSR's pairs and the JAX package's on
    the same layout."""
    import conjugategradient_tpu.types as jtypes
    import conjugategradient_tpu_torch.types as ttypes

    JA, TA, w = poisson20
    op = _layout(layout, TA, ttypes)
    res = lobpcg_eigs(op, k=4, tol=1e-9, maxiter=400, seed=7)
    ref = lobpcg_eigs(TA, k=4, tol=1e-9, maxiter=400, seed=7)
    jres = jcg.lobpcg_eigs(_layout(layout, JA, jtypes), k=4, tol=1e-9, maxiter=400, seed=7)
    np.testing.assert_allclose(res.values, ref.values, rtol=1e-9)
    np.testing.assert_allclose(res.values, jres.values, rtol=1e-9)
    np.testing.assert_allclose(res.values, w[:4], rtol=1e-8)
    assert abs(res.iters - jres.iters) <= ITER_SLACK


def test_block_matvec_takes_the_multi_form(poisson20, monkeypatch):
    """The block matvec of a DIA operator is dia_spmv_multi, once per
    application of A to the (n, 3k) basis, never the per-column matvec."""
    from conjugategradient_tpu_torch.solver import batched

    _, TA, _ = poisson20
    op = DIAMatrix.from_csr(TA)
    calls = []
    real = batched._MULTI[DIAMatrix]
    monkeypatch.setitem(batched._MULTI, DIAMatrix,
                        lambda a, X: calls.append(X.shape[1]) or real(a, X))
    monkeypatch.setattr(DIAMatrix, "matvec", lambda self, x: pytest.fail("per-column matvec"))
    res = lobpcg_eigs(op, k=3, tol=1e-6, maxiter=5)
    assert calls[0] == 3 and set(calls[1:]) == {9} and len(calls) == res.iters + 1


def test_deterministic(poisson20):
    _, TA, _ = poisson20
    a = lobpcg_eigs(TA, k=3, tol=1e-8, maxiter=200, seed=5)
    b = lobpcg_eigs(TA, k=3, tol=1e-8, maxiter=200, seed=5)
    assert a.iters == b.iters
    np.testing.assert_array_equal(a.values, b.values)
    assert torch.equal(a.vectors, b.vectors)


def test_x0_warm_start(poisson20):
    _, TA, w = poisson20
    ref = lobpcg_eigs(TA, k=3, tol=1e-9, maxiter=400)
    warm = lobpcg_eigs(TA, k=3, X0=ref.vectors, tol=1e-9, maxiter=400)
    assert warm.iters <= 2, warm.iters
    np.testing.assert_allclose(warm.values, w[:3], rtol=1e-8)


def test_dense_and_matvec_ingest():
    A = random_spd_dense(40, seed=3)
    w = np.linalg.eigvalsh(A)
    res = lobpcg_eigs(A, k=2, tol=1e-10, maxiter=400)
    np.testing.assert_allclose(res.values, w[:2], rtol=1e-8)
    At = torch.from_numpy(A)
    res_mv = lobpcg_eigs(lambda x: At @ x, k=2, n=40, tol=1e-10, maxiter=400,
                         dtype=torch.float64, device=CPU)
    np.testing.assert_allclose(res_mv.values, w[:2], rtol=1e-8)
    res_mv = lobpcg_eigs(lambda x: At @ x, k=2, n=40, tol=1e-8, maxiter=400,
                         dtype=torch.float64, device=CPU)
    jres = jcg.lobpcg_eigs(lambda x: jnp.asarray(A) @ x, k=2, n=40, tol=1e-8, maxiter=400,
                           dtype=jnp.float64)
    assert abs(res_mv.iters - jres.iters) <= ITER_SLACK


def test_banded_multiplicity():
    rows, cols, vals, shape = banded_spd_coo(150, bandwidth=3, seed=1)
    TA = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    w = np.linalg.eigvalsh(TA.to_dense().numpy())
    res = lobpcg_eigs(TA, k=5, tol=1e-9, maxiter=600)
    np.testing.assert_allclose(res.values, w[:5], rtol=1e-7)


def test_history_and_absolute_tol(poisson20):
    JA, TA, _ = poisson20
    rj, rt = _both(JA, TA, k=3, tol=1e-6, tol_absolute=True, maxiter=400)
    res = rt[0]
    assert np.all(res.converged) and np.all(res.residuals <= 1e-6)
    assert abs(res.iters - rj[0].iters) <= ITER_SLACK
    assert np.all(np.isfinite(rt[1])) and np.all(np.isfinite(rt[2]))
    _check_histories(rj, rt)


def test_nan_input_gives_nan_and_runs_to_the_cap(poisson20):
    """A NaN in X0 (standard) or in B (generalized): eigh and the Cholesky
    factorization see a non-finite matrix, and the loop gives NaN and runs
    to its cap with no exception, as the JAX package does."""
    JA, TA, _ = poisson20
    n = TA.shape[0]
    X0 = np.random.default_rng(0).standard_normal((n, 3))
    X0[5, 1] = np.nan
    rt = lobpcg_eigs(TA, k=3, X0=torch.from_numpy(X0), tol=1e-6, maxiter=6)
    rj = jcg.lobpcg_eigs(JA, k=3, X0=jnp.asarray(X0), tol=1e-6, maxiter=6)
    assert rt.iters == rj.iters == 6
    assert np.isnan(rt.values).all() and np.isnan(np.asarray(rj.values)).all()
    assert not rt.converged.any()
    B = np.eye(n)
    B[3, 3] = np.nan
    rt = lobpcg_eigs(TA, k=3, B=torch.from_numpy(B), tol=1e-6, maxiter=4)
    rj = jcg.lobpcg_eigs(JA, k=3, B=jnp.asarray(B), tol=1e-6, maxiter=4)
    assert rt.iters == rj.iters == 4
    assert np.isnan(rt.values).all() and np.isnan(np.asarray(rj.values)).all()


def test_guards(poisson20):
    _, TA, _ = poisson20
    n = TA.shape[0]
    with pytest.raises(ValueError, match="which"):
        lobpcg_eigs(TA, which="middle")
    with pytest.raises(ValueError, match="k >= 1"):
        lobpcg_eigs(TA, k=0)
    with pytest.raises(ValueError, match="3k <= n"):
        lobpcg_eigs(random_spd_dense(8, seed=0), k=3)
    with pytest.raises(ValueError, match="X0 must have shape"):
        lobpcg_eigs(TA, k=3, X0=torch.zeros((n, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="maxiter"):
        lobpcg_eigs(TA, maxiter=0)
    with pytest.raises(ValueError, match="B must match"):
        lobpcg_eigs(TA, k=3, B=torch.eye(n - 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="n="):
        lobpcg_eigs(lambda x: x, k=2)
