"""The port's solvers against the JAX package and the f64 oracle (CPU).

* f32 fused solve (plain kernel versions) vs the JAX fused solve in
  interpret mode, plain CG and Jacobi PCG, with the storage-parity bars of
  tests/test_symbell.py::_assert_storage_parity (matching 25-step residual
  trajectories to rtol 5e-2, both converge, iteration counts within 8,
  solutions to rtol 1e-3): f32 sums in another order cannot give equal
  iteration counts, only matching trajectories.
* f64 portable cg_solve vs oracle.reference_cg / reference_pcg: equal
  iteration counts, rho_history to 1e-6 relative above the converged tail.
* maxiter, zero RHS, warm start at the solution (the ρ == 0 guard), and
  bitwise-repeatable histories.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import SymBellMatrix as JSym
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch.oracle import csr_matvec_np_fast, reference_cg, reference_pcg
from conjugategradient_tpu_torch.ops import blas, spmv
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import (
    accuracy,
    cg_solve,
    expected_step_count,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    fused_supported,
    jacobi_preconditioner,
)
from conjugategradient_tpu_torch.types import CSRMatrix, DenseOperator


def _jax_sym_f32(rows, cols, vals, shape, bm=8):
    csr = JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32)
    return JSym.from_bell(JBell.from_csr(csr, bm=bm, bn=bm))


def _port(jsym):
    return convert.sym_bell_from_arrays(
        np.asarray(jsym.diag_blocks), np.asarray(jsym.off_blocks),
        np.asarray(jsym.off_cols), jsym.shape, jsym.nnz, jsym.full_kmax,
        jsym.banded, device="cpu")


def _assert_trajectory_parity(solve_jax, solve_port, n_fixed=25):
    _, ij0 = solve_jax(0.0, n_fixed)
    _, it0 = solve_port(0.0, n_fixed)
    hj = np.asarray(ij0.rho_history[1: n_fixed + 1], np.float64)
    ht = it0.rho_history[1: n_fixed + 1].double().numpy()
    np.testing.assert_allclose(ht, hj, rtol=5e-2)
    xj, ij = solve_jax(1e-5, 400)
    xt, it = solve_port(1e-5, 400)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 8
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-4)
    return ij, it


@pytest.fixture(scope="module")
def poisson12():
    rows, cols, vals, shape = poisson2d_coo(12)
    jsym = _jax_sym_f32(rows, cols, vals, shape)
    b = reference_rhs(shape[0]).astype(np.float32)
    inv_d = (1.0 / np.asarray(jsym.diagonal())).astype(np.float32)
    return jsym, _port(jsym), b, inv_d


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_fused_f32_matches_jax_fused_interpret(poisson12, precond):
    jsym, tsym, b, inv_d = poisson12
    if precond == "none":
        sj = lambda tol, mi: jfused.fused_bell_cg_solve(
            jsym, jnp.asarray(b), tol=tol, maxiter=mi, interpret=True)
        st = lambda tol, mi: fused_bell_cg_solve(
            tsym, torch.from_numpy(b), tol=tol, maxiter=mi)
    else:
        sj = lambda tol, mi: jfused.fused_bell_pcg_solve(
            jsym, jnp.asarray(b), jnp.asarray(inv_d), tol=tol, maxiter=mi, interpret=True)
        st = lambda tol, mi: fused_bell_pcg_solve(
            tsym, torch.from_numpy(b), torch.from_numpy(inv_d), tol=tol, maxiter=mi)
    _assert_trajectory_parity(sj, st)


def test_fused_banded_auto_matches_jax():
    """Block-tridiagonal storage: mirror='auto' is the banded landing on
    both sides."""
    rng = np.random.default_rng(2)
    nrb, bm = 16, 8
    n = nrb * bm
    A = np.zeros((n, n), np.float32)
    for i in range(nrb):
        D = rng.standard_normal((bm, bm)).astype(np.float32)
        A[i * bm:(i + 1) * bm, i * bm:(i + 1) * bm] = D + D.T + 20 * np.eye(bm, dtype=np.float32)
        if i + 1 < nrb:
            B = rng.standard_normal((bm, bm)).astype(np.float32)
            A[i * bm:(i + 1) * bm, (i + 1) * bm:(i + 2) * bm] = B
            A[(i + 1) * bm:(i + 2) * bm, i * bm:(i + 1) * bm] = B.T
    rows, cols = np.nonzero(A)
    jsym = _jax_sym_f32(rows, cols, A[rows, cols], (n, n))
    tsym = _port(jsym)
    assert jfused._auto_mirror(jsym) == "banded"
    from conjugategradient_tpu_torch.solver.fused import _auto_mirror

    assert _auto_mirror(tsym) == "banded"
    b = rng.standard_normal(n).astype(np.float32)
    _assert_trajectory_parity(
        lambda tol, mi: jfused.fused_bell_cg_solve(jsym, jnp.asarray(b), tol=tol,
                                                   maxiter=mi, interpret=True),
        lambda tol, mi: fused_bell_cg_solve(tsym, torch.from_numpy(b), tol=tol, maxiter=mi),
        n_fixed=15,
    )


def _oracle_check(A_port, matvec, b, tol, hist_floor=1e-15, M=None, minv=None, x0=None):
    if minv is None:
        ora = reference_cg(matvec, b, x0=x0, tol=tol)
    else:
        ora = reference_pcg(matvec, b, minv, x0=x0, tol=tol)
    x, info = cg_solve(A_port, torch.from_numpy(b),
                       None if x0 is None else torch.from_numpy(x0), tol=tol, M=M)
    assert int(info.iterations) == ora.iterations
    assert bool(info.converged) == ora.converged
    k = ora.iterations
    got = info.rho_history.numpy()[: k + 1]
    want = ora.rho_history[: k + 1]
    sel = want > want[0] * hist_floor
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-6)
    np.testing.assert_allclose(x.numpy(), ora.x, rtol=1e-8, atol=1e-10)
    return info


@pytest.mark.parametrize("problem", ["poisson2d", "banded"])
def test_f64_portable_matches_oracle(problem):
    if problem == "poisson2d":
        rows, cols, vals, shape = poisson2d_coo(20)
        tol = 1e-10
    else:
        rows, cols, vals, shape = banded_spd_coo(300, bandwidth=5, seed=5)
        tol = 1e-9
    A = CSRMatrix.from_coo(rows, cols, vals, shape, device="cpu")
    d, i, p = A.data.numpy(), A.indices.numpy(), A.indptr.numpy()
    b = reference_rhs(shape[0])
    _oracle_check(A, lambda x: csr_matvec_np_fast(d, i, p, x), b, tol)


def test_f64_jacobi_pcg_matches_oracle():
    rows, cols, vals, shape = banded_spd_coo(300, bandwidth=5, seed=1)
    A = CSRMatrix.from_coo(rows, cols, vals, shape, device="cpu")
    d, i, p = A.data.numpy(), A.indices.numpy(), A.indptr.numpy()
    inv = 1.0 / A.diagonal().numpy()
    b = reference_rhs(shape[0])
    _oracle_check(A, lambda x: csr_matvec_np_fast(d, i, p, x), b, 1e-9,
                  M=jacobi_preconditioner(A), minv=lambda r: inv * r)


def test_f64_nonzero_x0_and_dense_match_oracle():
    rows, cols, vals, shape = poisson2d_coo(9)
    A = CSRMatrix.from_coo(rows, cols, vals, shape, device="cpu")
    d, i, p = A.data.numpy(), A.indices.numpy(), A.indptr.numpy()
    b = reference_rhs(shape[0])
    x0 = np.linspace(-1, 1, shape[0])
    _oracle_check(A, lambda x: csr_matvec_np_fast(d, i, p, x), b, 1e-10, x0=x0)
    dense = A.to_dense()
    _oracle_check(DenseOperator(dense), lambda x: dense.numpy() @ x, b, 1e-10,
                  hist_floor=1e-10)


@pytest.fixture(scope="module")
def small_sym():
    rows, cols, vals, shape = poisson2d_coo(8)
    jsym = _jax_sym_f32(rows, cols, vals, shape)
    return jsym, _port(jsym), (rows, cols, vals, shape)


def _solvers(tsym):
    return {"fused": lambda b, **kw: fused_bell_cg_solve(tsym, b.float(), **kw),
            "portable": lambda b, **kw: cg_solve(tsym, b.float(), fused="never", **kw)}


@pytest.mark.parametrize("path", ["fused", "portable"])
def test_maxiter_cap(small_sym, path):
    _, tsym, _ = small_sym
    b = torch.from_numpy(reference_rhs(tsym.n))
    x, info = _solvers(tsym)[path](b, tol=0.0, maxiter=7)
    assert int(info.iterations) == 7 and not bool(info.converged)
    assert info.rho_history.shape == (8,) and torch.isfinite(info.rho_history).all()


@pytest.mark.parametrize("path", ["fused", "portable"])
def test_zero_rhs(small_sym, path):
    jsym, tsym, _ = small_sym
    x, info = _solvers(tsym)[path](torch.zeros(tsym.n), tol=1e-6)
    _, jinfo = jcg.cg_solve(jsym, jnp.zeros(tsym.n, jnp.float32), tol=1e-6, fused="never")
    assert int(info.iterations) == int(jinfo.iterations) == 1
    assert bool(info.converged) and torch.all(x == 0)


@pytest.mark.parametrize("path", ["fused", "portable"])
def test_warm_start_at_solution_keeps_x(small_sym, path):
    """x0 integer, A integer: b = A x0 exactly, so ρ₀ == 0 and the guard
    keeps α = β = 0 — x comes back bit-identical after one body."""
    jsym, tsym, (rows, cols, vals, shape) = small_sym
    n = shape[0]
    x0 = (np.arange(n) % 7 - 3).astype(np.float32)
    A = np.zeros(shape, np.float64)
    np.add.at(A, (rows, cols), vals)
    b = (A @ x0).astype(np.float32)
    tb, tx0 = torch.from_numpy(b), torch.from_numpy(x0)
    if path == "fused":
        x, info = fused_bell_cg_solve(tsym, tb, tx0, tol=1e-6)
    else:
        x, info = cg_solve(tsym, tb, tx0, tol=1e-6, fused="never")
    _, jinfo = jcg.cg_solve(jsym, jnp.asarray(b), jnp.asarray(x0), tol=1e-6, fused="never")
    assert float(info.rho_history[0]) == 0.0
    assert int(info.iterations) == int(jinfo.iterations) == 1
    assert torch.equal(x, tx0)


def test_pcg_warm_start_guard(small_sym):
    _, tsym, (rows, cols, vals, shape) = small_sym
    x0 = torch.ones(shape[0])
    b = tsym.matvec(x0)
    inv_d = 1.0 / tsym.diagonal()
    x, info = fused_bell_pcg_solve(tsym, b, inv_d, x0, tol=0.0, maxiter=5)
    assert torch.equal(x, x0) and int(info.iterations) == 1


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_fused_history_bitwise_repeatable(small_sym, precond):
    _, tsym, _ = small_sym
    b = torch.from_numpy(reference_rhs(tsym.n).astype(np.float32))
    M = jacobi_preconditioner(tsym) if precond else None
    runs = []
    for _ in range(2):
        if M is None:
            _, info = fused_bell_cg_solve(tsym, b, tol=1e-4)
        else:
            _, info = fused_bell_pcg_solve(tsym, b, M.inv_diag, tol=1e-4)
        runs.append(info.rho_history.view(torch.int32).clone())
    assert torch.equal(runs[0], runs[1])


def test_cg_solve_dispatch_rules(small_sym):
    _, tsym, _ = small_sym
    b = torch.ones(tsym.n)
    with pytest.raises(ValueError, match="fused must be"):
        cg_solve(tsym, b, fused="sometimes")
    # residual replacement runs on both loops
    _, info = cg_solve(tsym, b, tol=1e-4, recompute_r_every=10)
    assert bool(info.converged)
    _, info = fused_bell_cg_solve(tsym, b, tol=1e-4, recompute_r_every=10)
    assert bool(info.converged)
    # the fused path needs CUDA tensors: on the CPU "always" refuses and
    # "auto" runs the portable loop
    assert not fused_supported(tsym, dtype=torch.float32)
    with pytest.raises(ValueError, match="fused='always'"):
        cg_solve(tsym, b, fused="always")
    _, info = cg_solve(tsym, b, tol=1e-4)
    assert bool(info.converged)
    with pytest.raises(ValueError, match="fused='always'"):
        cg_solve(tsym, b, fused="always", M=lambda r: r)


def test_spmv_blas_accuracy_match_jax():
    rows, cols, vals, shape = poisson2d_coo(10)
    jA = JCSR.from_coo(rows, cols, vals, shape)
    tA = convert.csr_from_arrays(np.asarray(jA.data), np.asarray(jA.indices),
                                 np.asarray(jA.indptr), shape, device="cpu")
    x = np.random.default_rng(0).standard_normal(shape[0])
    np.testing.assert_allclose(spmv.csr_spmv(tA, torch.from_numpy(x)).numpy(),
                               np.asarray(jA.matvec(jnp.asarray(x))), rtol=1e-13)
    np.testing.assert_allclose(tA.diagonal().numpy(), np.asarray(jA.diagonal()))
    jsym = JSym.from_bell(JBell.from_csr(jA, bm=8, bn=8))
    tsym = _port(jsym)
    np.testing.assert_allclose(tsym.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jsym.matvec(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(tsym.diagonal().numpy(), np.asarray(jsym.diagonal()))
    y = x[::-1].copy()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(float(blas.dot(tx, ty)), float(x @ y), rtol=1e-13)
    np.testing.assert_allclose(float(blas.norm_sq(tx)), float(x @ x), rtol=1e-13)
    np.testing.assert_allclose(blas.saxpby(2.0, tx, -3.0, ty).numpy(), 2 * x - 3 * y)
    np.testing.assert_allclose(blas.sapbx(tx, 0.5, ty).numpy(), x + 0.5 * y)
    np.testing.assert_allclose(blas.sambx(tx, 0.5, ty).numpy(), x - 0.5 * y)
    np.testing.assert_allclose(
        float(accuracy(tA, torch.from_numpy(y), tx)),
        float(jcg.accuracy(jA, jnp.asarray(y), jnp.asarray(x))), rtol=1e-12)


def test_expected_step_count_matches_jax():
    rows, cols, vals, shape = poisson2d_coo(10)
    jA = JCSR.from_coo(rows, cols, vals, shape)
    tA = CSRMatrix.from_coo(rows, cols, vals, shape, device="cpu")
    from conjugategradient_tpu.solver.cg import expected_step_count as jesc

    for eps in (1e-3, 1e-8):
        assert abs(expected_step_count(tA, eps) - jesc(jA, eps)) <= 1
    with pytest.raises(ValueError):
        expected_step_count(tA, 1.5)
