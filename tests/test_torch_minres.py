"""The port's portable MINRES loop against the JAX package's (CPU), on the
same numpy inputs.

Tolerances, with their reasons:

* float64 against ``conjugategradient_tpu.minres_solve(fused="never")``:
  equal iteration counts; ``rnorm_history`` to rtol 1e-10 with an absolute
  floor of 1e-12·φ̄₀ (both run the same recurrence in f64 and only the order
  of the SpMV's and the dots' sums differs; the floor covers the converged
  tail, where a Givens sine multiplies roundoff); x to 1e-9; ``rnorm_true``
  to 1e-6·φ̄₀ absolute (it is roundoff-sized at convergence);
* on an indefinite operator roundoff grows with the iteration (and 2-D
  Poisson's multiple eigenvalues exhaust the Krylov space early, after
  which the estimates are roundoff): there the history is held to 1e-10
  over its first steps (``head``) and to 1e-6·φ̄₀ absolute after them;
* float32, a fixed 24-step run: history to rtol 1e-4 (f32 sums in another
  order, amplified along the run).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import MinresInfo, jacobi_preconditioner, minres_solve
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo
from conjugategradient_tpu_torch.solver import minres, restart
from conjugategradient_tpu_torch.types import CSRMatrix


def _poisson(nx, dtype=np.float64):
    rows, cols, vals, shape = poisson2d_coo(nx)
    return (JCSR.from_coo(rows, cols, vals, shape, dtype=dtype),
            CSRMatrix.from_coo(rows, cols, vals, shape, dtype=dtype, device="cpu"), shape[0])


def _indefinite(n, seed=3):
    """tests/test_minres.py's operator: symmetric, eigenvalues in
    [-2.5, -0.5] and [0.5, 2.5]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    half = n // 2
    eigs = np.concatenate([np.linspace(-2.5, -0.5, half), np.linspace(0.5, 2.5, n - half)])
    return Q @ np.diag(eigs) @ Q.T


def _same_solve(xj, ij, xt, it, head=None):
    k = int(ij.iterations)
    assert int(it.iterations) == k
    assert bool(it.converged) == bool(ij.converged)
    hj, ht = np.asarray(ij.rnorm_history), it.rnorm_history.numpy()
    assert ht.shape == hj.shape
    head = k + 1 if head is None else head
    np.testing.assert_allclose(ht[:head], hj[:head], rtol=1e-10, atol=1e-12 * hj[0])
    np.testing.assert_allclose(ht[head: k + 1], hj[head: k + 1], rtol=0, atol=1e-6 * hj[0])
    assert np.isnan(ht[k + 1:]).all()
    np.testing.assert_allclose(float(it.rnorm), float(ij.rnorm), rtol=1e-10, atol=1e-6 * hj[0])
    np.testing.assert_allclose(float(it.rnorm_true), float(ij.rnorm_true), atol=1e-6 * hj[0])
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-9)
    assert it.residual_norms is it.rnorm_history and isinstance(it, MinresInfo)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("with_x0", [False, True], ids=["zero", "x0"])
def test_f64_csr_poisson_matches_jax(with_x0, precond):
    jA, tA, n = _poisson(16)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    x0 = 0.1 * rng.standard_normal(n) if with_x0 else None
    jM = jcg.jacobi_preconditioner(jA) if precond == "jacobi" else None
    tM = jacobi_preconditioner(tA) if precond == "jacobi" else None
    xj, ij = jcg.minres_solve(jA, jnp.asarray(b), None if x0 is None else jnp.asarray(x0),
                              tol=1e-10, M=jM, fused="never")
    xt, it = minres_solve(tA, torch.from_numpy(b), None if x0 is None else torch.from_numpy(x0),
                          tol=1e-10, M=tM)
    assert bool(it.converged) and int(it.iterations) > 20
    _same_solve(xj, ij, xt, it)
    h = it.rnorm_history.numpy()[: int(it.iterations) + 1]
    assert np.all(np.diff(h) <= 1e-12 * h[0])  # MINRES: monotone estimates


@pytest.mark.parametrize("nx,shift,head", [(12, 0.3, None), (16, 0.3, None), (10, 0.5, None)])
def test_f64_indefinite_shift_matches_jax(nx, shift, head):
    """A − σI with σ inside the spectrum of 2-D Poisson: indefinite."""
    jA, tA, n = _poisson(nx)
    b = np.random.default_rng(1).standard_normal(n)
    kw = dict(tol=1e-6, maxiter=4 * n, shift=shift)
    xj, ij = jcg.minres_solve(jA, jnp.asarray(b), fused="never", **kw)
    xt, it = minres_solve(tA, torch.from_numpy(b), **kw)
    assert bool(it.converged)
    _same_solve(xj, ij, xt, it, head=head)
    r = b - (tA.matvec(xt).numpy() - shift * xt.numpy())
    assert np.linalg.norm(r) <= 1e-5
    np.testing.assert_allclose(float(it.rnorm_true), np.linalg.norm(r), rtol=1e-6, atol=1e-12)


def test_f64_dense_indefinite_and_callable_match_jax():
    n = 48
    Ad = _indefinite(n)
    b = np.random.default_rng(5).standard_normal(n)
    xj, ij = jcg.minres_solve(jnp.asarray(Ad), jnp.asarray(b), tol=1e-10, maxiter=4 * n,
                              fused="never")
    xt, it = minres_solve(torch.from_numpy(Ad), torch.from_numpy(b), tol=1e-10, maxiter=4 * n)
    assert bool(it.converged)
    _same_solve(xj, ij, xt, it, head=20)
    At = torch.from_numpy(Ad)
    xc, ic = minres_solve(lambda v: At @ v, torch.from_numpy(b), tol=1e-10, maxiter=4 * n, n=n)
    assert int(ic.iterations) == int(it.iterations) and torch.equal(xc, xt)
    with pytest.raises(ValueError, match="n="):
        minres_solve(lambda v: At @ v, torch.from_numpy(b))


def test_zero_rhs_and_warm_start_at_the_solution():
    jA, tA, n = _poisson(8)
    x, info = minres_solve(tA, torch.zeros(n, dtype=torch.float64), tol=0.0)
    _, ij = jcg.minres_solve(jA, jnp.zeros(n), tol=0.0, fused="never")
    assert int(info.iterations) == int(ij.iterations) == 0
    assert bool(info.converged) and bool(ij.converged) and not x.any()
    x_star = torch.from_numpy(np.random.default_rng(11).standard_normal(n))
    x, info = minres_solve(tA, tA.matvec(x_star), x_star, tol=1e-12)
    assert int(info.iterations) == 0 and bool(info.converged) and torch.equal(x, x_star)


def test_indefinite_preconditioner_is_a_nan_exit():
    jA, tA, n = _poisson(8)
    x, info = minres_solve(tA, torch.ones(n, dtype=torch.float64), tol=1e-10, M=lambda r: -r)
    _, ij = jcg.minres_solve(jA, jnp.ones(n), tol=1e-10, M=lambda r: -r, fused="never")
    assert not bool(info.converged) and not bool(ij.converged)
    assert int(info.iterations) == int(ij.iterations) == 0
    assert np.isnan(float(info.rnorm))


def test_maxiter_defaults_to_n_and_caps():
    _, tA, n = _poisson(4)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(n))
    _, info = minres_solve(tA, b, tol=-1.0)  # nothing but the cap stops it
    assert info.rnorm_history.numel() == n + 1 and int(info.iterations) <= n
    _, capped = minres_solve(tA, b, tol=0.0, maxiter=5)
    assert int(capped.iterations) == 5 and not bool(capped.converged)
    assert torch.equal(capped.rnorm_history[:6], info.rnorm_history[:6])


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_f32_trajectory_matches_jax(precond):
    rows, cols, vals, shape = banded_spd_coo(600, bandwidth=5, seed=9)
    jA = JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32)
    tA = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device="cpu")
    b = (np.arange(1, shape[0] + 1) / shape[0]).astype(np.float32)
    jM = jcg.jacobi_preconditioner(jA) if precond == "jacobi" else None
    tM = jacobi_preconditioner(tA) if precond == "jacobi" else None
    _, ij = jcg.minres_solve(jA, jnp.asarray(b), tol=0.0, maxiter=24, M=jM, fused="never")
    xt, it = minres_solve(tA, torch.from_numpy(b), tol=0.0, maxiter=24, M=tM)
    assert int(it.iterations) == 24 and xt.dtype == torch.float32
    assert it.rnorm_history.dtype == torch.float32
    np.testing.assert_allclose(it.rnorm_history.numpy(), np.asarray(ij.rnorm_history), rtol=1e-4)


def test_fused_argument_is_validated():
    _, tA, n = _poisson(4)
    b = torch.ones(n, dtype=torch.float64)
    with pytest.raises(ValueError, match="fused must be one of"):
        minres_solve(tA, b, fused="sometimes")
    with pytest.raises(ValueError, match="fused='always'"):
        minres_solve(tA, b, fused="always")  # CSR, float64, CPU: no fused path
    with pytest.raises(ValueError, match="fused='always'"):
        minres_solve(tA, b, fused="always", M=lambda r: 0.5 * r)
    x_auto, _ = minres_solve(tA, b, tol=1e-10)
    x_never, _ = minres_solve(tA, b, tol=1e-10, fused="never")
    assert torch.equal(x_auto, x_never)


def test_dead_steps_change_nothing(monkeypatch):
    """A step on a state that is done is masked field by field: a solve
    driven past its end (no early exit, 32 launches) equals one that reads
    the flag every step."""
    _, tA, n = _poisson(6)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    x1, i1 = minres_solve(tA, b, tol=1e-6)
    calls = []
    real_step = minres.minres_step
    monkeypatch.setattr(minres, "minres_step",
                        lambda *a, **k: calls.append(1) or real_step(*a, **k))
    monkeypatch.setattr(restart, "_DonePoll", lambda flag: None)
    x2, i2 = minres_solve(tA, b, tol=1e-6)
    k = int(i1.iterations)
    assert k < restart.CHECK_EVERY == len(calls)
    assert int(i2.iterations) == k and torch.equal(x1, x2)
    assert torch.equal(i1.rnorm_history.view(torch.int64), i2.rnorm_history.view(torch.int64))
