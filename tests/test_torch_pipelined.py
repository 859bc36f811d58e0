"""``pipelined_cg_solve`` (solver/pipelined.py) against the JAX package's on
the same numpy inputs (CPU), the cases of tests/test_solver_api.py:214-330
and tests/test_property.py:115-135.

Tolerances:
* float64 Chronopoulos–Gear (no M): equal iteration counts, rho_history to
  1e-10 relative on the entries above 1e-16 of ‖r₀‖² (off the roundoff
  floor, where the two packages' sums part).
* float64 Ghysels–Vanroose (M): equal iteration counts, rho_history to
  1e-10 relative above 1e-8 of ‖r₀‖².  Its extra recurrences amplify the
  last-bit differences between XLA's fused multiply-adds and torch's two
  roundings (O(eps·κ) drift, solver/pipelined.py), so the bar sits higher
  above the floor.
* A history with residual replacement: to 1e-10 relative above 1e-8 of
  ‖r₀‖² in both forms: the true residual b − A·x written at a restart
  carries a cancellation error of eps·‖b‖, so its relative error grows as
  ‖r‖ falls.
* ``CGInfo.rho`` and ``rnorm_sq``: 1e-6 relative or 1e-14 of ‖r₀‖² (a
  converged solve's value sits at the roundoff floor).
* x to 1e-9 of max|x| (float64).
* float32: the first 25 history entries to 5e-2 (the storage-parity bar
  of tests/test_torch_solver.py) and iteration counts within 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver.pipelined import pipelined_cg_solve as jpipe
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch.problems import (banded_spd_coo, poisson2d_coo,
                                                  random_spd_dense, reference_rhs)
from conjugategradient_tpu_torch.solver import (cg_solve, jacobi_preconditioner,
                                                pipelined_cg_solve)
from conjugategradient_tpu_torch.types import CSRMatrix, DenseOperator, DIAMatrix

CG_FLOOR = 1e-16
GV_FLOOR = 1e-8
RTOL = 1e-10


def _pair(coo, dtype=np.float64, scale=None):
    rows, cols, vals, shape = coo
    vals = np.asarray(vals, np.float64)
    if scale is not None:
        vals = vals * scale[rows] * scale[cols]
    return (JCSR.from_coo(rows, cols, vals, shape, dtype=dtype),
            CSRMatrix.from_coo(rows, cols, vals, shape, dtype=dtype, device="cpu"))


def _scaled_poisson(nx=16):
    coo = poisson2d_coo(nx)
    # rows and columns scaled so that Jacobi changes the trajectory
    return _pair(coo, scale=np.exp(np.linspace(0.0, 2.0, coo[3][0])))


def _assert_same(it, ij, floor, xt=None, xj=None):
    k = int(ij.iterations)
    assert int(it.iterations) == k
    assert bool(it.converged) == bool(ij.converged)
    hj = np.asarray(ij.rho_history, np.float64)
    ht = it.rho_history.double().numpy()
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    sel = ~np.isnan(hj) & (hj > floor * hj[0])
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=RTOL)
    if xt is not None:
        xj = np.asarray(xj)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-9 * np.abs(xj).max())


def _assert_scalar(t, j, ij):
    t, j = float(t), float(j)
    assert abs(t - j) <= 1e-6 * abs(j) + 1e-14 * float(ij.rho_history[0]), (t, j)


@pytest.mark.parametrize("nx,tol", [(16, 1e-8), (20, 1e-6), (14, 1e-10)])
def test_chronopoulos_gear_matches_jax(nx, tol):
    ja, ta = _pair(poisson2d_coo(nx))
    b = reference_rhs(ja.shape[0])
    xj, ij = jpipe(ja, jnp.asarray(b), tol=tol)
    xt, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=tol)
    _assert_same(it, ij, CG_FLOOR, xt, xj)
    # and it reproduces the port's standard CG: iterations, solution
    xc, ic = cg_solve(ta, torch.from_numpy(b), tol=tol)
    assert int(ic.iterations) == int(it.iterations)
    np.testing.assert_allclose(xt.numpy(), xc.numpy(), rtol=1e-8, atol=1e-10)


def test_ghysels_vanroose_matches_jax_and_pcg():
    ja, ta = _scaled_poisson()
    b = reference_rhs(ja.shape[0])
    xj, ij = jpipe(ja, jnp.asarray(b), tol=1e-8, M=jcg.jacobi_preconditioner(ja))
    xt, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=1e-8,
                                M=jacobi_preconditioner(ta))
    _assert_same(it, ij, GV_FLOOR, xt, xj)
    assert bool(it.converged) and float(it.rnorm_sq) <= 1e-16
    # CGInfo.rho carries gamma = r.u, the PCG convention
    _assert_scalar(it.rho, ij.rho, ij)
    _, ic = cg_solve(ta, torch.from_numpy(b), tol=1e-8, M=jacobi_preconditioner(ta))
    assert int(ic.iterations) == int(it.iterations)


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "gv"])
@pytest.mark.parametrize("every", [7, 16])
def test_residual_replacement_matches_jax(precond, every):
    """recompute_r_every: the full restart at each boundary, the true ‖r‖²
    written into the history there, rho replaced too."""
    ja, ta = _pair(poisson2d_coo(14))
    b = reference_rhs(ja.shape[0])
    jM = jcg.jacobi_preconditioner(ja) if precond else None
    tM = jacobi_preconditioner(ta) if precond else None
    xj, ij = jpipe(ja, jnp.asarray(b), tol=1e-6, M=jM, recompute_r_every=every)
    xt, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=1e-6, M=tM,
                                recompute_r_every=every)
    _assert_same(it, ij, GV_FLOOR, xt, xj)
    _assert_scalar(it.rho, ij.rho, ij)


@pytest.mark.parametrize("maxiter", [0, 1, 7, 16])
@pytest.mark.parametrize("precond", [False, True], ids=["cg", "gv"])
def test_caps_and_restart_on_the_cap(maxiter, precond):
    """A capped solve (a restart boundary exactly at the cap included)
    reports what the JAX loop reports."""
    ja, ta = _pair(poisson2d_coo(10))
    b = reference_rhs(ja.shape[0])
    jM = jcg.jacobi_preconditioner(ja) if precond else None
    tM = jacobi_preconditioner(ta) if precond else None
    xj, ij = jpipe(ja, jnp.asarray(b), tol=0.0, maxiter=maxiter, M=jM, recompute_r_every=8)
    xt, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=0.0, maxiter=maxiter, M=tM,
                                recompute_r_every=8)
    assert int(it.iterations) == int(ij.iterations) == maxiter
    _assert_same(it, ij, GV_FLOOR, xt, xj)
    _assert_scalar(it.rnorm_sq, ij.rnorm_sq, ij)
    _assert_scalar(it.rho, ij.rho, ij)


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "gv"])
def test_zero_rhs_and_breakdown(precond):
    """b = 0 freezes the solve (gamma == 0, x stays 0, converged); a
    singular operator gives a zero denominator, alpha NaN and the NaN exit
    well before the cap, as in the JAX package."""
    M = (lambda z: 0.5 * z) if precond else None
    eye = np.eye(8)
    for a in (eye,):
        xj, ij = jpipe(jnp.asarray(a), jnp.zeros((8,)), tol=1e-30, M=M)
        xt, it = pipelined_cg_solve(DenseOperator(torch.from_numpy(a)),
                                    torch.zeros(8, dtype=torch.float64), tol=1e-30, M=M)
        assert bool(torch.all(xt == 0)) and np.all(np.asarray(xj) == 0)
        assert bool(it.converged) == bool(ij.converged) is True
        assert int(it.iterations) == int(ij.iterations)
    sing = np.zeros((8, 8))
    Ms = (lambda z: z) if precond else None
    xj, ij = jpipe(jnp.asarray(sing), jnp.ones((8,)), tol=1e-10, maxiter=20, M=Ms)
    xt, it = pipelined_cg_solve(DenseOperator(torch.from_numpy(sing)),
                                torch.ones(8, dtype=torch.float64), tol=1e-10, maxiter=20,
                                M=Ms)
    assert not bool(it.converged) and not bool(ij.converged)
    assert int(it.iterations) == int(ij.iterations) < 20
    assert bool(torch.isnan(it.rnorm_sq)) == bool(np.isnan(float(ij.rnorm_sq)))


@pytest.mark.parametrize("seed", range(6))
def test_gv_matches_jax_on_random_spd(seed):
    """tests/test_property.py's GV property on seeded random SPD patterns:
    the same iterations and solution as the JAX GV, and the true residual
    at the tolerance."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 21))
    m = int(rng.integers(0, 3 * n))
    i, j = rng.integers(0, n, m), rng.integers(0, n, m)
    v = np.round(rng.standard_normal(m), 3)
    rows = np.concatenate([i, j, np.arange(n)])
    cols = np.concatenate([j, i, np.arange(n)])
    diag = np.ones(n)
    np.add.at(diag, rows[: 2 * m], np.abs(np.concatenate([v, v])))
    vals = np.concatenate([v, v, diag])
    ja, ta = _pair((rows, cols, vals, (n, n)))
    dense = np.asarray(ja.to_dense())
    b = np.linspace(-1, 1, n)
    xj, ij = jpipe(ja, jnp.asarray(b), tol=1e-9, maxiter=5 * n, M=jcg.jacobi_preconditioner(ja))
    xt, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=1e-9, maxiter=5 * n,
                                M=jacobi_preconditioner(ta))
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged) == bool(ij.converged)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-9)
    assert np.linalg.norm(b - dense @ xt.numpy()) <= 1e-7


def test_warm_start_and_layouts():
    """x0 is honoured; a DIA operator and a dense one give the CSR solve's
    iterations and history to roundoff."""
    coo = banded_spd_coo(200, bandwidth=5, seed=3)
    ja, ta = _pair(coo)
    b = reference_rhs(200)
    x0 = np.random.default_rng(1).standard_normal(200)
    xj, ij = jpipe(ja, jnp.asarray(b), jnp.asarray(x0), tol=1e-7)
    xt, it = pipelined_cg_solve(ta, torch.from_numpy(b), torch.from_numpy(x0), tol=1e-7)
    _assert_same(it, ij, CG_FLOOR, xt, xj)
    rows, cols, vals, shape = coo
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=200))])
    dia = DIAMatrix.from_csr_host(np.asarray(vals)[order], np.asarray(cols)[order], indptr,
                                  shape, device="cpu")
    dense = DenseOperator(torch.from_numpy(np.array(ja.to_dense())))
    for op in (dia, dense):
        xo, io = pipelined_cg_solve(op, torch.from_numpy(b), torch.from_numpy(x0), tol=1e-7)
        assert int(io.iterations) == int(it.iterations)
        np.testing.assert_allclose(io.rho_history[: int(it.iterations)].numpy(),
                                   it.rho_history[: int(it.iterations)].numpy(), rtol=1e-9)


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "gv"])
def test_float32_trajectory(precond):
    ja, ta = _pair(poisson2d_coo(24), dtype=np.float32)
    b = reference_rhs(ja.shape[0], dtype=np.float32)
    jM = jcg.jacobi_preconditioner(ja) if precond else None
    tM = jacobi_preconditioner(ta) if precond else None
    _, ij = jpipe(ja, jnp.asarray(b), tol=0.0, maxiter=25, M=jM)
    _, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=0.0, maxiter=25, M=tM)
    np.testing.assert_allclose(it.rho_history.double().numpy(),
                               np.asarray(ij.rho_history, np.float64), rtol=5e-2)
    # 1e-4 of ||b||: above the level where the float32 GV recurrences stall
    # without residual replacement
    tol = 1e-4 * float(np.linalg.norm(b))
    _, ij = jpipe(ja, jnp.asarray(b), tol=tol, M=jM)
    _, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=tol, M=tM)
    assert bool(it.converged) and bool(ij.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 8


def test_dense_random_spd_and_validation():
    a = random_spd_dense(30, seed=4)
    b = np.arange(1.0, 31.0)
    xj, ij = jpipe(jnp.asarray(a), jnp.asarray(b), tol=1e-10)
    xt, it = pipelined_cg_solve(torch.from_numpy(a), torch.from_numpy(b), tol=1e-10)
    # a dense random spectrum: past ~18 steps the two packages' last-bit
    # differences grow chaotically in both loops (standard CG's parts the
    # same way), so the history is held over its first 15 entries
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged) == bool(ij.converged)
    np.testing.assert_allclose(it.rho_history[:15].numpy(), np.asarray(ij.rho_history)[:15],
                               rtol=RTOL)
    np.testing.assert_allclose(a @ xt.numpy(), b, rtol=0, atol=1e-2)
    with pytest.raises(ValueError, match="recompute_r_every"):
        pipelined_cg_solve(torch.from_numpy(a), torch.from_numpy(b), recompute_r_every=-1)
