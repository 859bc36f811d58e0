"""``sstep_cg_solve`` and ``make_sstep_loop`` (solver/sstep.py) against the
JAX package's on the same numpy inputs (CPU), the single-device cases of
tests/test_sstep.py.

Tolerances (float64):
* iteration counts equal to the JAX loop's;
* rho_history at the block boundaries to 1e-10 relative on the entries
  above 1e-16 of ‖r₀‖² at s <= 2 and above 1e-12 at s = 4 (the monomial
  basis conditions like κˢ, so the two packages' last-bit differences
  grow with s), NaN between the boundaries where the JAX one is NaN;
* x to 1e-9 of max|x|.
float32: the boundary entries of the first 24 iterations to 5e-2 (the
storage-parity bar of tests/test_torch_solver.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conjugategradient_tpu.solver.sstep import sstep_cg_solve as jsstep
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import cg_solve, make_sstep_loop, sstep_cg_solve
from conjugategradient_tpu_torch.solver.blockcg import default_gram_rcond
from conjugategradient_tpu_torch.types import CSRMatrix, DIAMatrix

RTOL = 1e-10


def _pair(coo, dtype=np.float64):
    rows, cols, vals, shape = coo
    return (JCSR.from_coo(rows, cols, vals, shape, dtype=dtype),
            CSRMatrix.from_coo(rows, cols, vals, shape, dtype=dtype, device="cpu"))


def _poisson(nx, dtype=np.float64):
    ja, ta = _pair(poisson2d_coo(nx), dtype)
    return ja, ta, reference_rhs(ja.shape[0], dtype=dtype)


def _assert_same(it, ij, floor, xt=None, xj=None):
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged) == bool(ij.converged)
    hj = np.asarray(ij.rho_history, np.float64)
    ht = it.rho_history.double().numpy()
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    sel = ~np.isnan(hj) & (hj > floor * hj[0])
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=RTOL)
    if xt is not None:
        xj = np.asarray(xj)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-9 * np.abs(xj).max())


def test_s1_matches_plain_cg_and_jax():
    """s = 1 is plain CG re-derived through the Gram: the port's cg_solve's
    iteration count and history, and the JAX s = 1 loop's."""
    ja, ta, b = _poisson(14)
    xj, ij = jsstep(ja, jnp.asarray(b), s=1, tol=1e-10)
    xt, it = sstep_cg_solve(ta, torch.from_numpy(b), s=1, tol=1e-10)
    _assert_same(it, ij, 1e-16, xt, xj)
    _, ic = cg_solve(ta, torch.from_numpy(b), tol=1e-10)
    k = int(ic.iterations)
    assert int(it.iterations) == k and bool(it.converged)
    h, hc = it.rho_history[:k].numpy(), ic.rho_history[:k].numpy()
    sel = hc > hc[0] * 1e-16
    np.testing.assert_allclose(h[sel], hc[sel], rtol=1e-8)


@pytest.mark.parametrize("s,nx,tol,floor", [(2, 14, 1e-8, 1e-16), (2, 20, 1e-6, 1e-16),
                                            (4, 14, 1e-6, 1e-12), (4, 20, 1e-6, 1e-12),
                                            (3, 16, 1e-6, 1e-12)])
def test_block_boundaries_match_jax(s, nx, tol, floor):
    ja, ta, b = _poisson(nx)
    xj, ij = jsstep(ja, jnp.asarray(b), s=s, tol=tol)
    xt, it = sstep_cg_solve(ta, torch.from_numpy(b), s=s, tol=tol)
    _assert_same(it, ij, floor, xt, xj)
    assert int(it.iterations) % s == 0 and bool(it.converged)
    assert np.isnan(float(it.rho_history[1]))
    # plain CG's history at the boundaries (exact-arithmetic equivalence)
    _, ic = cg_solve(ta, torch.from_numpy(b), tol=tol)
    hc = ic.rho_history.numpy()
    for k in range(0, min(int(it.iterations), int(ic.iterations)), s):
        if hc[k] <= hc[0] * 1e-18:
            break
        np.testing.assert_allclose(float(it.rho_history[k]), hc[k], rtol=1e-4)


def test_true_residual():
    ja, ta, b = _poisson(20)
    x, info = sstep_cg_solve(ta, torch.from_numpy(b), s=4, tol=1e-9)
    assert bool(info.converged)
    r = b - ta.matvec(x).numpy()
    assert np.linalg.norm(r) < 1e-7 * np.linalg.norm(b)


def test_exact_convergence_mid_block():
    """Krylov grade < s (2I converges in one iteration, s = 4): the
    rank-deficient Gram takes the exact least-squares step."""
    n = 32
    ja, ta = _pair((np.arange(n), np.arange(n), 2.0 * np.ones(n), (n, n)))
    b = reference_rhs(n)
    xj, ij = jsstep(ja, jnp.asarray(b), s=4, tol=1e-12)
    xt, it = sstep_cg_solve(ta, torch.from_numpy(b), s=4, tol=1e-12)
    assert bool(it.converged) and int(it.iterations) == int(ij.iterations)
    np.testing.assert_allclose(xt.numpy(), b / 2.0, rtol=1e-12)


def test_zero_rhs():
    """rho_0 = 0: the detecting block is a no-op (zero Gram, zero step)
    and counts one block."""
    n = 24
    _, ta = _pair((np.arange(n), np.arange(n), np.ones(n), (n, n)))
    x, info = sstep_cg_solve(ta, torch.zeros(n, dtype=torch.float64), s=4, tol=1e-30)
    assert bool(info.converged) and int(info.iterations) == 4
    assert bool(torch.all(x == 0))


def test_nan_exit():
    """A NaN in b: the first block sees rho = NaN, updates, counts and
    exits unconverged, as the JAX loop does (the block solves of a NaN Gram
    give NaN, not an error)."""
    ja, ta, b = _poisson(6)
    b = b.copy()
    b[3] = np.nan
    xj, ij = jsstep(ja, jnp.asarray(b), s=2, tol=1e-8)
    xt, it = sstep_cg_solve(ta, torch.from_numpy(b), s=2, tol=1e-8)
    assert int(it.iterations) == int(ij.iterations) == 2
    assert not bool(it.converged) and not bool(ij.converged)
    assert bool(torch.isnan(it.rnorm_sq)) and np.isnan(float(ij.rnorm_sq))


def test_validates_s():
    _, ta, b = _poisson(6)
    with pytest.raises(ValueError, match="s must be"):
        sstep_cg_solve(ta, torch.from_numpy(b), s=0)


@pytest.mark.parametrize("maxiter", [0, 1, 10, 12])
def test_maxiter_overshoot_bound(maxiter):
    """The cap may overshoot maxiter by at most s - 1, as the JAX loop's;
    the final residual lands in the clamped slot."""
    ja, ta, b = _poisson(14)
    xj, ij = jsstep(ja, jnp.asarray(b), s=4, tol=0.0, maxiter=maxiter)
    xt, it = sstep_cg_solve(ta, torch.from_numpy(b), s=4, tol=0.0, maxiter=maxiter)
    k = int(it.iterations)
    assert k == int(ij.iterations) and maxiter <= k <= maxiter + 3
    _assert_same(it, ij, 1e-12, xt, xj)
    assert it.rho_history.shape == (maxiter + 1,)


def test_loop_hooks():
    """make_sstep_loop's hooks: ``reduce_gram`` sees one (3s+1)² Gram a
    block plus one 1x1 after the loop, and a ``basis_fn`` that builds the
    same scaled monomial basis gives the same bits."""
    _, ta, b = _poisson(12)
    bt = torch.from_numpy(b)
    s = 3
    seen = []

    def reduce_gram(G):
        seen.append(tuple(G.shape))
        return G

    def basis_fn(r, inv_nu):
        rows = [r]
        for _ in range(s):
            rows.append(ta.matvec(rows[-1]) * inv_nu)
        return torch.stack(rows, dim=0)

    kw = dict(s=s, tol_arr=torch.tensor(1e-8, dtype=torch.float64), maxiter=200,
              rcond=default_gram_rcond(torch.float64))
    x0 = torch.zeros_like(bt)
    out1 = make_sstep_loop(ta.matvec, reduce_gram, bt, x0, **kw)
    out2 = make_sstep_loop(ta.matvec, lambda G: G, bt, x0, basis_fn=basis_fn, **kw)
    k = int(out1[1])
    assert bool(out1[2]) and k % s == 0
    assert seen == [(3 * s + 1, 3 * s + 1)] * (k // s) + [(1, 1)]
    for a, c in zip(out1, out2):
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True)


def test_layouts_and_warm_start():
    coo = banded_spd_coo(240, bandwidth=6, seed=12)
    ja, ta = _pair(coo)
    b = reference_rhs(240)
    x0 = np.random.default_rng(2).standard_normal(240)
    xj, ij = jsstep(ja, jnp.asarray(b), jnp.asarray(x0), s=2, tol=1e-7)
    xt, it = sstep_cg_solve(ta, torch.from_numpy(b), torch.from_numpy(x0), s=2, tol=1e-7)
    _assert_same(it, ij, 1e-16, xt, xj)
    rows, cols, vals, shape = coo
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=240))])
    dia = DIAMatrix.from_csr_host(np.asarray(vals)[order], np.asarray(cols)[order], indptr,
                                  shape, device="cpu")
    xd, idd = sstep_cg_solve(dia, torch.from_numpy(b), torch.from_numpy(x0), s=2, tol=1e-7)
    assert int(idd.iterations) == int(it.iterations)
    np.testing.assert_allclose(xd.numpy(), xt.numpy(), rtol=0,
                               atol=1e-9 * float(xt.abs().max()))


def test_float32_trajectory():
    ja, ta, b = _poisson(24, np.float32)
    _, ij = jsstep(ja, jnp.asarray(b), s=2, tol=0.0, maxiter=24)
    _, it = sstep_cg_solve(ta, torch.from_numpy(b), s=2, tol=0.0, maxiter=24)
    hj = np.asarray(ij.rho_history, np.float64)
    ht = it.rho_history.double().numpy()
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    ok = ~np.isnan(hj)
    np.testing.assert_allclose(ht[ok], hj[ok], rtol=5e-2)
